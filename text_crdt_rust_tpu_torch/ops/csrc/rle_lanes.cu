// Un-blocked per-lane local replay (divergent documents, local edits), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// text_crdt_rust_tpu/ops/rle_lanes.py::_rle_lanes_kernel and computes what
// it computes, bit for bit, on all six outputs. The plain PyTorch version
// of the same function is
// text_crdt_rust_tpu_torch/ops/rle_lanes.py::lanes_replay_plain; the two
// are held against each other on the card. Each function below carries the
// name of its counterpart in both.
//
// What it computes. B different documents each replay their own local edit
// stream, one op per document per step: a delete of d live chars after live
// rank p, then an insert of il chars at p (a fused step lands w runs of
// il / w chars in one splice). A document is one column of RLE runs, ordp =
// ±(start_order+1) and lenp = length, packed at the front (rows in use:
// `rows`). A delete flips its full covers and splits the at most two
// partly covered runs into pieces; an insert finds its run by the live
// prefix sum and splices <= w + 1 rows. Splices shift the rows past the
// edit as a circular roll does (pltpu.roll: a column that overflows its
// capacity wraps, and the capacity flag says so, but the op still runs).
// Each insert emits its origins (left, right), ROOT (-1) at the ends;
// inactive steps emit 0. err row 0: capacity; row 1: a delete past the end
// of the document.
//
// Mapping. One warp per document, `warps` documents per thread block. The
// TPU kernel's jnp.any gates over a tile of documents only skip work whose
// effect on a document is masked off, so each document run alone gives the
// same bits (the CPU tests hold a B-lane replay against B one-lane
// replays); its SHARED_CUM hoist shares one prefix between the delete and
// the insert of a step only when no document does both, so recomputing it
// per branch changes nothing. The public [CAP, B] planes are transposed
// into lane-major planes around the replay; each warp keeps the first sh
// rows of its document's column in shared memory for the whole launch
// (lanes_column.cuh: no per-row temporaries, passes over the column's
// extent, splices in place) and writes them back at the end; a column
// whose extent passes sh works in the lane-major planes, with the same
// passes.
//
// What bounds it. The serial chain of steps per document: each step is a
// few passes over the document's extent in shared memory (a chunk sum, a
// warp scan, a walk of the owning chunk, a shift of the rows past the
// edit), so the warps' latency, not device memory, sets the time.

#include <cuda_runtime.h>

#include "lanes_column.cuh"

namespace {

using namespace lanecol;

constexpr int kMaxWarps = 8;
// extent at the start and at the end, 1 if the column ended in shared
// memory
constexpr int kStats = 3;

// The op columns of one document and its origins.
struct Stream {
  const int *pos, *dlen, *ilen, *start, *wcol;
  int *ol, *orr;
  int S, B, b;
};

// Steps [k, S) of one document. With SMEM the column is the warp's rows
// of shared memory (so that its reads and writes are shared-memory ones),
// and the replay stops before a step whose writes could pass them,
// returning that step; else the column is in device memory. Returns S
// when every step is done.
template <bool SMEM>
__device__ int replay(Col& c, const Stream& s, int k) {
  extern __shared__ int smem[];
  if (SMEM) {
    c.O = smem + 2 * (threadIdx.x >> 5) * c.lim;
    c.L = c.O + c.lim;
  }
  const int lane = lane_id();
  int stop = s.S;
  for (int k0 = k & ~31; k0 < stop; k0 += 32) {
    const int kk = k0 + lane;
    int rp = 0, rd = 0, ri = 0, rs = 0, rw = 0;
    if (kk < s.S) {
      const long long g = (long long)kk * s.B + s.b;
      rp = s.pos[g];
      rd = s.dlen[g];
      ri = s.ilen[g];
      rs = s.start[g];
      rw = s.wcol[g];
    }
    int my_ol = 0, my_or = 0;
    const int nk = imin(32, s.S - k0);
    for (int u = imax(k - k0, 0); u < nk; ++u) {
      const int dl = bcast(rd, u), il = bcast(ri, u);
      if (dl <= 0 && il <= 0) continue;  // a pad row or an idle document
      const int w = imax(bcast(rw, u), 1);  // pad rows carry 0
      if (SMEM && step_room(c, w) > c.lim) {
        stop = k0 + u;
        break;
      }
      const int p = bcast(rp, u);
      if (dl > 0) local_delete(c, p, dl);
      if (il > 0) {
        const LocalIns r = local_insert(c, p, il, bcast(rs, u), w);
        if (lane == u) {
          my_ol = r.left;
          my_or = r.right;
        }
      }
    }
    if (kk >= k && kk < stop) {
      s.ol[(long long)kk * s.B + s.b] = my_ol;
      s.orr[(long long)kk * s.B + s.b] = my_or;
    }
  }
  return stop;
}

__global__ void __launch_bounds__(32 * kMaxWarps, 2) lanes_kernel(
    const int* __restrict__ pos, const int* __restrict__ dlen,
    const int* __restrict__ ilen, const int* __restrict__ start,
    const int* __restrict__ wcol, const int* __restrict__ rows0,
    int* __restrict__ ol, int* __restrict__ orr, int* __restrict__ rows_out,
    int* __restrict__ err, int* __restrict__ planes,
    long long* __restrict__ stats, int S, int B, int CAP, int WMAX,
    int sh) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // whole warps only: no collective is split
  int* gO = planes + (long long)b * CAP;
  Col c;
  c.CAP = CAP;
  c.WMAX = WMAX;
  c.rows = rows0[b];
  c.e0 = c.e1 = c.e2 = 0;
  const bool on_chip =
      open_column(c, gO, gO + (long long)B * CAP, smem + 2 * warp * sh, sh);
  const int hi0 = c.hi;
  const Stream s{pos, dlen, ilen, start, wcol, ol, orr, S, B, b};
  int k = 0;
  if (on_chip) {
    k = replay<true>(c, s, 0);
    if (k < S) move_to_device(c);
  }
  if (k < S) replay<false>(c, s, k);
  close_column(c);
  if (lane == 0) {
    rows_out[b] = c.rows;
    const int e[8] = {c.e0, c.e1, 0, 0, 0, 0, 0, 0};
    for (int r = 0; r < 8; ++r) err[(long long)r * B + b] = e[r];
    if (stats) {
      stats[(long long)b * kStats + 0] = hi0;
      stats[(long long)b * kStats + 1] = c.hi;
      stats[(long long)b * kStats + 2] = c.O != c.gO;
    }
  }
}

}  // namespace

// `sh` is the rows of each column kept in shared memory (0: the columns
// stay in the lane-major planes); a thread block takes 8 * sh bytes a warp.
// `stats` may be null.
extern "C" int rle_lanes_launch(const int* pos, const int* dlen,
                                const int* ilen, const int* start,
                                const int* wcol, const int* ord0,
                                const int* len0, const int* rows0, int* ol,
                                int* orr, int* ordp, int* lenp, int* rows,
                                int* err, int* planes, long long* stats,
                                int S, int B, int CAP, int WMAX, int warps,
                                int sh, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (warps < 1 || warps > kMaxWarps || sh < 0 || sh > CAP)
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)B * CAP;
  const int smem = 8 * sh * warps;
  lanes::launch_transpose(ord0, planes, CAP, B, st);
  lanes::launch_transpose(len0, planes + plane, CAP, B, st);
  cudaError_t e = cudaFuncSetAttribute(
      lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  lanes_kernel<<<(B + warps - 1) / warps, 32 * warps, smem, st>>>(
      pos, dlen, ilen, start, wcol, rows0, ol, orr, rows, err, planes, stats,
      S, B, CAP, WMAX, sh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lanes::launch_transpose(planes, ordp, B, CAP, st);
  lanes::launch_transpose(planes + plane, lenp, B, CAP, st);
  return (int)cudaGetLastError();
}

// Thread blocks of `warps` warps with `sh` rows a column in shared memory
// that one SM holds at once (0 on error).
extern "C" int rle_lanes_blocks_per_sm(int warps, int sh) {
  const int smem = 8 * sh * warps;
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, lanes_kernel,
                                                      32 * warps, smem);
  return e == cudaSuccess ? n : 0;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
