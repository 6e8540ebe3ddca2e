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
// `rows`). A delete is one pass over the whole column: full covers flip,
// the at most two partly covered runs split into pieces. An insert finds
// its run by the live prefix sum and splices <= w + 1 rows. Splices shift
// the rows past the edit by a circular roll (as pltpu.roll does: a column
// that overflows its capacity wraps, and the capacity flag says so, but
// the op still runs). Each insert emits its origins (left, right), ROOT
// (-1) at the ends; inactive steps emit 0. err row 0: capacity; row 1: a
// delete past the end of the document.
//
// Mapping. One warp per document, four documents per thread block. The
// TPU kernel's jnp.any gates over a tile of documents only skip work whose
// effect on a document is masked off, so each document run alone gives the
// same bits (the CPU tests hold a B-lane replay against B one-lane
// replays); its SHARED_CUM hoist shares one prefix between the delete and
// the insert of a step only when no document does both, so recomputing it
// per branch changes nothing. The columns and their per-row temporaries
// (live counts, prefix sums, covered ranges, shift copies) live in device
// memory as lane-major working planes; the public [CAP, B] planes are
// transposed in and out around the replay.
//
// What bounds it. The serial chain of steps per document, each a few
// passes over the document's whole column (CAP rows, 32 per warp
// instruction). This engine is the cross-check of the blocked one
// (rle_lanes_blocked.cu), which is the one sized for speed.

#include <cuda_runtime.h>

#include "lanes_mixed.cuh"

namespace {

using namespace lanes;

constexpr int kWarpsPerBlock = 4;

struct Col {
  int *O, *L, *XO, *XL, *LV, *CUM, *CS, *CE;  // [CAP] each, lane-major
  int CAP, WMAX;
  int rows;
  int e0, e1;
};

// _live_prefix: LV = live chars per row, CUM = their inclusive prefix.
__device__ void live_prefix(Col& c) {
  __syncwarp();
  for (int i = lane_id(); i < c.CAP; i += 32)
    c.LV[i] = c.O[i] > 0 ? c.L[i] : 0;
  __syncwarp();
  wprefix(c.LV, c.CUM, c.CAP);
}

// apply_partial: split row i around its covered range (CS, CE).
__device__ int apply_partial(Col& c, int i) {
  const Pieces p = split_pieces(row_or0(c.O, i, c.CAP),
                                row_or0(c.L, i, c.CAP),
                                row_or0(c.CS, i, c.CAP),
                                row_or0(c.CE, i, c.CAP));
  apply_pieces(c.O, c.L, c.XO, c.XL, c.CAP, i, p);
  return p.amt;
}

// do_delete: tombstone d live chars after live rank p in one pass.
__device__ void do_delete(Col& c, int p, int d) {
  const int CAP = c.CAP, lane = lane_id();
  if (c.rows + 2 > CAP) c.e0 = 1;
  live_prefix(c);
  __syncwarp();
  int tot = 0, np = 0, i1 = CAP, i2 = -1;
  for (int i = lane; i < CAP; i += 32) {
    const int lv = c.LV[i], before = c.CUM[i] - lv, bo = c.O[i];
    const int cs = imin(imax(p - before, 0), lv);
    const int ce = imin(imax(p + d - before, 0), lv);
    const int cov = ce - cs;
    c.CS[i] = cs;
    c.CE[i] = ce;
    tot += cov;
    const bool full = cov > 0 && cov == c.L[i];
    if (cov > 0 && !full) {
      ++np;
      i1 = imin(i1, i);
      i2 = imax(i2, i);
    }
    if (full) c.O[i] = -bo;
  }
  tot = wsum(tot);
  np = wsum(np);
  i1 = wmin(i1);
  i2 = wmax(i2);
  __syncwarp();
  if (tot < d) c.e1 = 1;
  int a2 = 0, a1 = 0;
  if (np >= 1) a2 = apply_partial(c, i2);
  if (np == 2) a1 = apply_partial(c, i1);
  c.rows += a1 + a2;
}

// do_insert: the fused W-row splice at live rank p; returns the op's
// origins.
__device__ void do_insert(Col& c, int p, int il, int st, int w, int& ol_out,
                          int& or_out) {
  const int CAP = c.CAP, lane = lane_id();
  const int rows = c.rows;
  if (rows + w + 1 > CAP) c.e0 = 1;
  live_prefix(c);
  int n = 0;
  for (int i = lane; i < CAP; i += 32) n += (c.CUM[i] < p && i < rows);
  const int i_r = wsum(n);
  const int o_r = row_or0(c.O, i_r, CAP), l_r = row_or0(c.L, i_r, CAP);
  const int off = p - (row_or0(c.CUM, i_r, CAP) - row_or0(c.LV, i_r, CAP));
  const int left = p == 0 ? kRoot : (o_r - 1) + (off - 1);
  const int lrun = floordiv(il, imax(w, 1));
  const bool mrg = w == 1 && p > 0 && off == l_r && st + 1 == o_r + l_r;
  const bool is_split = p > 0 && off < l_r;
  const int ins_at = p == 0 ? 0 : i_r + 1;
  const int amt = mrg ? 0 : w + (int)is_split;
  const int nxt = row_or0(c.O, i_r + 1, CAP), first_o = c.O[0];
  const int ra = roll_amount(amt, c.WMAX + 1, CAP);
  __syncwarp();
  for (int i = lane; i < CAP; i += 32) {
    c.XO[i] = c.O[i];
    c.XL[i] = c.L[i];
  }
  __syncwarp();
  for (int j = lane; j < CAP; j += 32) {
    int no = c.XO[j], nl = c.XL[j];
    if (j >= ins_at) {
      const int s = roll_src(j, ra, CAP);
      no = c.XO[s];
      nl = c.XL[s];
    }
    if (is_split && j == i_r) nl = off;
    if (!mrg && j >= ins_at && j < ins_at + w) {
      no = st + il - (j - ins_at + 1) * lrun + 1;
      nl = lrun;
    }
    if (is_split && j == ins_at + w) {
      no = o_r + off;
      nl = l_r - off;
    }
    if (mrg && j == i_r) nl = l_r + il;
    c.O[j] = no;
    c.L[j] = nl;
  }
  __syncwarp();
  const int succ_p0 = rows > 0 ? first_o : 0;
  const int succ_after = i_r + 1 < rows ? nxt : 0;
  const int succ = p == 0 ? succ_p0 : (is_split ? o_r + off : succ_after);
  ol_out = left;
  or_out = succ == 0 ? kRoot : iabs(succ) - 1;
  c.rows = rows + amt;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock) lanes_kernel(
    const int* __restrict__ pos, const int* __restrict__ dlen,
    const int* __restrict__ ilen, const int* __restrict__ start,
    const int* __restrict__ wcol, const int* __restrict__ rows0,
    int* __restrict__ ol, int* __restrict__ orr, int* __restrict__ rows_out,
    int* __restrict__ err, int* __restrict__ scratch, int S, int B, int CAP,
    int WMAX) {
  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warps only: no collective is split
  const long long plane = (long long)B * CAP;
  int* base = scratch + (long long)b * CAP;
  Col c;
  c.O = base;
  c.L = base + plane;
  c.XO = base + 2 * plane;
  c.XL = base + 3 * plane;
  c.LV = base + 4 * plane;
  c.CUM = base + 5 * plane;
  c.CS = base + 6 * plane;
  c.CE = base + 7 * plane;
  c.CAP = CAP;
  c.WMAX = WMAX;
  c.rows = rows0[b];
  c.e0 = c.e1 = 0;

  for (int k = 0; k < S; ++k) {
    const long long g = (long long)k * B + b;
    const int p = pos[g], dl = dlen[g], il = ilen[g], st = start[g];
    const int w = imax(wcol[g], 1);  // pad rows carry 0
    int ol_v = 0, or_v = 0;
    if (dl > 0) do_delete(c, p, dl);
    if (il > 0) do_insert(c, p, il, st, w, ol_v, or_v);
    if (lane == 0) {
      ol[g] = ol_v;
      orr[g] = or_v;
    }
  }
  if (lane == 0) {
    rows_out[b] = c.rows;
    const int e[8] = {c.e0, c.e1, 0, 0, 0, 0, 0, 0};
    for (int r = 0; r < 8; ++r) err[(long long)r * B + b] = e[r];
  }
}

}  // namespace

extern "C" int rle_lanes_launch(const int* pos, const int* dlen,
                                const int* ilen, const int* start,
                                const int* wcol, const int* ord0,
                                const int* len0, const int* rows0, int* ol,
                                int* orr, int* ordp, int* lenp, int* rows,
                                int* err, int* scratch, int S, int B,
                                int CAP, int WMAX, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long plane = (long long)B * CAP;
  lanes::launch_transpose(ord0, scratch, CAP, B, st);
  lanes::launch_transpose(len0, scratch + plane, CAP, B, st);
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lanes_kernel<<<blocks, 32 * kWarpsPerBlock, 0, st>>>(
      pos, dlen, ilen, start, wcol, rows0, ol, orr, rows, err, scratch, S, B,
      CAP, WMAX);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lanes::launch_transpose(scratch, ordp, B, CAP, st);
  lanes::launch_transpose(scratch + plane, lenp, B, CAP, st);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
