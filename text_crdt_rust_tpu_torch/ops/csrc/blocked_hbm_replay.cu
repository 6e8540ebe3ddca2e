// Per-character blocked replay with the rows in device memory and a
// two-level live index, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// text_crdt_rust_tpu/ops/blocked_hbm.py::_hbm_replay_kernel and computes
// what it computes, bit for bit. The plain PyTorch version of the same
// function is text_crdt_rust_tpu_torch/ops/blocked_hbm.py::
// blocked_hbm_replay_plain; the two are held against each other on the
// card.
//
// What it computes. For each doc group g, replay the group's local op
// stream into B identical documents of CAP character rows (the group's
// slab of the [G*CAP, B] state) with the block algebra of blocked_ops.cuh,
// position -> block descending two levels: the 64-block segment sums
// (clamped to the last segment), then one segment (clamped to the last
// block). err ([8, B], shared by the groups) row 0: the rebalance found
// fill > K - lmax; row 1: a delete ran past the end.
//
// Mapping. One thread block per (lane, group). The full automerge-paper
// trace needs 524,288 rows a document (2 MB), far past shared memory, so a
// lane's rows live in device memory, lane-major (contiguous, so a warp's
// accesses coalesce) in a working array that the kernel zeroes first and
// transposes into the [G*CAP, B] output once at the end. Warp 0 runs the
// step chain (blocked_ops.cuh): the block tables (rws, liv: 1,024 blocks),
// the segment sums and the non-empty bitmask sit in shared memory, and, as
// the TPU kernel's `ensure` keeps a two-block window in VMEM, the blocks a
// step touches sit in a cache of kSlots blocks in shared memory (block b in
// slot b mod kSlots, so a delete window's two blocks are cached together),
// written back only when a block leaves it, before a rebalance, and at the
// end. The trace's cursor is local, so most steps hit. The other warps of
// the thread block help with the rebalance, a device-memory pass over the
// rows. Each group runs at the same time as the others, so each (lane,
// group) has its own rebalance scratch (the TPU kernel shares one, its
// grid running groups one after another).
//
// What bounds it. Bytes set a floor of ~0.16 ms at the full trace (the
// state written once, 268 MB, and the origins, 266 MB, at 3.35 TB/s); the
// rebalances add their O(capacity) compact and redeal passes (~300 at the
// full trace). Beyond those, the serial chain of 259,778 dependent steps
// bounds it. The design makes each step a few warp-wide scans over shared
// memory, with no block-wide barrier and no device-memory round trip on a
// cache hit; it keeps the rebalance's passes coalesced (one warp a block,
// eight rows a lane in flight, every warp of the thread block), and runs
// all B x G chains at once.

#include <cuda_runtime.h>

#include "blocked_ops.cuh"

namespace {

using namespace blocked_ops;

struct Hbm : Blocked {
  __device__ void do_job(int) { rebalance_pass(); }
};

__global__ void __launch_bounds__(kMaxThreads) blocked_hbm_replay_kernel(
    const int* __restrict__ pos, const int* __restrict__ dlen,
    const int* __restrict__ ilen,
    const int* __restrict__ start,  // [G*S] op columns
    int* ol, int* orr,              // [G, S, B] u32 bits, zeroed by the caller
    int* state_out,                 // [G*CAP, B]
    int* rows_out,                  // [G, NBp, B]
    int* err,                       // [8, B], zeroed by the caller
    int* work, int* tmp,            // [G, B, CAP] working rows, scratch
    int* stats,                     // [G, B] cache misses, or null
    int S, int B, int CAP, int K, int NB, int NBp, int NSUP, int LMAX) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x, g = blockIdx.y;
  const int NSUPp = NSUP > 8 ? (NSUP + 7) / 8 * 8 : 8;
  const size_t lane_rows = ((size_t)g * B + lane) * CAP;
  Hbm X;
  X.init(threadIdx.x);
  X.B = B;
  X.lane = lane;
  X.K = K;
  X.NB = NB;
  X.NBp = NBp;
  X.NSUP = NSUP;
  X.LMAX = LMAX;
  X.CAP = CAP;
  X.two_level = true;
  X.cached = true;
  X.sig = work + lane_rows;
  X.tmp = tmp + lane_rows;
  X.err = err;
  X.tags = place_tables(X, smem, NSUPp);
  X.slots = X.tags + 2 * kSlots;
  zero(smem, table_ints(NBp, NSUPp));
  for (int i = X.t; i < 2 * kSlots; i += X.T) X.tags[i] = i < kSlots ? -1 : 0;
  zero(X.sig, CAP);
  __syncthreads();

  if (X.warp == 0) {
    const size_t base = (size_t)g * S;
    Columns<4> cols{{pos, dlen, ilen, start}};
    for (int k0 = 0; k0 < S; k0 += 32) {
      cols.load(k0, S, base);
      const int n = min(32, S - k0);
      for (int j = 0; j < n; ++j) {
        const int p = cols.get(0, j), d = cols.get(1, j), il = cols.get(2, j);
        const int st = cols.get(3, j);
        if (d > 0) X.local_delete(p, d);
        if (il > 0) {
          const size_t o = (base + k0 + j) * B + lane;
          X.local_insert(X, p, il, st, ol + o, orr + o);
        }
      }
    }
    X.flush();
    if (stats != nullptr && X.ln == 0)
      stats[(size_t)g * B + lane] = X.misses;
    X.end_jobs();
  } else {
    X.serve(X);
  }
  __syncthreads();
  for (int r = X.t; r < CAP; r += X.T)
    state_out[((size_t)g * CAP + r) * B + lane] = X.sig[r];
  for (int j = X.t; j < NBp; j += X.T)
    rows_out[((size_t)g * NBp + j) * B + lane] = X.rws[j];
}

}  // namespace

extern "C" int blocked_hbm_replay_launch(
    const int* pos, const int* dlen, const int* ilen, const int* start,
    int* ol, int* orr, int* state_out, int* rows_out, int* err, int* work,
    int* tmp, int* stats, int G, int S, int B, int CAP, int K, int NB,
    int NBp, int NSUP, int LMAX, int warps, int smem, void* stream) {
  // smem: bytes of the kernel's shared layout, and warps: the thread
  // block's warps, from the Python wrapper (ops/blocked_hbm.py::
  // kernel_smem_bytes, WARPS), which also refuses K below 8 and a cache
  // of blocks past the shared memory a thread block may use.
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blocked_hbm_replay_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  blocked_hbm_replay_kernel<<<dim3(B, G), warps * 32, smem,
                              (cudaStream_t)stream>>>(
      pos, dlen, ilen, start, ol, orr, state_out, rows_out, err, work, tmp,
      stats, S, B, CAP, K, NB, NBp, NSUP, LMAX);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
