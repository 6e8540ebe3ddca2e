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
// Mapping. One thread block of 256 threads per (lane, group). The full
// automerge-paper trace needs 524,288 rows a document (2 MB), far past
// shared memory, so a lane's rows live in device memory, lane-major
// (contiguous, so a warp's accesses coalesce) in a working array that the
// kernel zeroes first and transposes into the [G*CAP, B] output once at
// the end. The block tables (rws, liv: 1,024 blocks) and the segment sums
// sit in shared memory. The TPU kernel caches a two-block window in VMEM
// and DMAs it; here the rows a step touches (one block or a two-block
// window) are read and written in place and stay in the L1 and L2 caches
// between steps. Each group runs at the same time as the others, so each
// (lane, group) has its own rebalance scratch (the TPU kernel shares one,
// its grid running groups one after another).
//
// What bounds it. Bytes set a floor of ~0.16 ms at the full trace (the
// state written once, 268 MB, and the origins, 266 MB, at 3.35 TB/s); the
// rebalances add their O(capacity) compact and redeal passes (~300 at the
// full trace). Beyond those, the serial chain of 259,778 dependent steps,
// each a few block-wide scans and reductions, bounds it. The design keeps
// each step inside one thread block, makes every pass over the rows
// coalesced (one warp a block in the rebalance), and runs all B x G chains
// at once.

#include <cuda_runtime.h>

#include "blocked_ops.cuh"

namespace {

using namespace blocked_ops;

__global__ void __launch_bounds__(kThreads) blocked_hbm_replay_kernel(
    const int* __restrict__ pos, const int* __restrict__ dlen,
    const int* __restrict__ ilen,
    const int* __restrict__ start,  // [G*S] op columns
    int* ol, int* orr,              // [G, S, B] u32 bits, zeroed by the caller
    int* state_out,                 // [G*CAP, B]
    int* rows_out,                  // [G, NBp, B]
    int* err,                       // [8, B], zeroed by the caller
    int* work, int* tmp,            // [G, B, CAP] working rows, scratch
    int S, int B, int CAP, int K, int NB, int NBp, int NSUP, int LMAX) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x, g = blockIdx.y;
  const int NSUPp = NSUP > 8 ? (NSUP + 7) / 8 * 8 : 8;
  const size_t lane_rows = ((size_t)g * B + lane) * CAP;
  Blocked X;
  X.t = threadIdx.x;
  X.T = blockDim.x;
  X.B = B;
  X.lane = lane;
  X.K = K;
  X.NB = NB;
  X.NBp = NBp;
  X.NSUP = NSUP;
  X.LMAX = LMAX;
  X.CAP = CAP;
  X.two_level = true;
  X.sig = work + lane_rows;
  X.tmp = tmp + lane_rows;
  X.rws = smem;
  X.liv = X.rws + NBp;
  X.supliv = X.liv + NBp;
  X.red = X.supliv + NSUPp;
  X.err = err;
  zero(smem, 2 * NBp + NSUPp);
  zero(X.sig, CAP);
  __syncthreads();

  const size_t base = (size_t)g * S;
  for (int k = 0; k < S; ++k) {
    const int p = pos[base + k], d = dlen[base + k], il = ilen[base + k];
    if (d > 0) X.local_delete(p, d);
    if (il > 0) {
      const size_t o = (base + k) * B + lane;
      X.local_insert(p, il, start[base + k], ol + o, orr + o);
    }
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
    int* tmp, int G, int S, int B, int CAP, int K, int NB, int NBp, int NSUP,
    int LMAX, int smem, void* stream) {
  // smem: bytes of the kernel's shared layout, from the Python wrapper
  // (ops/blocked_hbm.py::kernel_smem_bytes), which also refuses a K
  // outside [8, 1024].
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blocked_hbm_replay_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  blocked_hbm_replay_kernel<<<dim3(B, G), kThreads, smem,
                              (cudaStream_t)stream>>>(
      pos, dlen, ilen, start, ol, orr, state_out, rows_out, err, work, tmp,
      S, B, CAP, K, NB, NBp, NSUP, LMAX);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
