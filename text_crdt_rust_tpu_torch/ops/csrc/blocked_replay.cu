// Per-character blocked replay of one shared local stream, the whole
// document in shared memory, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// text_crdt_rust_tpu/ops/blocked.py::_replay_kernel and computes what it
// computes, bit for bit. The plain PyTorch version of the same function is
// text_crdt_rust_tpu_torch/ops/blocked.py::blocked_replay_plain; the two are
// held against each other on the card.
//
// What it computes. Replay the local op stream (pos, del_len, ins_len,
// ins_order_start) into B identical documents of CAP character rows, NB
// blocks of K (blocked_ops.cuh): a delete tombstones a span through
// two-block windows, an insert splices one block by a circular roll, and a
// block overflow runs the global compact-and-redeal rebalance. Each insert
// emits origin_left / origin_right. err row 0: the rebalance found
// fill > K - lmax; row 1: a delete ran past the end.
//
// Mapping. One thread block per lane (document) of threads_for(K) threads
// (2K/8 rounded to whole warps: 128 at K = 512); the TPU grid's
// sequential chunk axis becomes a loop over all steps inside the thread
// block. As the TPU kernel keeps the document in VMEM, the lane's CAP rows
// live in shared memory (capacity 32,768 at 128 KB; the wrapper refuses a
// document that does not fit and names the device-memory engine), with
// the block tables. The rebalance goes through a lane-private scratch
// in device memory. The rows are written to the [CAP, B] output once, at
// the end.
//
// What bounds it. Not bytes: the output and the origins are written once
// (33 MB at the 19,149-patch prefix over 128 documents). The floor is the
// serial chain of dependent steps, each a few block-wide scans and
// reductions over one K-row block or one 2K-row window in shared memory,
// and the O(capacity) rebalances. The design keeps each step inside one
// thread block (no launches, no grid-wide synchronisation), keeps the rows
// a step touches in shared memory, and runs all B chains at once.

#include <cuda_runtime.h>

#include "blocked_ops.cuh"

namespace {

using namespace blocked_ops;

__global__ void __launch_bounds__(kThreads) blocked_replay_kernel(
    const int* __restrict__ pos, const int* __restrict__ dlen,
    const int* __restrict__ ilen, const int* __restrict__ start,  // [S]
    int* ol, int* orr,    // [S, B] u32 bits, zeroed by the caller
    int* signed_out,      // [CAP, B]
    int* rows_out,        // [NBp, B]
    int* err,             // [8, B], zeroed by the caller
    int* tmp,             // [B, CAP] rebalance scratch
    int S, int B, int CAP, int K, int NB, int NBp, int LMAX) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x;
  Blocked X;
  X.t = threadIdx.x;
  X.T = blockDim.x;
  X.B = B;
  X.lane = lane;
  X.K = K;
  X.NB = NB;
  X.NBp = NBp;
  X.NSUP = 0;
  X.LMAX = LMAX;
  X.CAP = CAP;
  X.two_level = false;
  X.sig = smem;
  X.rws = X.sig + CAP;
  X.liv = X.rws + NBp;
  X.red = X.liv + NBp;
  X.supliv = nullptr;
  X.tmp = tmp + (size_t)lane * CAP;
  X.err = err;
  zero(smem, CAP + 2 * NBp);
  __syncthreads();

  for (int k = 0; k < S; ++k) {
    const int p = pos[k], d = dlen[k], il = ilen[k];
    if (d > 0) X.local_delete(p, d);
    if (il > 0) {
      const size_t o = (size_t)k * B + lane;
      X.local_insert(p, il, start[k], ol + o, orr + o);
    }
  }
  __syncthreads();
  for (int r = X.t; r < CAP; r += X.T)
    signed_out[(size_t)r * B + lane] = X.sig[r];
  for (int j = X.t; j < NBp; j += X.T) rows_out[(size_t)j * B + lane] = X.rws[j];
}

}  // namespace

extern "C" int blocked_replay_launch(
    const int* pos, const int* dlen, const int* ilen, const int* start,
    int* ol, int* orr, int* signed_out, int* rows_out, int* err, int* tmp,
    int S, int B, int CAP, int K, int NB, int NBp, int LMAX, int smem,
    void* stream) {
  // smem: bytes of the kernel's shared layout, from the Python wrapper
  // (ops/blocked.py::kernel_smem_bytes), which also refuses a K outside
  // [8, 1024] and a document past the shared-memory limit.
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blocked_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  blocked_replay_kernel<<<B, threads_for(K), smem, (cudaStream_t)stream>>>(
      pos, dlen, ilen, start, ol, orr, signed_out, rows_out, err, tmp, S, B,
      CAP, K, NB, NBp, LMAX);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
