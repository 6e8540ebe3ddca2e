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
// Mapping. One thread block per lane (document) of kWarps warps; the TPU
// grid's sequential chunk axis becomes a loop over all steps inside warp 0
// (blocked_ops.cuh), the other warps helping only with the rebalance. As
// the TPU kernel keeps the document in VMEM, the lane's CAP rows live in
// shared memory (capacity 32,768 at 128 KB; the wrapper refuses a document
// that does not fit and names the device-memory engine), with the block
// tables. The rebalance goes through a lane-private scratch in device
// memory. The rows are written to the [CAP, B] output once, at the end.
//
// What bounds it. Not bytes: the output and the origins are written once
// (33 MB at the 19,149-patch prefix over 128 documents). The floor is the
// serial chain of dependent steps, each a few warp-wide scans over a block
// table and one or two K-row blocks in shared memory, and the O(capacity)
// rebalances. The design keeps each step inside one warp (no barriers, no
// launches), keeps the rows a step touches in shared memory, and runs all
// B chains at once.

#include <cuda_runtime.h>

#include "blocked_ops.cuh"

namespace {

using namespace blocked_ops;

constexpr int kWarps = 8;

struct Local : Blocked {
  __device__ void do_job(int) { rebalance_pass(); }
};

__global__ void __launch_bounds__(kMaxThreads) blocked_replay_kernel(
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
  Local X;
  X.init(threadIdx.x);
  X.B = B;
  X.lane = lane;
  X.K = K;
  X.NB = NB;
  X.NBp = NBp;
  X.NSUP = 0;
  X.LMAX = LMAX;
  X.CAP = CAP;
  X.two_level = false;
  X.cached = false;
  X.sig = smem;
  place_tables(X, smem + CAP, 0);
  X.tmp = tmp + (size_t)lane * CAP;
  X.err = err;
  zero(smem, CAP + table_ints(NBp, 0));
  __syncthreads();

  if (X.warp == 0) {
    Columns<4> cols{{pos, dlen, ilen, start}};
    for (int k0 = 0; k0 < S; k0 += 32) {
      cols.load(k0, S, 0);
      const int n = min(32, S - k0);
      for (int j = 0; j < n; ++j) {
        const int p = cols.get(0, j), d = cols.get(1, j), il = cols.get(2, j);
        const int st = cols.get(3, j);
        if (d > 0) X.local_delete(p, d);
        if (il > 0) {
          const size_t o = (size_t)(k0 + j) * B + lane;
          X.local_insert(X, p, il, st, ol + o, orr + o);
        }
      }
    }
    X.end_jobs();
  } else {
    X.serve(X);
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
  // (ops/blocked.py::kernel_smem_bytes), which also refuses K below 8 and
  // a document past the shared-memory limit.
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blocked_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  blocked_replay_kernel<<<B, kWarps * 32, smem, (cudaStream_t)stream>>>(
      pos, dlen, ilen, start, ol, orr, signed_out, rows_out, err, tmp, S, B,
      CAP, K, NB, NBp, LMAX);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
