// Thread-block primitives shared by the run-replay kernels: block-wide
// reductions and prefix sums (warp shuffles joined through shared memory)
// and the net circular roll of the TPU kernels' one-roll-per-bit shifts.
#pragma once

namespace block_ops {

constexpr unsigned kFull = 0xffffffffu;

struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct MinOp {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Block-wide reduction; every thread calls it and gets the result. `red`
// is 32 ints of shared memory. The leading barrier lets a caller reuse
// `red` (and any shared memory read before the call) right after.
template <class Op>
__device__ int block_reduce(int v, int* red, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) red[wid] = v;
  __syncthreads();
  int r = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) r = op(r, red[i]);
  return r;
}

// Block-wide inclusive prefix sum in thread order.
__device__ int block_scan(int v, int* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  __syncthreads();
  if (lane == 31) red[wid] = v;
  __syncthreads();
  int pre = 0;
  for (int i = 0; i < wid; ++i) pre += red[i];
  return v + pre;
}

__device__ __forceinline__ int bit_length(int x) { return 32 - __clz(x); }

// Net roll of the TPU kernels' one-static-roll-per-bit shift: only the low
// bit_length(max_amount) bits of amount count, and rolls wrap modulo n.
__device__ __forceinline__ int roll_amount(int amount, int max_amount, int n) {
  const int bits = bit_length(max_amount > 1 ? max_amount : 1);
  return (amount & ((1 << bits) - 1)) % n;
}

// Row j of x rolled toward higher rows by a (circular): x[(j - a) mod n].
__device__ __forceinline__ int roll_src(int j, int a, int n) {
  const int s = (j - a) % n;
  return s < 0 ? s + n : s;
}

}  // namespace block_ops
