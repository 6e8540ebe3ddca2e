// Warp-per-document primitives shared by the two per-lane mixed replay
// kernels (rle_lanes_mixed.cu, un-blocked; rle_lanes_mixed_blocked.cu,
// blocked): warp reductions and prefix sums, the net circular roll of the
// TPU kernels' one-roll-per-bit shifts, by-order table access, the YATA
// scan predicates, the three-piece split of a partly covered run, a tiled
// transpose between the public [rows, B] layout and the kernels' lane-major
// working planes, and the step-0 merge of the by-order tables.
//
// One warp owns one document (lane of the JAX layout). Every control scalar
// is computed by all 32 threads alike (from shared memory after a
// __syncwarp, or from a warp reduction), so control flow stays uniform
// within the warp and every full-mask collective is reached by all threads.
#pragma once

namespace lanes {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLocal = 0, kRemoteIns = 1, kRemoteDel = 2;
constexpr int kRoot = -1;     // ROOT_ORDER as int32
constexpr int kUnknown = -2;  // by-order table sentinel: entry not known

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  return a - floordiv(a, b) * b;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int wsum(int v) {
  return __reduce_add_sync(kFull, v);
}
__device__ __forceinline__ int wmin(int v) {
  return __reduce_min_sync(kFull, v);
}
__device__ __forceinline__ int wmax(int v) {
  return __reduce_max_sync(kFull, v);
}

// Inclusive prefix sum over the warp, in lane order.
__device__ __forceinline__ int wscan(int v) {
  const int lane = lane_id();
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// out[j] = inclusive prefix sum of in[0..j], j < n (both may be global or
// shared; out may alias in). Rows go 32 at a time in lane order.
//
// Every helper that writes a warp's scratch or planes starts with a
// __syncwarp: a thread may still be reading what another thread is about
// to overwrite, and not every path reaches the write through a warp
// collective.
__device__ void wprefix(const int* in, int* out, int n) {
  __syncwarp();
  int carry = 0;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane_id();
    const int v = j < n ? in[j] : 0;
    const int s = wscan(v);
    if (j < n) out[j] = carry + s;
    carry += __shfl_sync(kFull, s, 31);
  }
  __syncwarp();
}

__device__ __forceinline__ int bit_length(int x) { return 32 - __clz(x); }

// Net roll of the TPU kernels' one-static-roll-per-bit shift: only the low
// bit_length(max_amount) bits of amount count, and rolls wrap modulo n.
__device__ __forceinline__ int roll_amount(int amount, int max_amount,
                                           int n) {
  const int bits = bit_length(max_amount > 1 ? max_amount : 1);
  return (amount & ((1 << bits) - 1)) % n;
}

// Source row of row j after a circular roll toward higher rows by a.
__device__ __forceinline__ int roll_src(int j, int a, int n) {
  const int s = (j - a) % n;
  return s < 0 ? s + n : s;
}

// Row r of an n-row column, 0 outside [0, n) (the masked sum of the
// Pallas bodies).
__device__ __forceinline__ int row_or0(const int* x, int r, int n) {
  return (r >= 0 && r < n) ? x[r] : 0;
}

// The by-order tables are [OCAP, B]: entry o of lane b at o * B + b. A read
// clamps the order into [0, OCAP) as t_read does: masked-off probes pass
// negative orders, and on the card an out-of-range read is a fault.
struct Tab {
  int* p;
  int B, OCAP;
  __device__ __forceinline__ int get(int o) const {
    return p[(long long)clampi(o, 0, OCAP - 1) * B];
  }
  __device__ __forceinline__ void put(int o, int v) const {
    p[(long long)o * B] = v;
  }
};

// One probe of the run-level YATA conflict scan (`doc.rs:183-222`), the
// predicates of integrate_cursor's body for one live lane. Updates the scan
// state; returns true when the scan breaks. `stuck` reports a step that
// would not move the cursor (only a corrupt state gives one; the TPU
// kernel's loop would never end there).
struct Yata {
  int cursor, scanning, scan_start, left_cursor;
};

__device__ __forceinline__ bool yata_probe(Yata& y, int my_rank, int o_right,
                                           int so, int l_r, int off,
                                           int olc, int other_right,
                                           int other_rank, bool& stuck) {
  const int other_order = so + off;
  bool brk = (other_order == o_right) || (olc < y.left_cursor);
  const bool eq = !brk && olc == y.left_cursor;
  const bool gt = my_rank > other_rank;
  brk = brk || (eq && !gt && o_right == other_right);
  const bool starts_scan = eq && !gt && o_right != other_right;
  if (starts_scan && !y.scanning) y.scan_start = y.cursor;
  if (eq) y.scanning = gt ? 0 : (o_right == other_right ? y.scanning : 1);
  const bool contains_right = o_right > other_order && o_right < so + l_r;
  const int step = contains_right ? o_right - other_order : l_r - off;
  stuck = !brk && step <= 0;
  if (!brk) y.cursor += step;
  return brk;
}

// The <= 3 pieces of a live run partly covered by a delete: [head?]
// [tombstone middle] [tail?], written at rows i, i+1, i+2 after the rows
// past i moved down by amt = has_head + has_tail. `o` is the run's signed
// start (+(start+1)), `ln` its length, [cs, ce) the covered char offsets.
struct Pieces {
  int amt, o0, l0, o1, l1, o2, l2;
};

__device__ __forceinline__ Pieces split_pieces(int o, int ln, int cs,
                                               int ce) {
  Pieces p;
  const bool head = cs > 0, tail = ce < ln;
  const int cov = ce - cs;
  p.amt = (int)head + (int)tail;
  p.o0 = head ? o : -(o + cs);
  p.l0 = head ? cs : cov;
  p.o1 = head ? -(o + cs) : o + ce;
  p.l1 = head ? cov : ln - ce;
  p.o2 = o + ce;
  p.l2 = ln - ce;
  return p;
}

// Write a piece split into column (co, cl) of n rows: rows past i move down
// by p.amt (a circular roll, from the copies xo/xl), then the pieces land.
__device__ void apply_pieces(int* co, int* cl, int* xo, int* xl, int n,
                             int i, const Pieces& p) {
  const int lane = lane_id();
  __syncwarp();
  for (int j = lane; j < n; j += 32) {
    xo[j] = co[j];
    xl[j] = cl[j];
  }
  __syncwarp();
  for (int j = lane; j < n; j += 32) {
    int no = co[j], nl = cl[j];
    if (j > i) {
      const int s = roll_src(j, p.amt, n);
      no = xo[s];
      nl = xl[s];
    }
    if (j == i) {
      no = p.o0;
      nl = p.l0;
    } else if (j == i + 1 && p.amt >= 1) {
      no = p.o1;
      nl = p.l1;
    } else if (j == i + 2 && p.amt == 2) {
      no = p.o2;
      nl = p.l2;
    }
    co[j] = no;
    cl[j] = nl;
  }
  __syncwarp();
}

// dst[c * R + r] = src[r * C + c]: [R, C] -> [C, R], 32x32 tiles through
// shared memory. Launch with blocks of (32, 8) threads over
// (ceil(C/32), ceil(R/32)).
__global__ void transpose_i32(const int* __restrict__ src,
                              int* __restrict__ dst, int R, int C) {
  __shared__ int tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int dy = threadIdx.y; dy < 32; dy += 8) {
    const int r = r0 + dy, c = c0 + threadIdx.x;
    if (r < R && c < C) tile[dy][threadIdx.x] = src[(long long)r * C + c];
  }
  __syncthreads();
  for (int dy = threadIdx.y; dy < 32; dy += 8) {
    const int c = c0 + dy, r = r0 + threadIdx.x;
    if (r < R && c < C) dst[(long long)c * R + r] = tile[threadIdx.x][dy];
  }
}

// Step 0's table merge: this chunk's compile-known entries (the prefill
// delta, -2 where unknown) over the carried tables, elementwise.
__global__ void merge_tables(const int* __restrict__ olld,
                             const int* __restrict__ oll0,
                             const int* __restrict__ orld,
                             const int* __restrict__ orl0,
                             int* __restrict__ oll, int* __restrict__ orl,
                             long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int a = olld[i], b = orld[i];
    oll[i] = a != kUnknown ? a : oll0[i];
    orl[i] = b != kUnknown ? b : orl0[i];
  }
}

// Host side: [R, C] -> [C, R] on `stream`.
inline void launch_transpose(const int* src, int* dst, int R, int C,
                             cudaStream_t stream) {
  const dim3 grid((C + 31) / 32, (R + 31) / 32), block(32, 8);
  transpose_i32<<<grid, block, 0, stream>>>(src, dst, R, C);
}

inline void launch_merge(const int* olld, const int* oll0, const int* orld,
                         const int* orl0, int* oll, int* orl, long long n,
                         cudaStream_t stream) {
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 4096 ? (want > 0 ? want : 1) : 4096);
  merge_tables<<<blocks, 256, 0, stream>>>(olld, oll0, orld, orl0, oll, orl,
                                           n);
}

}  // namespace lanes
