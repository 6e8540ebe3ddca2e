// The per-character block algebra shared by the blocked replay kernels
// (blocked_replay.cu, blocked_hbm_replay.cu, blocked_mixed_replay.cu): the
// CUDA twin of text_crdt_rust_tpu_torch/ops/blocked.py::_BlockOps, written
// once so that the three engines cannot drift, as the JAX package's
// _BlockOps exists for that reason.
//
// State of one lane: `sig`, CAP rows of ±(order+1) (0 = empty) as NB blocks
// of K rows, occupied rows packed at each block's front, contiguous (row
// stride 1) in shared memory or in device memory; per-block row and live
// counts `rws`/`liv` (and, for the two-level descent, 64-block segment sums
// `supliv`) in shared memory. One thread block (at most kThreads threads,
// whole warps) replays one lane; every lane replays the same stream, so
// the TPU kernels' lane-max control scalars equal this thread block's own
// values. Control scalars come from block-wide reductions and are
// identical in every thread.
//
// A block index past the end reads and writes the last block, as a dynamic
// slice past the end does in the Pallas bodies (only invalid streams reach
// that).
#pragma once

#include "block_ops.cuh"

namespace blocked_ops {

using namespace block_ops;

constexpr int kThreads = 256;
constexpr int kSup = 64;   // blocks per segment of the two-level descent
constexpr int kMaxR = 8;   // rows a thread holds of a 2K-row window
constexpr unsigned kRoot = 0xffffffffu;  // ROOT_ORDER

// Threads of a thread block whose rows stay in shared memory: enough that
// a thread holds at most kMaxR rows of a 2K-row window, whole warps, at
// most kThreads. The serial step chain is a string of block-wide barriers,
// and fewer warps make each one cheaper.
inline int threads_for(int K) {
  const int t = ((2 * K + kMaxR - 1) / kMaxR + 31) / 32 * 32;
  return t > kThreads ? kThreads : t;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ±(order+1) -> order as u32 (an empty row decodes to ROOT_ORDER).
__device__ __forceinline__ unsigned order_of(int s) {
  return (unsigned)((s < 0 ? -s : s) - 1);
}

struct Blocked {
  int* sig;     // this lane's CAP rows
  int* tmp;     // this lane's rebalance scratch: CAP rows, device memory
  int* rws;     // shared [NBp]
  int* liv;     // shared [NBp]
  int* supliv;  // shared [NSUPp], two-level only
  int* red;     // shared [32] reduction scratch
  int* err;     // [8, B]
  int B, lane, K, NB, NBp, NSUP, LMAX, CAP, t, T;
  bool two_level;

  __device__ int bsum(int v) { return block_reduce(v, red, SumOp()); }
  __device__ int bmin(int v) { return block_reduce(v, red, MinOp()); }

  __device__ void raise_err(int row) {
    if (t == 0) err[(size_t)row * B + lane] = 1;
  }

  // Start of blocks b .. b+n-1, clamped into the state.
  __device__ int* block(int b, int n = 1) const {
    return sig + clampi(b * K, 0, CAP - n * K);
  }
  __device__ int slot(int b) const { return clampi(b, 0, NBp - 1); }

  // Sum of a[lo, hi).
  __device__ int sum_range(const int* a, int lo, int hi) {
    int v = 0;
    for (int i = lo + t; i < hi; i += T) v += a[i];
    return bsum(v);
  }

  // Entries i of a[0, n) whose inclusive prefix sum is below target: the
  // descent `cumsum < target` summed (each thread a contiguous run).
  __device__ int count_prefix_below(const int* a, int n, int target) {
    const int C = (n + T - 1) / T;
    const int lo = min(t * C, n), hi = min(lo + C, n);
    int part = 0;
    for (int i = lo; i < hi; ++i) part += a[i];
    int run = block_scan(part, red) - part, cnt = 0;
    for (int i = lo; i < hi; ++i) {
      run += a[i];
      cnt += run < target;
    }
    return bsum(cnt);
  }

  __device__ int live_before_block(int b) {
    // Equal to the two-level sum (supliv holds each segment's liv sum).
    return sum_range(liv, 0, min(b, NBp));
  }
  __device__ int raw_before_block(int b) {
    return sum_range(rws, 0, min(b, NBp));
  }
  __device__ int block_rows(int b) const {
    return (b >= 0 && b < NBp) ? rws[b] : 0;
  }
  __device__ int total_raw() { return sum_range(rws, 0, NB); }

  // Smallest block whose cumulative live count reaches rank1: NB when none
  // does (one level), or the two-level descent clamped to the last segment
  // and the last block.
  __device__ int block_of_rank(int rank1) {
    if (!two_level) return count_prefix_below(liv, NB, rank1);
    const int s = min(count_prefix_below(supliv, NSUP, rank1), NSUP - 1);
    const int base = sum_range(supliv, 0, s);
    const int within =
        count_prefix_below(liv + s * kSup, kSup, rank1 - base);
    return min(s * kSup + within, NB - 1);
  }

  // Thread 0 only; the caller synchronises before the next read.
  __device__ void add_live(int b, int delta) {
    liv[slot(b)] += delta;
    if (two_level) supliv[slot(b) / kSup] += delta;
  }

  // Rebuilds supliv from liv, one warp a segment.
  __device__ void resup() {
    const int w = t >> 5, ln = t & 31, nw = T >> 5;
    for (int s = w; s < NSUP; s += nw) {
      const int v = warp_sum(liv[s * kSup + ln] + liv[s * kSup + 32 + ln]);
      if (ln == 0) supliv[s] = v;
    }
    __syncthreads();
  }

  // Global compact-and-redeal (`mutations.rs:623-808` analog): every
  // block's packed rows to the scratch in order, then `fill` rows a block
  // back. One warp a block in both passes, so the live counts come out of
  // warp sums. The scratch is read only on [0, total).
  __device__ void rebalance() {
    const int total = total_raw();
    const int fill = (total + NB - 1) / NB;
    if (fill > K - LMAX) raise_err(0);
    // Each block's offset, the exclusive prefix of rws, parked in liv
    // (rebuilt below).
    {
      const int C = (NB + T - 1) / T;
      const int lo = min(t * C, NB), hi = min(lo + C, NB);
      int part = 0;
      for (int i = lo; i < hi; ++i) part += rws[i];
      int run = block_scan(part, red) - part;
      for (int i = lo; i < hi; ++i) {
        liv[i] = run;
        run += rws[i];
      }
    }
    __syncthreads();
    const int w = t >> 5, ln = t & 31, nw = T >> 5;
    for (int j = w; j < NB; j += nw) {
      const int rows = rws[j];
      const int* src = sig + (size_t)j * K;
      int* dst = tmp + liv[j];
      for (int r = ln; r < rows; r += 32) dst[r] = src[r];
    }
    __syncthreads();
    for (int j = w; j < NB; j += nw) {
      const int rows = clampi(total - j * fill, 0, fill);
      const int* src = tmp + (size_t)j * fill;
      int* dst = sig + (size_t)j * K;
      int cnt = 0;
      for (int r = ln; r < K; r += 32) {
        const int v = r < rows ? src[r] : 0;
        dst[r] = v;
        cnt += v > 0;
      }
      cnt = warp_sum(cnt);
      if (ln == 0) {
        rws[j] = rows;
        liv[j] = cnt;
      }
    }
    __syncthreads();
    if (two_level) resup();
  }

  // Tombstone d live chars after content position p (`mutations.rs:
  // 520-570`), a two-block window at a time; NB+1 windows without finishing
  // means the delete ran off the document: err row 1.
  __device__ void local_delete(int p, int d) {
    int rem = d, iters = 0;
    const int n = 2 * K, R = (n + T - 1) / T;
    while (rem > 0 && iters <= NB) {
      const int b = min(block_of_rank(p + 1), NB - 2);
      const int base = live_before_block(b);
      int* win = block(b, 2);
      int v[kMaxR], cum[kMaxR], tot = 0;
#pragma unroll
      for (int j = 0; j < kMaxR; ++j) {
        const int k = t * R + j;
        v[j] = (j < R && k < n) ? win[k] : 0;
        tot += v[j] > 0;
        cum[j] = tot;
      }
      const int excl = block_scan(tot, red) - tot;
      int f0 = 0, f1 = 0;
#pragma unroll
      for (int j = 0; j < kMaxR; ++j) {
        const int k = t * R + j;
        const int rank = base + excl + cum[j];
        if (j < R && k < n && v[j] > 0 && rank > p && rank <= p + rem) {
          win[k] = -v[j];  // only this thread touches row k here
          if (k < K) ++f0; else ++f1;
        }
      }
      const int F0 = bsum(f0), F1 = bsum(f1);
      if (t == 0) {
        add_live(b, -F0);
        add_live(b + 1, -F1);
      }
      __syncthreads();
      rem -= F0 + F1;
      ++iters;
    }
    if (rem > 0) raise_err(1);
  }

  struct Target {
    int b, c, left, succ;  // block, row cursor, left / successor row values
  };

  // Where a local insert of il items at live rank p lands, after the
  // overflow rebalance if its block cannot absorb them, and its origins'
  // row values (`doc.rs:447-453`): the raw predecessor, and the raw
  // successor, past the block's packed rows the first row of the next
  // non-empty block. The TPU kernel locates the block twice; without a
  // rebalance between them both give the same block.
  __device__ Target insert_target(int p, int il) {
    Target x;
    x.b = p == 0 ? 0 : block_of_rank(p);
    if (block_rows(x.b) + il > K) {
      rebalance();
      x.b = p == 0 ? 0 : block_of_rank(p);
    }
    const int r0 = block_rows(x.b);
    const int local = p - live_before_block(x.b);
    const int* blk = block(x.b);
    const int R = (K + T - 1) / T;
    int cum[kMaxR], tot = 0;
#pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      const int k = t * R + j;
      tot += (j < R && k < K && blk[k] > 0) ? 1 : 0;
      cum[j] = tot;
    }
    const int excl = block_scan(tot, red) - tot;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      const int k = t * R + j;
      cnt += (j < R && k < K && excl + cum[j] < local) ? 1 : 0;
    }
    const int c0 = bsum(cnt);
    x.c = p == 0 ? 0 : c0 + 1;
    x.left = (x.c - 1 >= 0 && x.c - 1 < K) ? blk[x.c - 1] : 0;
    const int succ_here = (x.c >= 0 && x.c < K) ? blk[x.c] : 0;
    int m = NB;
    for (int i = x.b + 1 + t; i < NB; i += T)
      if (i >= 0 && rws[i] > 0) m = min(m, i);
    const int nb_next = bmin(m);
    const int succ_next = block(min(nb_next, NB - 1))[0];
    x.succ = x.c < r0 ? succ_here : (nb_next < NB ? succ_next : 0);
    return x;
  }

  // Insert the run (orders st .. st+il) at row c of block b: rows from c
  // roll up by il (`mutations.rs:17-179`; packed slack, no node split).
  __device__ void splice(int b, int c, int il, int st) {
    int* blk = block(b);
    const int R = (K + T - 1) / T;
    const int a = roll_amount(il, LMAX, K);
    int nv[kMaxR];
#pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      const int k = t * R + j;
      if (j < R && k < K)
        nv[j] = k < c ? blk[k]
                      : (k < c + il ? st + (k - c) + 1 : blk[roll_src(k, a, K)]);
    }
    __syncthreads();  // every read of the block is done
#pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      const int k = t * R + j;
      if (j < R && k < K) blk[k] = nv[j];
    }
    if (t == 0) {
      rws[slot(b)] += il;
      add_live(b, il);
    }
    __syncthreads();
  }

  // The local insert: rebalance on overflow, locate, splice. Writes the
  // u32 origins through thread 0.
  __device__ void local_insert(int p, int il, int st, int* ol_k, int* or_k) {
    const Target x = insert_target(p, il);
    splice(x.b, x.c, il, st);
    if (t == 0) {
      *ol_k = (int)(p == 0 ? kRoot : order_of(x.left));
      *or_k = (int)(x.succ == 0 ? kRoot : order_of(x.succ));
    }
  }
};

// Zeroes n ints at a (every thread of the block takes part).
__device__ __forceinline__ void zero(int* a, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = 0;
}

}  // namespace blocked_ops
