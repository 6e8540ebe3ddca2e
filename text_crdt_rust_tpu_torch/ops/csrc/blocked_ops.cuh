// The per-character block algebra shared by the blocked replay kernels
// (blocked_replay.cu, blocked_hbm_replay.cu, blocked_mixed_replay.cu): the
// CUDA twin of text_crdt_rust_tpu_torch/ops/blocked.py::_BlockOps, written
// once so that the three engines cannot drift, as the JAX package's
// _BlockOps exists for that reason.
//
// State of one lane: `sig`, CAP rows of ±(order+1) (0 = empty) as NB blocks
// of K rows, occupied rows packed at each block's front, contiguous (row
// stride 1) in shared memory (A8, A10) or in device memory behind a cache
// of kSlots blocks in shared memory (A9); per-block row and live counts
// `rws`/`liv` (and, for the two-level descent, 64-block segment sums
// `supliv`), a bound `hw` on each block's non-empty rows (every row at or
// past it is 0) and a bitmask of the non-empty blocks `nz` in shared
// memory.
// One thread block replays one lane; every lane replays the same stream,
// so the TPU kernels' lane-max control scalars equal this thread block's
// own values.
//
// One warp runs the whole step chain. Every operation of a step is a few
// warp-wide shuffles and ballots over a table (the descents) or over one
// block's rows, 32 rows a pass (a live row's rank is a popcount of the
// pass's ballot; four passes' loads are issued together): no block-wide
// barrier sits on the chain. A descent that lands in the block of the
// previous one is answered from that block's cached live prefix, and the
// passes stop at the block's `hw`. The other warps
// of the thread block sleep at a named barrier and wake only to help with
// the passes over the whole state (the rebalance, and A10's per-insert
// view), which warp 0 requests with `run_job`.
//
// A block index past the end reads and writes the last block, as a dynamic
// slice past the end does in the Pallas bodies (only invalid streams reach
// that).
#pragma once

#include "block_ops.cuh"

namespace blocked_ops {

using namespace block_ops;

constexpr int kMaxThreads = 512;  // at most 16 warps a thread block
constexpr int kSup = 64;          // blocks per segment of the two-level descent
constexpr int kSlots = 4;         // blocks the device-memory engine caches
constexpr unsigned kRoot = 0xffffffffu;  // ROOT_ORDER
constexpr int kJobDone = 0, kJobRebalance = 1;

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Inclusive prefix sum over the warp's lanes.
__device__ __forceinline__ int warp_scan(int v) {
  const int ln = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (ln >= o) v += n;
  }
  return v;
}

// Lanes at or below this one.
__device__ __forceinline__ unsigned lanes_le() {
  return kFull >> (31 - (threadIdx.x & 31));
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ±(order+1) -> order as u32 (an empty row decodes to ROOT_ORDER).
__device__ __forceinline__ unsigned order_of(int s) {
  return (unsigned)((s < 0 ? -s : s) - 1);
}

// Barrier 1 over the whole thread block: warp 0 and the helper warps meet
// there (barrier 0, __syncthreads, stays free for the set-up and the end).
__device__ __forceinline__ void job_barrier() {
  asm volatile("bar.sync 1, %0;" ::"r"((int)blockDim.x) : "memory");
}

// Zeroes n ints at a (every thread of the block takes part).
__device__ __forceinline__ void zero(int* a, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = 0;
}

struct Blocked {
  int* sig;      // this lane's CAP rows: shared memory, or device memory
  int* tmp;      // this lane's rebalance scratch: CAP rows, device memory
  int* rws;      // shared [NBp]
  int* liv;      // shared [NBp]
  int* hw;       // shared [NBp]: rows at or past hw[b] of block b are 0
  int* supliv;   // shared [NSUPp], two-level only
  unsigned* nz;  // shared [NBp/32 + 1]: bit b set iff rws[b] > 0, b < NB
  int* job;      // shared [2]: the helpers' next job, a broadcast slot
  int* slots;    // shared [kSlots * K] cached blocks (device-memory rows)
  int* tags;     // shared [2 * kSlots]: cached block per slot, dirty flags
  int* err;      // [8, B]
  int B, lane, K, NB, NBp, NSUP, LMAX, CAP;
  int t, T, ln, warp;  // thread, threads, lane of the warp, warp
  bool two_level, cached;
  int misses;    // warp 0: blocks loaded into the cache
  // Warp 0: the last descent's block (-1: none) and its live prefix
  // live_before_block(hint_b), kept current by add_live.
  int hint_b, hint_lb;

  __device__ void init(int t_) {
    t = t_;
    T = blockDim.x;
    ln = t & 31;
    warp = t >> 5;
    misses = 0;
    hint_b = -1;
  }

  __device__ void raise_err(int row) const {
    if (ln == 0) err[(size_t)row * B + lane] = 1;
  }

  __device__ int slot(int b) const { return clampi(b, 0, NBp - 1); }
  __device__ int block_rows(int b) const {
    return (b >= 0 && b < NBp) ? rws[b] : 0;
  }
  // Start of block b's rows in `sig`, clamped into the state.
  __device__ int row0(int b) const { return clampi(b * K, 0, CAP - K); }
  // Rows of block b that may be non-zero.
  __device__ int bound(int b) const { return hw[row0(b) / K]; }

  // -- the cache of the device-memory engine (warp 0) --------------------

  __device__ void write_back(int s) {
    const int b = tags[s];
    if (b >= 0 && tags[kSlots + s]) {
      const int* src = slots + s * K;
      int* dst = sig + (size_t)b * K;
      for (int r = ln; r < K; r += 32) dst[r] = src[r];
    }
  }

  // Block b's K rows (b in [0, NB)): in place, or in the cache, loaded on
  // a miss after the slot's previous block is written back. `dirty` marks
  // the slot for a write-back.
  __device__ int* blk(int b, bool dirty) {
    b = row0(b) / K;
    if (!cached) return sig + b * K;
    const int s = b & (kSlots - 1);
    if (tags[s] != b) {
      write_back(s);
      const int* src = sig + (size_t)b * K;
      int* dst = slots + s * K;
      for (int r = ln; r < K; r += 32) dst[r] = src[r];
      __syncwarp();
      if (ln == 0) {
        tags[s] = b;
        tags[kSlots + s] = 0;
      }
      ++misses;
    }
    if (dirty && ln == 0) tags[kSlots + s] = 1;
    __syncwarp();
    return slots + s * K;
  }

  // Row 0 of block b without loading it into the cache.
  __device__ int first_row(int b) const {
    b = row0(b) / K;
    if (cached && tags[b & (kSlots - 1)] == b)
      return slots[(b & (kSlots - 1)) * K];
    return sig[(size_t)b * K];
  }

  // Writes every dirty block back and empties the cache.
  __device__ void flush() {
    if (!cached) return;
    for (int s = 0; s < kSlots; ++s) write_back(s);
    __syncwarp();
    if (ln < 2 * kSlots) tags[ln] = ln < kSlots ? -1 : 0;
    __syncwarp();
  }

  // -- descents (warp 0) ---------------------------------------------------

  __device__ int sum_range(const int* a, int lo, int hi) const {
    int v = 0;
    for (int i = lo + ln; i < hi; i += 32) v += a[i];
    return warp_sum(v);
  }

  // Entries i of a[0, n) whose inclusive prefix sum is below target (the
  // descent `cumsum < target` summed), and in *before the sum of those
  // entries. The entries are counts (>= 0), so the ones counted are a
  // prefix of a.
  __device__ int count_below(const int* a, int n, int target,
                             int* before) const {
    int run = 0, cnt = 0, sum = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + ln;
      const int s = warp_scan(i < n ? a[i] : 0) + run;
      const unsigned m = __ballot_sync(kFull, i < n && s < target);
      cnt += __popc(m);
      if (m) sum = __shfl_sync(kFull, s, 31 - __clz(m));
      run = __shfl_sync(kFull, s, 31);
    }
    *before = sum;
    return cnt;
  }

  __device__ int raw_before_block(int b) const {
    return sum_range(rws, 0, min(b, NBp));
  }
  __device__ int live_before_block(int b) const {
    b = min(b, NBp);
    if (!two_level) return sum_range(liv, 0, b);
    const int s = b / kSup, lo = s * kSup;
    int v = 0;
    for (int i = ln; i < s; i += 32) v += supliv[i];
    if (lo + ln < b) v += liv[lo + ln];
    if (lo + 32 + ln < b) v += liv[lo + 32 + ln];
    return warp_sum(v);
  }

  // Smallest block whose cumulative live count reaches rank1: NB when none
  // does (one level), or the two-level descent clamped to the last segment
  // and the last block. *lb = live_before_block(result). When the last
  // descent's block b holds rank1 (live_before(b) < rank1 <= live_before(b)
  // + liv[b]), every block before b counts and b does not: the answer is b
  // at either level.
  __device__ int block_of_rank(int rank1, int* lb) {
    if (hint_b >= 0 && hint_lb < rank1 && rank1 <= hint_lb + liv[hint_b]) {
      *lb = hint_lb;
      return hint_b;
    }
    const int b = descend(rank1, lb);
    hint_b = b < NB ? b : -1;
    hint_lb = *lb;
    return b;
  }
  __device__ int descend(int rank1, int* lb) const {
    if (!two_level) return count_below(liv, NB, rank1, lb);
    int base;
    const int cs = count_below(supliv, NSUP, rank1, &base);
    const int s = min(cs, NSUP - 1);
    if (cs > s) base -= supliv[s];
    // One segment, two entries a lane.
    const int lo = s * kSup;
    const int x0 = liv[lo + 2 * ln], x1 = liv[lo + 2 * ln + 1];
    const int target = rank1 - base;
    const int hi = warp_scan(x0 + x1), mid = hi - x1;
    const int within =
        __popc(__ballot_sync(kFull, mid < target)) +
        __popc(__ballot_sync(kFull, hi < target));
    const int b = lo + within;
    if (b > NB - 1) {
      *lb = live_before_block(NB - 1);
      return NB - 1;
    }
    const int h = within >> 1;
    const int part = within == 0 ? 0
                     : (within & 1) ? __shfl_sync(kFull, mid, h)
                                    : __shfl_sync(kFull, hi, h - 1);
    *lb = base + part;
    return b;
  }

  // First non-empty block after b, NB when none.
  __device__ int next_nonempty(int b) const {
    const int words = (NB + 31) >> 5;
    for (int w0 = (b + 1) >> 5; w0 < words; w0 += 32) {
      const int w = w0 + ln;
      unsigned bits = w < words ? nz[w] : 0u;
      const int first = (b + 1) - (w << 5);  // bits below it do not count
      if (first > 0) bits = first >= 32 ? 0u : bits & (kFull << first);
      const unsigned m = __ballot_sync(kFull, bits != 0u);
      if (m) {
        const int src = __ffs(m) - 1;
        const unsigned v = __shfl_sync(kFull, bits, src);
        return min(((w0 + src) << 5) + __ffs(v) - 1, NB);
      }
    }
    return NB;
  }

  // Every lane of warp 0 (the cached descent follows); lane 0 writes and
  // the caller synchronises the warp.
  __device__ void add_live(int b, int delta) {
    const int s = slot(b);
    if (ln == 0) {
      liv[s] += delta;
      if (two_level) supliv[s / kSup] += delta;
    }
    if (s < hint_b) hint_lb += delta;
  }
  __device__ void add_rows(int b, int n) {
    const int s = slot(b);
    if (ln == 0) {
      rws[s] += n;
      if (s < NB) nz[s >> 5] |= 1u << (s & 31);
    }
  }

  // -- the rows of one block (warp 0) ------------------------------------

  // Tombstones the live rows of one block (n rows may be non-zero) whose
  // rank lies in (p, hi], ranks counted from `rank` (the live rows before
  // the block). Returns the flips; *after is `rank` plus the block's live
  // rows up to the last pass read (the scan stops once the ranks pass hi).
  __device__ int flip_ranks(int* rows, int n, int rank, int p, int hi,
                            int* after) const {
    int flips = 0;
    for (int g = 0; g < n && rank < hi; g += 128) {
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = g + 32 * u + ln;
        v[u] = r < n ? rows[r] : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned m = __ballot_sync(kFull, v[u] > 0);
        const int my = rank + __popc(m & lanes_le());
        const bool flip = v[u] > 0 && my > p && my <= hi;
        if (flip) rows[g + 32 * u + ln] = -v[u];  // only this lane's row
        flips += __popc(__ballot_sync(kFull, flip));
        rank += __popc(m);
      }
    }
    *after = rank;
    return flips;
  }

  // Rows of one block (n rows may be non-zero) whose inclusive live count
  // is below `local`: K when the block's live rows do not reach it.
  __device__ int count_live_below(const int* rows, int n, int local) const {
    if (local <= 0) return 0;
    int run = 0;
    for (int g = 0; g < n; g += 128) {
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = g + 32 * u + ln;
        v[u] = r < n ? rows[r] : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned m = __ballot_sync(kFull, v[u] > 0);
        if (run + __popc(m) >= local) {
          const int my = run + __popc(m & lanes_le());
          const int r = g + 32 * u + ln;
          return g + 32 * u + __popc(__ballot_sync(kFull, r < K && my < local));
        }
        run += __popc(m);
      }
    }
    return K;
  }

  // -- the rebalance (all warps) -----------------------------------------

  // Warp 0 hands a job to the helper warps and does its own share.
  template <class Self>
  __device__ void run_job(Self& self, int j) {
    if (ln == 0) *job = j;
    job_barrier();
    self.do_job(j);
    job_barrier();
  }
  // Helper warps: jobs until kJobDone.
  template <class Self>
  __device__ void serve(Self& self) {
    for (;;) {
      job_barrier();
      const int j = *job;
      if (j == kJobDone) return;
      self.do_job(j);
      job_barrier();
    }
  }
  __device__ void end_jobs() {  // warp 0
    if (ln == 0) *job = kJobDone;
    job_barrier();
  }

  // Global compact-and-redeal (`mutations.rs:623-808` analog), by every
  // warp: each block's packed rows to the scratch in order, then `fill`
  // rows a block back. One warp a block in both passes, eight rows a lane
  // in flight, so the live counts come out of warp sums. The scratch is
  // read only on [0, total); a block's rows past both its new count and
  // its old bound hw are 0 already and are not written.
  __device__ void rebalance_pass() {
    const int nw = T >> 5;
    // Each block's offset, the exclusive prefix of rws, parked in liv
    // (rebuilt below); warp 0 scans while the others wait.
    if (warp == 0) {
      int run = 0;
      for (int i0 = 0; i0 < NB; i0 += 32) {
        const int i = i0 + ln;
        const int x = i < NB ? rws[i] : 0;
        const int s = warp_scan(x) + run;
        if (i < NB) liv[i] = s - x;
        run = __shfl_sync(kFull, s, 31);
      }
      if (ln == 0) job[1] = run;  // the total, read below
    }
    job_barrier();
    const int total = job[1];
    const int fill = (total + NB - 1) / NB;
    if (t == 0 && fill > K - LMAX) err[lane] = 1;  // err row 0
    for (int j = warp; j < NB; j += nw) {
      const int rows = rws[j];
      const int* src = sig + (size_t)j * K;
      int* dst = tmp + liv[j];
      for (int r0 = 0; r0 < rows; r0 += 256) {
        int v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = r0 + u * 32 + ln;
          v[u] = r < rows ? src[r] : 0;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = r0 + u * 32 + ln;
          if (r < rows) dst[r] = v[u];
        }
      }
    }
    job_barrier();
    for (int j = warp; j < NB; j += nw) {
      const int rows = clampi(total - j * fill, 0, fill);
      const int lim = max(rows, hw[j]);
      const int* src = tmp + (size_t)j * fill;
      int* dst = sig + (size_t)j * K;
      int cnt = 0;
      for (int r0 = 0; r0 < lim; r0 += 256) {
        int v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = r0 + u * 32 + ln;
          v[u] = r < rows ? src[r] : 0;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = r0 + u * 32 + ln;
          if (r < lim) dst[r] = v[u];
          cnt += v[u] > 0;
        }
      }
      cnt = warp_sum(cnt);
      if (ln == 0) {
        rws[j] = rows;
        liv[j] = cnt;
        hw[j] = rows;
      }
    }
    job_barrier();
    // The segment sums and the non-empty bitmask, from the new counts.
    if (two_level)
      for (int s = warp; s < NSUP; s += nw) {
        const int v = warp_sum(liv[s * kSup + ln] + liv[s * kSup + 32 + ln]);
        if (ln == 0) supliv[s] = v;
      }
    for (int w0 = warp * 32; w0 < NB; w0 += nw * 32) {
      const int b = w0 + ln;
      const unsigned m = __ballot_sync(kFull, b < NB && rws[b] > 0);
      if (ln == 0) nz[w0 >> 5] = m;
    }
  }

  // -- the local ops (warp 0) --------------------------------------------

  // The overflow rebalance: the cache written back and emptied first.
  template <class Self>
  __device__ void rebalance(Self& self) {
    flush();
    hint_b = -1;
    run_job(self, kJobRebalance);
  }

  // Tombstone d live chars after content position p (`mutations.rs:
  // 520-570`), a two-block window at a time (the second block only when
  // the span reaches it); NB+1 windows without finishing means the delete
  // ran off the document: err row 1.
  __device__ void local_delete(int p, int d) {
    int rem = d, iters = 0;
    while (rem > 0 && iters <= NB) {
      int base;
      const int bd = block_of_rank(p + 1, &base);
      const int b = min(bd, NB - 2);
      if (b != bd) base = live_before_block(b);
      int after;
      const int f0 =
          flip_ranks(blk(b, true), bound(b), base, p, p + rem, &after);
      int f1 = 0;
      if (after < p + rem)
        f1 = flip_ranks(blk(b + 1, true), bound(b + 1), after, p, p + rem,
                        &after);
      add_live(b, -f0);
      add_live(b + 1, -f1);
      __syncwarp();
      rem -= f0 + f1;
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
  template <class Self>
  __device__ Target insert_target(Self& self, int p, int il) {
    Target x;
    int lb = 0;
    x.b = p == 0 ? 0 : block_of_rank(p, &lb);
    if (block_rows(x.b) + il > K) {
      rebalance(self);
      x.b = p == 0 ? 0 : block_of_rank(p, &lb);
    }
    const int r0 = block_rows(x.b);
    const int* rows = blk(x.b, false);
    const int c0 = count_live_below(rows, bound(x.b), p - lb);
    x.c = p == 0 ? 0 : c0 + 1;
    x.left = (x.c - 1 >= 0 && x.c - 1 < K) ? rows[x.c - 1] : 0;
    const int succ_here = (x.c >= 0 && x.c < K) ? rows[x.c] : 0;
    if (x.c < r0) {
      x.succ = succ_here;
    } else {
      const int nb = next_nonempty(x.b);
      x.succ = nb < NB ? first_row(nb) : 0;
    }
    return x;
  }

  // Insert the run (orders st .. st+il) at row c of block b: rows from c
  // roll up by il (`mutations.rs:17-179`; packed slack, no node split).
  // Only rows below max(c + il, hw + a) can change (a row past it reads a
  // row past hw, and was 0). A row reads only rows at or below it, so the
  // passes run top down, 128 rows at a time.
  __device__ void splice(int b, int c, int il, int st) {
    int* rows = blk(b, true);
    const int pb = row0(b) / K;
    const int a = roll_amount(il, LMAX, K);
    const int lo = max(c, 0), hi = min(K, max(c + il, hw[pb] + a));
    for (int g = (hi - 1) & ~127; hi > lo && g >= (lo & ~127); g -= 128) {
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = g + 32 * u + ln;
        v[u] = 0;
        if (k >= lo && k < hi)
          v[u] = k < c + il ? st + (k - c) + 1 : rows[roll_src(k, a, K)];
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = g + 32 * u + ln;
        if (k >= lo && k < hi) rows[k] = v[u];
      }
      __syncwarp();
    }
    add_rows(b, il);
    add_live(b, il);
    if (ln == 0) hw[pb] = hi;
    __syncwarp();
  }

  // The local insert: rebalance on overflow, locate, splice. Writes the
  // u32 origins through lane 0.
  template <class Self>
  __device__ void local_insert(Self& self, int p, int il, int st, int* ol_k,
                               int* or_k) {
    const Target x = insert_target(self, p, il);
    splice(x.b, x.c, il, st);
    if (ln == 0) {
      *ol_k = (int)(p == 0 ? kRoot : order_of(x.left));
      *or_k = (int)(x.succ == 0 ? kRoot : order_of(x.succ));
    }
  }
};

// Shared-memory ints of the block tables: rws, liv, hw, supliv, nz, job
// (ops/blocked.py::table_ints counts the same).
__host__ __device__ inline int table_ints(int NBp, int NSUPp) {
  return 3 * NBp + NSUPp + (NBp / 32 + 1) + 2;
}

// Lays the block tables out at `sm` and points X at them; returns the
// first int after them.
__device__ inline int* place_tables(Blocked& X, int* sm, int NSUPp) {
  X.rws = sm;
  X.liv = X.rws + X.NBp;
  X.hw = X.liv + X.NBp;
  X.supliv = X.hw + X.NBp;
  X.nz = reinterpret_cast<unsigned*>(X.supliv + NSUPp);
  X.job = reinterpret_cast<int*>(X.nz + X.NBp / 32 + 1);
  return X.job + 2;
}

// Op columns read 32 steps at a time, one step a lane, and handed to the
// chain by shuffles.
template <int N>
struct Columns {
  const int* col[N];
  int v[N];
  __device__ void load(int k0, int S, size_t base) {
    const int k = k0 + (threadIdx.x & 31);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = k < S ? col[i][base + k] : 0;
  }
  __device__ int get(int i, int j) const {
    return __shfl_sync(kFull, v[i], j);
  }
};

}  // namespace blocked_ops
