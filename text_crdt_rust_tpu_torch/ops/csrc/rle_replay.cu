// RLE run-block replay of a shared local-edit stream, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel text_crdt_rust_tpu/ops/rle.py::_rle_kernel
// and computes exactly what it computes, bit for bit, including the stale
// block-table entries that its circular rolls leave past the last logical
// slot. The plain PyTorch version of the same function is
// text_crdt_rust_tpu_torch/ops/rle.py::rle_replay_plain; the two are held
// against each other on the card.
//
// What it computes. For each doc group g, replay the group's op stream
// (columns pos, del_len, ins_len, ins_order_start, rows_per_step) on RLE
// run planes: ordp = ±(start_order+1) and lenp = run length, in blocks of
// K rows, ordered by a logical block table (blkord) with per-slot run
// counts (rws) and live-char counts (liv). Position -> slot is the first
// slot whose inclusive live prefix reaches the rank (the TPU kernel keeps
// that prefix as a table, cumliv, and so does this kernel). A
// delete flips the runs it covers and splits at most two boundary runs per
// block, walking blocks; an insert splices w run rows plus at most one
// split tail; a full block splits into a fresh physical block. Each insert
// emits origin_left / origin_right. err[0] is raised when a split finds
// the table full (the split is skipped and the insert still proceeds),
// err[1] when a delete runs past the end.
//
// What bounds it. Not bytes: one replay moves ~120 MB at the north-star
// shape (B = 512, CAP = 20,992, S = 8,192 padded steps), ~36 us at
// 3.35 TB/s. The floor is the serial chain of 7,352 dependent steps, each
// a slot locate over the table, a run locate in one block and a splice.
// The first port spent ~3 us a step on block-wide barriers (every control
// scalar a reduction over K threads), on the edited block's round trip to
// device memory, on a suffix update of cumliv over every slot, and ended
// with a transpose whose stores were 2 KB apart.
//
// What the design does about it. One thread block per (lane, group), as
// before (doc groups on the grid's second axis); warp 0 runs the whole
// step chain and every control scalar is a warp scan, ballot or redux.sync
// taken once a step. The other warps of the block (`warps` - 1, from the
// wrapper) sleep at a named barrier and join only the passes over whole
// blocks: the window's write-back and reload, a split's copy into the
// fresh block with the tables' shift, the final flush. The edited block
// is cached in shared memory across steps as a ring (logical row k at
// physical row (k + rot) mod K): it is written back only when a step
// edits another block, before a split moves its top half, and at the end.
// A splice that inserts `a` rows at row q moves the shorter side: rows
// [q, hw) up, or, turning the ring back by `a`, rows [0, q) down; hw
// bounds the window's non-empty rows (every row at or past it is 0). The
// next slot's first row (an insert's raw successor past the block's last
// run) comes from a table of each physical block's head, kept as blocks
// leave the window. Each lane's planes are its own lane-major working
// copy ([G, B, CAP]: a block is K contiguous ints); only block 0 is zeroed
// at the start, a split writes all K rows of its fresh block, and a
// separate tiled transpose writes the public [G*CAP, B] planes at the end,
// 0 past the blocks in use. Every lane replays the same stream, so the TPU
// kernel's lane-max control scalars equal this thread block's own; every
// thread block still reads and writes only its own lane's planes.

#include <cuda_runtime.h>

#include "block_ops.cuh"

namespace {

using block_ops::kFull;
using block_ops::roll_amount;

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(kFull, v);
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

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Barrier 1 over the whole thread block: warp 0 and the helper warps meet
// there (barrier 0, __syncthreads, stays free for the set-up and the end).
__device__ __forceinline__ void job_barrier() {
  asm volatile("bar.sync 1, %0;" ::"r"((int)blockDim.x) : "memory");
}

constexpr unsigned kRoot = 0xffffffffu;  // ROOT_ORDER
constexpr int kMaxThreads = 512;
constexpr int kTab = 8;    // table entries a thread moves per round of a shift
constexpr int kGroup = 4;  // 32-row passes whose loads are issued together
constexpr int kJobDone = 0, kJobEnsure = 1, kJobSplit = 2;
// stats[g, lane, :]: splits, window loads, successor peeks, steps with work;
// cycles in slot locates, run locates, insert splices, delete passes,
// splits, window loads, the final write-out, and in all.
constexpr int kStats = 12;

struct Replay {
  int* O;  // this lane's working ordp plane [CAP] (lane-major, device)
  int* L;
  int* wo;  // shared [K] window ring: ordp / lenp rows of the cached block
  int* wl;
  int* sa;  // shared [K] delete scratch by logical row: cs, ce
  int* sb;
  int* blkord;  // shared [NBL]
  int* rws;
  int* liv;
  int* cum;  // shared [NBL]: inclusive live prefix of liv (slots < nlog)
  int* hd;   // shared [NBL]: row 0 of each physical block (not the cached)
  int* job;  // shared [8]: job and its arguments
  int* red;  // shared [32]: results of a job
  int* err;  // [8, B]
  int B, lane, K, NB, NBL, WMAX;
  int t, T, ln;
  // Warp 0's chain state.
  int nlog;    // blocks in use
  int cached;  // physical block held by the window
  int rot;     // the window ring's rotation
  int hw;      // every logical window row at or past hw is 0
  int hwmax;   // the largest hw since the window was loaded
  long long st[kStats];

  // Physical window row of logical row k in [0, K).
  __device__ __forceinline__ int ph(int k) const {
    const int j = k + rot;
    return j >= K ? j - K : j;
  }
  // Logical row k of the window; outside the block reads 0, as the TPU
  // kernel's masked sums do.
  __device__ __forceinline__ int row(const int* arr, int k) const {
    return (k >= 0 && k < K) ? arr[ph(k)] : 0;
  }

  // -- helper warps ----------------------------------------------------------

  // Warp 0: every warp runs job j (arguments in job[1..]).
  __device__ void run_job(int j) {
    __syncwarp();
    if (ln == 0) job[0] = j;
    job_barrier();
    do_job();
    job_barrier();
  }
  __device__ void serve() {
    for (;;) {
      job_barrier();
      if (job[0] == kJobDone) return;
      do_job();
      job_barrier();
    }
  }
  __device__ void end_jobs() {
    __syncwarp();
    if (ln == 0) job[0] = kJobDone;
    job_barrier();
  }
  __device__ void do_job() {
    if (job[0] == kJobEnsure) job_ensure();
    if (job[0] == kJobSplit) job_split();
  }

  // Writes the window's logical rows [0, hwm) back to block `old` (rows
  // past hwm are 0 there and in the window) and records its head, then
  // loads block b at rotation 0; red[0] gets the loaded rows' hw. Rows are
  // read four a thread at a time so that their loads are in flight
  // together.
  __device__ void job_ensure() {
    const int b = job[1], old = job[2], rt = job[3], hwm = job[4];
    for (int j = t; j < K; j += T) {
      int r = j - rt;
      if (r < 0) r += K;
      if (r < hwm) {
        O[old * K + r] = wo[j];
        L[old * K + r] = wl[j];
      }
      if (r == 0) hd[old] = wo[j];
    }
    int mx = 0;
    for (int j0 = t; j0 < K; j0 += 4 * T) {
      int o[4], l[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * T;
        o[u] = j < K ? O[b * K + j] : 0;
        l[u] = j < K ? L[b * K + j] : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * T;
        if (j < K) {
          wo[j] = o[u];
          wl[j] = l[u];
          if (o[u] != 0 || l[u] != 0) mx = j + 1;
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1)
      mx = max(mx, __shfl_xor_sync(kFull, mx, o));
    if (ln == 0) atomicMax(&red[0], mx);
  }

  // Leaf split of logical slot l (block cached, r rows, nb fresh, nl blocks
  // in use before it): the top half of the window goes to block nb (all K
  // of its rows are written), the window keeps rows [0, keep), slots > l
  // take their predecessor's entry (the TPU kernel's circular roll by one,
  // masked to rows > l; every entry at or past nl is 0, so only [l+2, nl]
  // changes), and slots l and l+1 take their halves. red[1] collects the
  // top half's live chars.
  __device__ void job_split() {
    const int l = job[1], r = job[2], nb = job[3], rt = job[4];
    const int hw0 = job[5], nl = job[6];
    const int keep = r / 2, mv = r - keep;
    const int up = roll_amount(keep, K, K);
    auto lph = [&](int k) {  // physical row of logical k
      const int j = k + rt;
      return j >= K ? j - K : j;
    };
    int hi_part = 0;
    for (int k = keep + t; k < r && k < K; k += T)
      if (wo[lph(k)] > 0) hi_part += wl[lph(k)];
    hi_part = warp_sum(hi_part);
    if (ln == 0 && hi_part != 0) atomicAdd(&red[1], hi_part);
    for (int k = t; k < K; k += T) {
      int s = k + up;
      if (s >= K) s -= K;
      const int o = k < mv ? wo[lph(s)] : 0;
      O[nb * K + k] = o;
      L[nb * K + k] = k < mv ? wl[lph(s)] : 0;
      if (k == 0) hd[nb] = o;
    }
    __syncthreads();  // the window's top half is read
    for (int k = keep + t; k < hw0; k += T) {
      wo[lph(k)] = 0;
      wl[lph(k)] = 0;
    }
    for (int top = nl; top >= l + 2; top -= kTab * T) {
      int vb[kTab], vr[kTab], vl[kTab], vc[kTab];
#pragma unroll
      for (int u = 0; u < kTab; ++u) {
        const int j = top - t - u * T;
        if (j >= l + 2 && j > top - kTab * T) {
          vb[u] = blkord[j - 1];
          vr[u] = rws[j - 1];
          vl[u] = liv[j - 1];
          vc[u] = cum[j - 1];
        }
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kTab; ++u) {
        const int j = top - t - u * T;
        if (j >= l + 2 && j > top - kTab * T) {
          blkord[j] = vb[u];
          rws[j] = vr[u];
          liv[j] = vl[u];
          cum[j] = vc[u];
        }
      }
    }
    __syncthreads();
    if (t == 0) {
      const int liv_hi = red[1], c = cum[l];
      rws[l] = keep;
      liv[l] -= liv_hi;
      cum[l] = c - liv_hi;
      blkord[l + 1] = nb;
      rws[l + 1] = mv;
      liv[l + 1] = liv_hi;
      cum[l + 1] = c;
    }
  }

  // -- the slot locate (warp 0) ------------------------------------------------

  // The smallest slot below nlog whose inclusive live prefix reaches rank1
  // (clamped to nlog - 1), and in *before the live chars of the slots
  // before it: one warp pass over the prefix table, 32 slots a round (the
  // prefix never decreases, so the slots below rank1 are a prefix).
  __device__ int slot_of_live_rank(int rank1, int* before) const {
    int cnt = 0;
#pragma unroll 4
    for (int j = ln; j < nlog; j += 32) cnt += cum[j] < rank1;
    const int l = min(warp_sum(cnt), nlog - 1);
    *before = cum[l] - liv[l];
    return l;
  }

  // cum[j] += v for the slots j in [l, nlog), one warp round of 32.
  __device__ void add_from(int l, int v) {
    __syncwarp();
#pragma unroll 4
    for (int j = l + ln; j < nlog; j += 32) cum[j] += v;
    __syncwarp();
  }

  // -- the window (warp 0) ---------------------------------------------------

  // Caches physical block b in the window.
  template <bool STATS>
  __device__ void ensure(int b) {
    if (b == cached) return;
    const long long c0 = STATS ? clock64() : 0;
    __syncwarp();
    if (ln == 0) {
      job[1] = b;
      job[2] = cached;
      job[3] = rot;
      job[4] = hwmax;
      red[0] = 0;
    }
    run_job(kJobEnsure);
    cached = b;
    rot = 0;
    hw = red[0];
    hwmax = hw;
    if (STATS) {
      ++st[1];
      st[9] += clock64() - c0;
    }
  }

  // Leaf split of logical slot l into a fresh physical block at slot l+1.
  template <bool STATS>
  __device__ void split(int l) {
    if (nlog >= NB) {
      if (ln == 0) err[lane] = 1;  // err row 0
      return;
    }
    ensure<STATS>(blkord[l]);
    const long long c0 = STATS ? clock64() : 0;
    const int r = rws[l];
    __syncwarp();
    if (ln == 0) {
      job[1] = l;
      job[2] = r;
      job[3] = nlog;
      job[4] = rot;
      job[5] = hw;
      job[6] = nlog;
      red[1] = 0;
    }
    run_job(kJobSplit);
    nlog += 1;
    hw = min(hw, r / 2);
    if (STATS) {
      ++st[0];
      st[8] += clock64() - c0;
    }
  }

  // Rows [q, K) of the window move up by a (0 <= a < K): row k >= q + a
  // takes row k - a and the top a rows drop off, as the TPU kernel's
  // circular roll of rows >= q does (every caller overwrites rows
  // [q, q + a) next). The shorter side moves: rows [q, hw) up, or, with
  // the ring turned back by a, rows [0, q) down.
  // The leading __syncwarp orders every lane's earlier reads of the window
  // before the writes of the shift and of the caller.
  __device__ void shift_up(int q, int a) {
    __syncwarp();
    if (a <= 0 || q >= K) return;
    const int top = min(hw, K - a);
    if (top - q <= q) {
      for (int hi = top; hi > q; hi -= 32) {
        const int s = hi - 1 - ln;
        int o = 0, l = 0;
        if (s >= q) {
          o = wo[ph(s)];
          l = wl[ph(s)];
        }
        __syncwarp();
        if (s >= q) {
          wo[ph(s + a)] = o;
          wl[ph(s + a)] = l;
        }
        __syncwarp();
      }
    } else {
      rot -= a;
      if (rot < 0) rot += K;
      for (int lo = 0; lo < q; lo += 32) {
        const int d = lo + ln;
        int o = 0, l = 0;
        if (d < q) {
          o = wo[ph(d + a)];
          l = wl[ph(d + a)];
        }
        __syncwarp();
        if (d < q) {
          wo[ph(d)] = o;
          wl[ph(d)] = l;
        }
        __syncwarp();
      }
    }
    hw = min(K, max(hw, q) + a);
    hwmax = max(hwmax, hw);
  }

  // Writes logical row k if it lies in the block.
  __device__ __forceinline__ void put(int k, int o, int l) {
    if (k >= 0 && k < K) {
      wo[ph(k)] = o;
      wl[ph(k)] = l;
    }
  }
  // Rows below k may be non-zero now.
  __device__ __forceinline__ void cover(int k) {
    hw = max(hw, min(k, K));
    hwmax = max(hwmax, hw);
  }

  // Sum of the live lengths of logical rows [0, n).
  __device__ int live_rows_before(int n) const {
    int v = 0;
    for (int k = ln; k < n && k < hw; k += 32)
      v += wo[ph(k)] > 0 ? wl[ph(k)] : 0;
    return warp_sum(v);
  }

  // Live lengths of the window's logical rows [c0, c0 + 32 * kGroup), 32
  // rows a pass (rows at or past hw read 0), and each pass's sum.
  __device__ __forceinline__ void live_group(int c0, int (&lv)[kGroup],
                                             int (&sum)[kGroup],
                                             int (&o)[kGroup],
                                             int (&l)[kGroup]) const {
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int k = c0 + 32 * u + ln;
      o[u] = k < hw ? wo[ph(k)] : 0;
      l[u] = k < hw ? wl[ph(k)] : 0;
      lv[u] = o[u] > 0 ? l[u] : 0;
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) sum[u] = warp_sum(lv[u]);
  }

  // The run holding live char #local of the window's block (r0 rows):
  // the rows whose inclusive live prefix is below local are a prefix of
  // the block, of which the first r0 count. A pass whose sum leaves the
  // prefix below local is skipped whole.
  __device__ void locate_run(int r0, int local, int& i_r, int& excl) const {
    int run = 0, c = -1, at_c = 0;
    for (int c0 = 0; c0 < hw && c < 0; c0 += 32 * kGroup) {
      int lv[kGroup], sum[kGroup], o[kGroup], l[kGroup];
      live_group(c0, lv, sum, o, l);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (c >= 0) break;
        const int k = c0 + 32 * u + ln;
        if (run + sum[u] >= local) {
          const int inc = warp_scan(lv[u]) + run;
          const unsigned m = __ballot_sync(kFull, k < hw && inc >= local);
          if (m != 0) {
            const int f = __ffs(m) - 1;
            c = c0 + 32 * u + f;
            at_c = __shfl_sync(kFull, inc - lv[u], f);
          }
        }
        run += sum[u];
      }
    }
    if (c < 0) {  // rows at or past hw read 0: their prefix is `run`
      c = run >= local ? hw : K;
      at_c = run;
    }
    i_r = min(c, r0);
    if (i_r >= K) {
      excl = 0;  // no such row: the TPU kernel's masked read is 0
    } else {
      excl = i_r == c ? at_c : live_rows_before(i_r);
    }
  }

  template <bool STATS>
  __device__ void do_insert(int p, int il, int st_, int w, int* ol_k,
                            int* or_k) {
    // The slot locate and the run locate feed no output at p == 0: the
    // insert goes to row 0 of slot 0 with origin-left ROOT, and neither
    // splits nor merges. The locate is redone only if a split changed the
    // tables.
    long long c0 = STATS ? clock64() : 0;
    int before = 0;
    int l = p == 0 ? 0 : slot_of_live_rank(p, &before);
    int r0 = rws[l];
    if (STATS) st[4] += clock64() - c0;
    if (r0 + w + 1 > K) {
      split<STATS>(l);
      c0 = STATS ? clock64() : 0;
      l = p == 0 ? 0 : slot_of_live_rank(p, &before);
      r0 = rws[l];
      if (STATS) st[4] += clock64() - c0;
    }
    ensure<STATS>(blkord[l]);

    c0 = STATS ? clock64() : 0;
    int i_r = 0, o_r = 0, l_r = 0, off = 0;
    bool is_split = false;
    if (p > 0) {
      const int local = p - before;
      int excl;
      locate_run(r0, local, i_r, excl);
      o_r = row(wo, i_r);
      l_r = row(wl, i_r);
      off = local - excl;
      is_split = off < l_r;
    }
    const long long c1 = STATS ? clock64() : 0;
    if (STATS) st[5] += c1 - c0;

    // Origins from the PRE-splice state: the run head's left neighbour and
    // the raw successor (tombstones not skipped); past the block's last
    // run, the next slot's first row, from the heads table (distinct slots
    // hold distinct blocks, so it is never the cached one).
    const bool need_peek = p > 0 && !is_split && i_r + 1 >= r0 && l + 1 < nlog;
    const int succ_next = need_peek ? hd[blkord[min(l + 1, NBL - 1)]] : 0;
    const int succ =
        p == 0 ? (r0 > 0 ? row(wo, 0) : 0)
               : (is_split ? o_r + off
                           : (i_r + 1 < r0 ? row(wo, i_r + 1) : succ_next));
    if (ln == 0) {
      const unsigned left =
          p == 0 ? kRoot : (unsigned)(o_r - 1) + (unsigned)(off - 1);
      const unsigned right =
          succ == 0 ? kRoot : (unsigned)((succ < 0 ? -succ : succ) - 1);
      *ol_k = (int)left;
      *or_k = (int)right;
    }

    // Fused W-row splice.
    const int lrun = il / (w > 1 ? w : 1);
    const bool mrg = w == 1 && p > 0 && off == l_r && st_ + 1 == o_r + l_r;
    const int ins_at = p == 0 ? 0 : i_r + 1;
    const int amt = mrg ? 0 : w + (is_split ? 1 : 0);
    shift_up(ins_at, roll_amount(amt, WMAX + 1, K));
    if (!mrg)
      for (int j = ln; j < w; j += 32)
        put(ins_at + j, st_ + il - (j + 1) * lrun + 1, lrun);
    if (ln == 0) {
      if (is_split) {
        put(i_r, o_r, off);
        put(ins_at + w, o_r + off, l_r - off);
      }
      if (mrg) put(i_r, o_r, l_r + il);
      rws[l] += amt;
      liv[l] += il;
    }
    add_from(l, il);
    cover(ins_at + amt);
    if (is_split || mrg) cover(i_r + 1);
    if (STATS) {
      st[2] += need_peek;
      st[6] += clock64() - c1;
    }
  }

  // One boundary split of the delete: run i_p becomes [head?] [tombstone
  // mid] [tail?]. Returns the rows added.
  __device__ int apply_partial(bool active, int i_p) {
    if (!active) return 0;
    const int o = row(wo, i_p), ln_ = row(wl, i_p);
    const int cs_i = sa[i_p], ce_i = sb[i_p];
    const int cov_i = ce_i - cs_i;
    const bool has_head = cs_i > 0, has_tail = ce_i < ln_;
    const int amt = (has_head ? 1 : 0) + (has_tail ? 1 : 0);
    shift_up(i_p + 1, roll_amount(amt, 2, K));
    if (ln == 0) {
      put(i_p, has_head ? o : -(o + cs_i), has_head ? cs_i : cov_i);
      if (amt >= 1)
        put(i_p + 1, has_head ? -(o + cs_i) : o + ce_i,
            has_head ? cov_i : ln_ - ce_i);
      if (amt == 2) put(i_p + 2, o + ce_i, ln_ - ce_i);
    }
    __syncwarp();
    cover(i_p + 1 + amt);
    return amt;
  }

  template <bool STATS>
  __device__ void do_delete(int p, int d) {
    int rem = d, iters = 0;
    // Each iteration clears one block's covered span; > 2*NBL iterations
    // means the delete ran off the document.
    while (rem > 0 && iters <= 2 * NBL) {
      long long c0 = STATS ? clock64() : 0;
      int base;
      int l = slot_of_live_rank(p + 1, &base);
      if (STATS) st[4] += clock64() - c0;
      if (rws[l] + 2 > K) {
        split<STATS>(l);
        c0 = STATS ? clock64() : 0;
        l = slot_of_live_rank(p + 1, &base);
        if (STATS) st[4] += clock64() - c0;
      }
      ensure<STATS>(blkord[l]);
      c0 = STATS ? clock64() : 0;

      // Rows before the covered span and past it cover nothing: a pass
      // that ends before it is skipped whole, and the passes stop after it.
      int run = 0, tot = 0, npart = 0, i1 = K, i2 = -1;
      bool done = false;
      for (int c0r = 0; c0r < hw && !done; c0r += 32 * kGroup) {
        int lv[kGroup], sum[kGroup], o[kGroup], wlk[kGroup];
        live_group(c0r, lv, sum, o, wlk);
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (done) break;
          const int k0 = c0r + 32 * u, k = k0 + ln;
          if (base + run + sum[u] > p) {
            const int inc = warp_scan(lv[u]);
            const int before = base + run + inc - lv[u];
            const int cs = clampi(p - before, 0, lv[u]);
            const int ce = clampi(p + rem - before, 0, lv[u]);
            const int cov = ce - cs;
            const bool full = cov > 0 && cov == wlk[u];
            const bool part = cov > 0 && !full;
            tot += cov;
            if (part) {
              sa[k] = cs;
              sb[k] = ce;
            }
            if (full) wo[ph(k)] = -o[u];
            const unsigned m = __ballot_sync(kFull, part);
            if (m != 0) {
              npart += __popc(m);
              i1 = min(i1, k0 + __ffs(m) - 1);
              i2 = k0 + 31 - __clz(m);
            }
          }
          run += sum[u];
          done = base + run >= p + rem;
        }
      }
      tot = warp_sum(tot);
      __syncwarp();
      // Higher-index boundary first so i1's row index stays valid.
      int added = apply_partial(npart >= 1, i2);
      added += apply_partial(npart == 2, i1);
      if (ln == 0) {
        rws[l] += added;
        liv[l] -= tot;
      }
      add_from(l, -tot);
      rem -= tot;
      ++iters;
      if (STATS) st[7] += clock64() - c0;
    }
    if (rem > 0 && ln == 0) err[B + lane] = 1;  // err row 1
  }

  // Warp 0: the whole step chain of group g.
  template <bool STATS>
  __device__ void chain(const int* __restrict__ pos,
                        const int* __restrict__ dlen,
                        const int* __restrict__ ilen,
                        const int* __restrict__ start,
                        const int* __restrict__ wcol, int* ol, int* orr,
                        size_t base, int S) {
    for (int k0 = 0; k0 < S; k0 += 32) {
      // The op columns, 32 steps at a time (lane u holds step k0 + u).
      const int kk = k0 + ln;
      int rp = 0, rd = 0, ri = 0, rs = 0, rw = 0;
      if (kk < S) {
        rp = pos[base + kk];
        rd = dlen[base + kk];
        ri = ilen[base + kk];
        rs = start[base + kk];
        rw = wcol[base + kk];
      }
      const int n = min(32, S - k0);
      for (int j = 0; j < n; ++j) {
        const int p = __shfl_sync(kFull, rp, j);
        const int d = __shfl_sync(kFull, rd, j);
        const int il = __shfl_sync(kFull, ri, j);
        if (d <= 0 && il <= 0) continue;  // a pad row
        if (STATS) ++st[3];
        if (d > 0) do_delete<STATS>(p, d);
        if (il > 0) {
          const int stv = __shfl_sync(kFull, rs, j);
          const int wc = __shfl_sync(kFull, rw, j);
          const int w = wc > 1 ? wc : 1;  // pads carry 0
          const size_t o = (base + k0 + j) * B + lane;
          do_insert<STATS>(p, il, stv, w, ol + o, orr + o);
        }
      }
    }
  }
};

template <bool STATS>
__global__ void __launch_bounds__(kMaxThreads) rle_replay_kernel(
    const int* __restrict__ pos, const int* __restrict__ dlen,
    const int* __restrict__ ilen, const int* __restrict__ start,
    const int* __restrict__ wcol,  // [G*S] op columns
    int* ol, int* orr,             // [G, S, B] u32 bits
    int* blk_out, int* rows_out,   // [G, NBL, B]
    int* meta_out,                 // [G, 8, B]
    int* err,                      // [8, B], zeroed by the caller
    int* work_o, int* work_l,      // [G, B, CAP] lane-major working planes
    long long* stats,              // [G, B, kStats], or null
    int S, int B, int CAP, int K, int NB, int NBL, int WMAX) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x, g = blockIdx.y;
  Replay R;
  R.t = threadIdx.x;
  R.T = blockDim.x;
  R.ln = R.t & 31;
  R.B = B;
  R.lane = lane;
  R.K = K;
  R.NB = NB;
  R.NBL = NBL;
  R.WMAX = WMAX;
  R.O = work_o + ((size_t)g * B + lane) * CAP;
  R.L = work_l + ((size_t)g * B + lane) * CAP;
  R.wo = smem;
  R.wl = R.wo + K;
  R.sa = R.wl + K;
  R.sb = R.sa + K;
  R.blkord = R.sb + K;
  R.rws = R.blkord + NBL;
  R.liv = R.rws + NBL;
  R.cum = R.liv + NBL;
  R.hd = R.cum + NBL;
  R.job = R.hd + NBL;
  R.red = R.job + 8;
  R.err = err;
  // Fresh group: one empty block in logical slot 0, cached zeroed.
  R.nlog = 1;
  R.cached = 0;
  R.rot = 0;
  R.hw = 0;
  R.hwmax = 0;
  for (int q = 0; q < kStats; ++q) R.st[q] = 0;
  const int t = R.t, T = R.T;
  for (int j = t; j < 4 * K + 5 * NBL + 40; j += T) smem[j] = 0;
  for (int j = t; j < K; j += T) {  // block 0 starts empty in the planes
    R.O[j] = 0;
    R.L[j] = 0;
  }
  __syncthreads();

  if (t < 32) {
    const long long c0 = STATS ? clock64() : 0;
    R.chain<STATS>(pos, dlen, ilen, start, wcol, ol, orr, (size_t)g * S, S);
    if (STATS) R.st[11] = clock64() - c0;
    __syncwarp();
    if (R.ln == 0) {
      R.job[1] = R.cached;
      R.job[2] = R.rot;
      R.job[3] = R.hwmax;
      R.job[4] = R.nlog;
    }
    R.end_jobs();
  } else {
    R.serve();
  }
  __syncthreads();  // every write of warp 0 is visible

  const long long c1 = STATS ? clock64() : 0;
  const int cached = R.job[1], rot = R.job[2], hwm = R.job[3];
  for (int j = t; j < K; j += T) {
    int r = j - rot;
    if (r < 0) r += K;
    if (r < hwm) {
      R.O[cached * K + r] = R.wo[j];
      R.L[cached * K + r] = R.wl[j];
    }
  }
  for (int j = t; j < NBL; j += T) {
    const size_t o = ((size_t)g * NBL + j) * B + lane;
    blk_out[o] = R.blkord[j];
    rows_out[o] = R.rws[j];
  }
  for (int j = t; j < 8; j += T)
    meta_out[((size_t)g * 8 + j) * B + lane] = j == 0 ? R.job[4] : 0;
  if (STATS && t == 0 && stats != nullptr) {
    long long* s = stats + ((size_t)g * B + lane) * kStats;
    for (int q = 0; q < kStats; ++q) s[q] = R.st[q];
    s[10] = clock64() - c1;
    s[11] += s[10];
  }
}

// ordp[g*CAP + r, b] = work[g, b, r] for rows r below lane b's blocks in
// use (nlog * K, from meta), else 0: [B, CAP] -> [CAP, B] per group, 32x32
// tiles through shared memory (blocks of (32, 8) threads over
// (ceil(CAP/32), ceil(B/32), G)). Rows past the blocks in use are never
// read: their working rows were never written.
__global__ void write_out(const int* __restrict__ work,
                          const int* __restrict__ meta, int* __restrict__ out,
                          int B, int CAP, int K) {
  __shared__ int tile[32][33];
  const int g = blockIdx.z;
  const int r0 = blockIdx.x * 32, b0 = blockIdx.y * 32;
  const int* src = work + (size_t)g * B * CAP;
  for (int dy = threadIdx.y; dy < 32; dy += 8) {
    const int b = b0 + dy, r = r0 + threadIdx.x;
    if (b < B && r < CAP) {
      const int used = meta[(size_t)g * 8 * B + b] * K;
      tile[dy][threadIdx.x] = r < used ? src[(size_t)b * CAP + r] : 0;
    }
  }
  __syncthreads();
  for (int dy = threadIdx.y; dy < 32; dy += 8) {
    const int r = r0 + dy, b = b0 + threadIdx.x;
    if (b < B && r < CAP)
      out[((size_t)g * CAP + r) * B + b] = tile[threadIdx.x][dy];
  }
}

}  // namespace

// smem: bytes of the kernel's shared layout, and warps: the thread block's
// warps, from the Python wrapper (ops/rle.py::kernel_smem_bytes, WARPS),
// which also refuses K below 8 and a layout past the shared memory a
// thread block may use. stats may be null.
extern "C" int rle_replay_launch(
    const int* pos, const int* dlen, const int* ilen, const int* start,
    const int* wcol, int* ol, int* orr, int* ordp, int* lenp, int* blk_out,
    int* rows_out, int* meta_out, int* err, int* work_o, int* work_l,
    long long* stats, int G, int S, int B, int CAP, int K, int NB, int NBL,
    int WMAX, int warps, int smem, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (warps < 1 || warps * 32 > kMaxThreads) return (int)cudaErrorInvalidValue;
  auto kern = stats != nullptr ? rle_replay_kernel<true>
                               : rle_replay_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B, G), warps * 32, smem, st>>>(
      pos, dlen, ilen, start, wcol, ol, orr, blk_out, rows_out, meta_out,
      err, work_o, work_l, stats, S, B, CAP, K, NB, NBL, WMAX);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((CAP + 31) / 32, (B + 31) / 32, G), block(32, 8);
  write_out<<<grid, block, 0, st>>>(work_o, meta_out, ordp, B, CAP, K);
  write_out<<<grid, block, 0, st>>>(work_l, meta_out, lenp, B, CAP, K);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
