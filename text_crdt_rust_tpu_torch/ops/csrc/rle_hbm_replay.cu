// Run-block replay with the planes in device memory, a one-block window in
// shared memory and a two-level live index, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// text_crdt_rust_tpu/ops/rle_hbm.py::_rle_hbm_kernel and computes what it
// computes, bit for bit, on every row of every block the replay used. The
// plain PyTorch version of the same function is
// text_crdt_rust_tpu_torch/ops/rle_hbm.py::rle_hbm_replay_plain; the two
// are held against each other on the card.
//
// What it computes. For each doc group g, replay the group's local op
// stream (columns pos, del_len, ins_len, ins_order_start, rows_per_step)
// on RLE run planes ordp = ±(start_order+1), lenp = run length, in blocks
// of K rows ordered by a logical block table (blkord) with per-slot run
// counts (rws), live-char counts (liv) and 64-slot segment sums (supliv).
// Position -> slot descends over supliv, then over one segment of liv,
// clamped to the last segment and the last slot. A delete flips the runs
// it covers and splits at most two boundary runs per block, walking
// blocks; an insert splices w run rows plus at most one split tail; a full
// block splits its top half into a fresh physical block at the next slot
// and supliv is rebuilt. Each insert emits origin_left / origin_right
// (when store is set). err[0] is raised when a split finds the table full
// (the split is skipped and the insert still splices, its rows wrapping by
// the circular roll), err[1] when a delete runs past the end.
//
// Mapping. One thread block per (lane, group); warp 0 runs the whole step
// chain and the other warps of the block (0-15 of them, `warps` from the
// wrapper) sleep at a named barrier until warp 0 asks them to help with a
// pass over a whole block in device memory: the window's write-back and
// reload (`ensure`), a split's copy of its top half into the fresh block
// with the slot tables' shift and the segment sums' rebuild, and the final
// flush. The sequential chunk axis of the TPU grid becomes a loop over all
// steps, the op columns read 32 steps at a time. As on the TPU, one block
// is cached: the window lives in shared memory beside the slot tables and
// supliv, and it is a ring: logical row k sits at physical row (k + rot)
// mod K. A splice that inserts `a` rows at row q moves the shorter side:
// rows [q, hw) up by `a`, or, turning the ring back by `a`, rows [0, q)
// down, so kevin's prepends (q = 0) move no row at all and write only
// their W new rows. hw bounds the window's non-empty rows (every row at or
// past it is 0). Rows are un-rotated whenever they leave shared memory. The
// next-slot peek for a boundary insert's origin reads the planes: distinct
// logical slots hold distinct physical blocks, so the peeked block is
// never the cached one and its rows in the planes are current. The planes
// are the public [G*CAP, B] arrays themselves (no working copy): at
// kevin's 5M prepends they hold 10.75 GB. Every lane replays the same
// stream, so the TPU kernel's lane-max control scalars equal this thread
// block's own.
//
// What bounds it. Not bytes: kevin writes its used blocks once, ~10 GB,
// ~3 ms at 3.35 TB/s. The floor is the serial chain of dependent steps
// (78,125 fused steps at kevin). The design keeps each step in one warp
// (warp scans and ballots over 32 rows at a time, no block-wide barrier),
// computes only what a step's outputs use (an insert at position 0 needs
// no run locate), moves only the shorter side of a splice, and spends
// block-wide barriers only on the passes over whole blocks and tables.

#include <cuda_runtime.h>

#include "block_ops.cuh"
#include "blocked_ops.cuh"

namespace {

using block_ops::kFull;
using block_ops::roll_amount;
using blocked_ops::clampi;
using blocked_ops::Columns;
using blocked_ops::job_barrier;
using blocked_ops::warp_scan;

// Sum over the warp's lanes (one redux.sync).
__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(kFull, v);
}

constexpr unsigned kRoot = 0xffffffffu;  // ROOT_ORDER
constexpr int kSup = 64;                 // slots per super-segment
constexpr int kMaxThreads = 512;
constexpr int kTab = 8;  // table entries a thread moves per round of a shift
constexpr int kGroup = 4;  // 32-row passes whose loads are issued together
constexpr int kJobDone = 0, kJobEnsure = 1, kJobSplit = 2;
// stats[g, lane, :]: splits, window loads, cycles in splits, cycles in all.
constexpr int kStats = 4;

struct Hbm {
  int* ordp;  // this group's planes [CAP, B], row stride B
  int* lenp;
  int* wo;  // shared [K] window ring: ordp / lenp rows of the cached block
  int* wl;
  int* sa;  // shared [K] delete scratch by logical row: cs, ce
  int* sb;
  int* blkord;  // shared [NBL]
  int* rws;
  int* liv;
  int* supliv;  // shared [NSUPp]
  int* job;     // shared [8]: job and its arguments
  int* red;     // shared [32]: results of a job
  int* err;     // [8, B]
  int B, lane, K, NB, NBL, NSUP, WMAX;
  int t, T, ln, warp;
  // Warp 0's chain state.
  int nlog;    // blocks in use
  int cached;  // physical block held by the window
  int rot;     // the window ring's rotation
  int hw;      // every logical window row at or past hw is 0
  int hwmax;   // the largest hw since the window was loaded
  long long splits, loads, split_cycles;

  __device__ size_t at(int b, int r) const {
    return ((size_t)b * K + r) * B + lane;
  }
  // Physical window row of logical row k in [0, K).
  __device__ int ph(int k) const {
    const int j = k + rot;
    return j >= K ? j - K : j;
  }
  // Logical row k of the window; outside the block reads 0, as the TPU
  // kernel's masked sums do.
  __device__ int row(const int* arr, int k) const {
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
  // past hwm are 0 there and in the window), then loads block b at
  // rotation 0; red[0] gets the loaded rows' hw. Rows are read four a
  // thread at a time so that their loads are in flight together.
  __device__ void job_ensure() {
    const int b = job[1], old = job[2], rt = job[3], hwm = job[4];
    for (int j = t; j < K; j += T) {
      int r = j - rt;
      if (r < 0) r += K;
      if (r < hwm) {
        ordp[at(old, r)] = wo[j];
        lenp[at(old, r)] = wl[j];
      }
    }
    int mx = 0;
    for (int j0 = t; j0 < K; j0 += 4 * T) {
      int o[4], l[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * T;
        o[u] = j < K ? ordp[at(b, j)] : 0;
        l[u] = j < K ? lenp[at(b, j)] : 0;
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
  // in use before it): the top half of the window goes to block nb, the
  // window keeps rows [0, keep), slots > l take their predecessor's entry
  // (the TPU kernel's circular roll by one, masked to rows > l; every
  // entry at or past nl is 0, so only [l+2, nl] changes), slot l and l+1
  // take their halves, and the segment sums over the changed slots are
  // rebuilt. red[1] collects the top half's live chars.
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
    // The fresh block's rows past mv are 0 already: no block at or past
    // nlog was ever written.
    for (int k = t; k < mv && k < K; k += T) {
      int s = k + up;
      if (s >= K) s -= K;
      ordp[at(nb, k)] = wo[lph(s)];
      lenp[at(nb, k)] = wl[lph(s)];
    }
    __syncthreads();  // the window's top half is read
    for (int k = keep + t; k < hw0; k += T) {
      wo[lph(k)] = 0;
      wl[lph(k)] = 0;
    }
    for (int top = nl; top >= l + 2; top -= kTab * T) {
      int vb[kTab], vr[kTab], vl[kTab];
#pragma unroll
      for (int u = 0; u < kTab; ++u) {
        const int j = top - t - u * T;
        if (j >= l + 2 && j > top - kTab * T) {
          vb[u] = blkord[j - 1];
          vr[u] = rws[j - 1];
          vl[u] = liv[j - 1];
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
        }
      }
    }
    __syncthreads();
    if (t == 0) {
      const int liv_hi = red[1];
      rws[l] = keep;
      liv[l] -= liv_hi;
      blkord[l + 1] = nb;
      rws[l + 1] = mv;
      liv[l + 1] = liv_hi;
    }
    __syncthreads();
    // Segments [l / kSup, (nl + 1) / kSup] hold every changed slot.
    const int s_hi = min((nl + 1) / kSup, NSUP - 1);
    for (int s = l / kSup + warp; s <= s_hi; s += T >> 5) {
      const int v = warp_sum(liv[s * kSup + ln] + liv[s * kSup + 32 + ln]);
      if (ln == 0) supliv[s] = v;
    }
  }

  // -- descents (warp 0) -----------------------------------------------------

  // Sum of supliv[0, s) (each lane a contiguous run).
  __device__ int sup_before(int s) const {
    const int C = (NSUP + 31) / 32;
    int v = 0;
    for (int i = ln * C; i < ln * C + C && i < s && i < NSUP; ++i)
      v += supliv[i];
    return warp_sum(v);
  }

  // Sum of liv[s*kSup, l) (two slots a lane).
  __device__ int seg_before(int s, int l) const {
    const int i0 = s * kSup + 2 * ln;
    const int v = (i0 < l ? liv[i0] : 0) + (i0 + 1 < l ? liv[i0 + 1] : 0);
    return warp_sum(v);
  }

  __device__ int live_before_slot(int l) const {
    const int s = l / kSup;
    return sup_before(s) + seg_before(s, l);
  }

  // Two-level descent: the smallest super-segment whose inclusive prefix
  // reaches rank1 (clamped to NSUP-1; one segment needs no search), then
  // the slots of that segment whose inclusive prefix stays below what
  // remains (clamped to nlog-1). Returns the slot and, in *before, the
  // live chars before it (live_before_slot).
  __device__ int slot_of_live_rank(int rank1, int* before) const {
    int s = 0, base = 0;
    if (NSUP > 1) {
      const int C = (NSUP + 31) / 32;
      const int lo = ln * C, hi = min(lo + C, NSUP);
      int part = 0;
      for (int i = lo; i < hi; ++i) part += supliv[i];
      int run = warp_scan(part) - part, cnt = 0;
      for (int i = lo; i < hi; ++i) {
        run += supliv[i];
        cnt += run < rank1;
      }
      s = min(warp_sum(cnt), NSUP - 1);
      base = sup_before(s);
    }
    const int i0 = s * kSup + 2 * ln;
    const int a0 = liv[i0], a1 = liv[i0 + 1];
    const int pair = warp_scan(a0 + a1);  // inclusive through slot i0 + 1
    const int c0 = pair - a1;             // inclusive through slot i0
    const int rest = rank1 - base;
    const int within = warp_sum((c0 < rest) + (pair < rest));
    const int l = min(s * kSup + within, nlog - 1);
    const int j = l - s * kSup;
    if (j >= 0 && j < kSup) {
      const int v = __shfl_sync(kFull, (j & 1) ? c0 : pair - a0 - a1, j >> 1);
      *before = base + v;
    } else {
      *before = live_before_slot(l);
    }
    return l;
  }

  // -- the window (warp 0) ---------------------------------------------------

  // Caches physical block b in the window.
  __device__ void ensure(int b) {
    if (b == cached) return;
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
    ++loads;
  }

  // Leaf split of logical slot l into a fresh physical block at slot l+1.
  __device__ void split(int l) {
    if (nlog >= NB) {
      if (ln == 0) err[lane] = 1;  // err row 0
      return;
    }
    const long long c0 = clock64();
    ensure(blkord[l]);
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
    ++splits;
    split_cycles += clock64() - c0;
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
  __device__ void put(int k, int o, int l) {
    if (k >= 0 && k < K) {
      wo[ph(k)] = o;
      wl[ph(k)] = l;
    }
  }
  // Rows below k may be non-zero now.
  __device__ void cover(int k) {
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
  __device__ void live_group(int c0, int (&lv)[kGroup], int (&sum)[kGroup],
                             int (&o)[kGroup], int (&l)[kGroup]) const {
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int k = c0 + 32 * u + ln;
      o[u] = k < hw ? wo[ph(k)] : 0;
      l[u] = k < hw ? wl[ph(k)] : 0;
      lv[u] = o[u] > 0 ? l[u] : 0;
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) sum[u] = __reduce_add_sync(kFull, lv[u]);
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

  __device__ void do_insert(int p, int il, int st, int w, int* ol_k,
                            int* or_k) {
    // The descent and the run locate feed no output at p == 0: the insert
    // goes to row 0 of slot 0 with origin-left ROOT, and neither splits
    // nor merges. The descent is redone only if a split changed the
    // tables.
    int before = 0;
    int l = p == 0 ? 0 : slot_of_live_rank(p, &before);
    int r0 = rws[l];
    if (r0 + w + 1 > K) {
      split(l);
      l = p == 0 ? 0 : slot_of_live_rank(p, &before);
      r0 = rws[l];
    }
    ensure(blkord[l]);

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

    // Origins from the PRE-splice state: the run head's left neighbour and
    // the raw successor (tombstones not skipped); past the block's last
    // run, the next slot's first row, read from the planes.
    if (ol_k != nullptr) {
      const bool need_peek =
          p > 0 && !is_split && i_r + 1 >= r0 && l + 1 < nlog;
      int succ_next = 0;
      if (need_peek) succ_next = ordp[at(blkord[min(l + 1, NBL - 1)], 0)];
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
    }

    // Fused W-row splice.
    const int lrun = il / (w > 1 ? w : 1);
    const bool mrg = w == 1 && p > 0 && off == l_r && st + 1 == o_r + l_r;
    const int ins_at = p == 0 ? 0 : i_r + 1;
    const int amt = mrg ? 0 : w + (is_split ? 1 : 0);
    shift_up(ins_at, roll_amount(amt, WMAX + 1, K));
    if (!mrg)
      for (int j = ln; j < w; j += 32)
        put(ins_at + j, st + il - (j + 1) * lrun + 1, lrun);
    if (ln == 0) {
      if (is_split) {
        put(i_r, o_r, off);
        put(ins_at + w, o_r + off, l_r - off);
      }
      if (mrg) put(i_r, o_r, l_r + il);
      rws[l] += amt;
      liv[l] += il;
      supliv[l / kSup] += il;
    }
    __syncwarp();
    cover(ins_at + amt);
    if (is_split || mrg) cover(i_r + 1);
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

  __device__ void do_delete(int p, int d) {
    int rem = d, iters = 0;
    // Each iteration clears one block's covered span; > 2*NBL iterations
    // means the delete ran off the document.
    while (rem > 0 && iters <= 2 * NBL) {
      int base;
      int l = slot_of_live_rank(p + 1, &base);
      if (rws[l] + 2 > K) {
        split(l);
        l = slot_of_live_rank(p + 1, &base);
      }
      ensure(blkord[l]);

      // Rows before the covered span and past it cover nothing: a pass
      // that ends before it is skipped whole, and the passes stop after it.
      int run = 0, tot = 0, npart = 0, i1 = K, i2 = -1;
      bool done = false;
      for (int c0 = 0; c0 < hw && !done; c0 += 32 * kGroup) {
        int lv[kGroup], sum[kGroup], o[kGroup], wlk[kGroup];
        live_group(c0, lv, sum, o, wlk);
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (done) break;
          const int k0 = c0 + 32 * u, k = k0 + ln;
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
        supliv[l / kSup] -= tot;
      }
      __syncwarp();
      rem -= tot;
      ++iters;
    }
    if (rem > 0 && ln == 0) err[B + lane] = 1;  // err row 1
  }
};

__global__ void __launch_bounds__(kMaxThreads) rle_hbm_replay_kernel(
    const int* __restrict__ pos, const int* __restrict__ dlen,
    const int* __restrict__ ilen, const int* __restrict__ start,
    const int* __restrict__ wcol,  // [G*S] op columns
    int* ol, int* orr,             // [G, S, B] u32 bits (unused if !store)
    int* ordp, int* lenp,          // [G*CAP, B], zeroed by the caller
    int* blk_out, int* rows_out,   // [G, NBL, B]
    int* meta_out,                 // [G, 8, B]
    int* err,                      // [8, B], zeroed by the caller
    long long* stats,              // [G, B, kStats], or null
    int S, int B, int CAP, int K, int NB, int NBL, int NSUP, int WMAX,
    int store) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x, g = blockIdx.y;
  const int NSUPp = NSUP > 8 ? NSUP : 8;
  Hbm H;
  H.t = threadIdx.x;
  H.T = blockDim.x;
  H.ln = H.t & 31;
  H.warp = H.t >> 5;
  H.B = B;
  H.lane = lane;
  H.K = K;
  H.NB = NB;
  H.NBL = NBL;
  H.NSUP = NSUP;
  H.WMAX = WMAX;
  H.ordp = ordp + (size_t)g * CAP * B;
  H.lenp = lenp + (size_t)g * CAP * B;
  H.wo = smem;
  H.wl = H.wo + K;
  H.sa = H.wl + K;
  H.sb = H.sa + K;
  H.blkord = H.sb + K;
  H.rws = H.blkord + NBL;
  H.liv = H.rws + NBL;
  H.supliv = H.liv + NBL;
  H.job = H.supliv + NSUPp;
  H.red = H.job + 8;
  H.err = err;
  // Fresh group: one empty block in logical slot 0, cached zeroed.
  H.nlog = 1;
  H.cached = 0;
  H.rot = 0;
  H.hw = 0;
  H.hwmax = 0;
  H.splits = H.loads = H.split_cycles = 0;
  const int t = H.t, T = H.T;
  for (int j = t; j < 4 * K + 3 * NBL + NSUPp + 40; j += T) smem[j] = 0;
  __syncthreads();

  if (H.warp == 0) {
    const long long c0 = clock64();
    const size_t base = (size_t)g * S;
    Columns<5> cols{{pos, dlen, ilen, start, wcol}};
    for (int k0 = 0; k0 < S; k0 += 32) {
      cols.load(k0, S, base);
      const int n = min(32, S - k0);
      for (int j = 0; j < n; ++j) {
        const int p = cols.get(0, j), d = cols.get(1, j);
        const int il = cols.get(2, j), st = cols.get(3, j);
        const int wc = cols.get(4, j);
        if (d > 0) H.do_delete(p, d);
        if (il > 0) {
          const int w = wc > 1 ? wc : 1;  // pads carry 0
          const size_t o = (base + k0 + j) * B + lane;
          H.do_insert(p, il, st, w, store ? ol + o : nullptr,
                      store ? orr + o : nullptr);
        }
      }
    }
    if (stats != nullptr && H.ln == 0) {
      long long* s = stats + ((size_t)g * B + lane) * kStats;
      s[0] = H.splits;
      s[1] = H.loads;
      s[2] = H.split_cycles;
      s[3] = clock64() - c0;
    }
    __syncwarp();
    if (H.ln == 0) {
      H.job[1] = H.cached;
      H.job[2] = H.rot;
      H.job[3] = H.hwmax;
      H.job[4] = H.nlog;
    }
    H.end_jobs();
  } else {
    H.serve();
  }
  __syncthreads();  // every write of warp 0 is visible

  const int cached = H.job[1], rot = H.job[2], hwm = H.job[3];
  for (int j = t; j < K; j += T) {
    int r = j - rot;
    if (r < 0) r += K;
    if (r < hwm) {
      H.ordp[H.at(cached, r)] = H.wo[j];
      H.lenp[H.at(cached, r)] = H.wl[j];
    }
  }
  for (int j = t; j < NBL; j += T) {
    const size_t o = ((size_t)g * NBL + j) * B + lane;
    blk_out[o] = H.blkord[j];
    rows_out[o] = H.rws[j];
  }
  for (int j = t; j < 8; j += T)
    meta_out[((size_t)g * 8 + j) * B + lane] = j == 0 ? H.job[4] : 0;
}

}  // namespace

extern "C" int rle_hbm_replay_launch(
    const int* pos, const int* dlen, const int* ilen, const int* start,
    const int* wcol, int* ol, int* orr, int* ordp, int* lenp, int* blk_out,
    int* rows_out, int* meta_out, int* err, long long* stats, int G, int S,
    int B, int CAP, int K, int NB, int NBL, int NSUP, int WMAX, int store,
    int warps, int smem, void* stream) {
  // smem: bytes of the kernel's shared layout, and warps: the thread
  // block's warps, from the Python wrapper (ops/rle_hbm.py::
  // kernel_smem_bytes, WARPS), which also refuses K below 8 and a layout
  // past the shared memory a thread block may use.
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rle_hbm_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  rle_hbm_replay_kernel<<<dim3(B, G), warps * 32, smem,
                          (cudaStream_t)stream>>>(
      pos, dlen, ilen, start, wcol, ol, orr, ordp, lenp, blk_out, rows_out,
      meta_out, err, stats, S, B, CAP, K, NB, NBL, NSUP, WMAX, store);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
