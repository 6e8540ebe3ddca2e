// Mixed local/remote op replay on RLE run blocks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// text_crdt_rust_tpu/ops/rle_mixed.py::_mixed_rle_kernel and computes what
// it computes, bit for bit, on all eight outputs. The plain PyTorch version
// of the same function is
// text_crdt_rust_tpu_torch/ops/rle_mixed.py::rle_mixed_replay_plain; the two
// are held against each other on the card. Each function below carries the
// name of its counterpart in both.
//
// What it computes. One shared op stream (kind LOCAL, REMOTE_INS or
// REMOTE_DEL) is replayed on the RLE run planes of B identical documents:
// ordp = ±(start_order+1) and lenp = run length, in blocks of K rows, ordered
// by logical slot tables (blkord, rws, live/raw counts liv/raw and their
// inclusive prefixes cumliv/cumraw). An order -> block hint table (ordblk)
// is verified on every lookup, with a full-plane search on a miss, and then
// healed. By-order tables oll/orl are mutable, rkl is read-only. Three aux
// planes hold each run head's origin-left (olp), origin-right (orp) and
// rank (rkp). Remote inserts integrate by the vectorised YATA scan
// (integrate_fast); when its flag rises the exact serial run-walk
// (integrate_cursor) decides. Remote deletes are one-pass interval
// tombstones with at most two endpoint splits. Local edits follow ops/rle
// plus upkeep of raw counts, index and tables. err row 0 means block
// capacity, row 1 a bad delete, row 2 an order-index miss.
//
// Mapping. One thread block per lane; warp 0 runs the whole step chain:
// every control scalar (slot sums, descents, the physical -> logical
// lookup, the delete's per-slot fix-up) is a warp scan or ballot over the
// slot tables in shared memory, computed once per step, and every block op
// is a pass of 32 rows at a time. The other warps sleep at a named barrier
// and wake only for the passes over many rows: a hint miss's search and the
// remote delete's flip over the allocated blocks, and the fast scan's
// window, a block a warp. The five planes a splice moves sit in shared
// memory when they fit (both config-4 storms), else the run planes (ordp,
// lenp) alone, else none; the rest live in lane-major device memory, as
// do the lane-private order tables, and the read-only rkl is shared by
// all lanes. The plain version
// keeps a fourth aux plane, each physical row's logical slot (lpp), for the
// fast scan's doc-order keys; every row of an allocated block holds its
// block's slot there, so the kernel reads the key of a row of slot l as
// l*K + row and needs no such plane. The fast scan then visits only the
// blocks of the window, blkord[l0..lT]: each warp classifies the rows of
// one block once and summarises its siblings, and warp 0 joins the
// summaries in key order into the first breaking sibling, the last
// lower-ranked one and the first higher-ranked different-o_right one,
// stopping at the first block holding a row that defeats the scan. Every
// lane replays the same stream, so the TPU kernel's lane-max control
// scalars equal this block's own.
//
// What bounds it. Not bytes: one storm replay must move ~14-16 MB of inputs
// and outputs at 128 lanes, ~0.005 ms at 3.35 TB/s. The floor is the serial
// chain of 3,200-3,791 dependent steps. The design keeps each step in one
// warp, with block-wide barriers only around the passes over many rows,
// and the planes in shared memory, so that a step's device-memory reads
// are the order tables' (hints, origins, ranks): a few round trips to the
// L2.

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

constexpr int kLocal = 0, kRemoteIns = 1, kRemoteDel = 2;
constexpr int kRoot = -1;  // ROOT_ORDER as int32
constexpr int kMaxThreads = 512;
constexpr int kJobDone = 0, kJobSearch = 1, kJobFlip = 2, kJobScan = 3;
constexpr int kMoved = 5;   // the planes a splice moves together
constexpr int kGroup = 4;   // 32-row passes whose loads are issued together
// stats[lane, :]: order lookups, hint misses, fast scans, window blocks
// (summed over the scans), the most blocks of one window, serial walks,
// cycles in the fast scans' window passes, in order lookups, in splices,
// in the whole chain (clock64).
constexpr int kStats = 10;

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }

struct Mixed {
  int* P[kMoved];  // this lane's planes [CAP], shared or device memory:
                   // O, L, OLP, ORP, RKP
  int* ordblk;     // this lane's order -> block hints [OTL]
  int* oll;        // this lane's origin-left by order [OTL]
  int* orl;        // this lane's origin-right by order [OTL]
  const int* rkl;  // rank by order [OTL], read-only, shared
  int* blkord;     // shared [NBL]; rws, liv, raw, cumliv, cumraw follow
  int* rws;
  int* liv;
  int* raw;
  int* cumliv;
  int* cumraw;
  int* s_x;    // shared [K] delete scratch by row: cs, ce
  int* s_y;
  int* s_blk;  // shared [NB] per-block flipped chars
  int* job;    // shared [8]: job and its arguments
  int* red;    // shared [32]: results of a job
  int* err;    // [8, B]
  int* ol;     // [S, B]
  int* orr;
  int B, lane, K, NB, NBL, CAP, OTL, t, T, ln, warp;
  bool fast;
  int nlog;  // logical blocks in use (warp 0)
  long long st[kStats];

  __device__ int* O() const { return P[0]; }
  __device__ int* L() const { return P[1]; }

  __device__ void flag_err(int row) const {
    if (ln == 0) err[row * B + lane] = 1;
  }

  // Value of a shared table at slot l; outside reads 0, as the TPU
  // kernel's masked sums do.
  __device__ int slot(const int* tbl, int l) const {
    return (l >= 0 && l < NBL) ? tbl[l] : 0;
  }
  // Row r of block b of plane p; outside the block reads 0.
  __device__ int row(const int* p, int b, int r) const {
    return (r >= 0 && r < K) ? p[b * K + r] : 0;
  }
  __device__ int tab(const int* tb, int o) const {
    return tb[clampi(o, 0, OTL - 1)];
  }

  // -- helper warps ----------------------------------------------------------

  __device__ void run_job(int j) {  // warp 0: every warp runs job j
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
    if (job[0] == kJobSearch) job_search();
    if (job[0] == kJobFlip) job_flip();
    if (job[0] == kJobScan) job_scan();
  }

  // The first row of the allocated blocks holding order job[1] (red[0],
  // preset to CAP - 1) and whether any does (red[1]): rows of blocks at or
  // past nlog are empty and hold none.
  __device__ void job_search() {
    const int o = job[1], n = job[2];
    const int* O_ = O();
    const int* L_ = L();
    int g = CAP - 1, any = 0;
    for (int j = t; j < n; j += T) {
      const int bo = O_[j];
      const int so = iabs(bo) - 1;
      if (bo != 0 && so <= o && o < so + L_[j]) {
        g = min(g, j);
        any = 1;
      }
    }
    for (int s = 16; s > 0; s >>= 1) {
      g = min(g, __shfl_xor_sync(kFull, g, s));
      any |= __shfl_xor_sync(kFull, any, s);
    }
    if (ln == 0) {
      atomicMin(&red[0], g);
      if (any) atomicMax(&red[1], 1);
    }
  }

  // The remote delete's one pass: flip every live run the order interval
  // [job[1], job[1] + job[2]) covers in full, count its chars per block
  // (s_blk, zeroed by warp 0) and every covered char (red[0]).
  __device__ void job_flip() {
    const int tg = job[1], dlen = job[2], n = job[3];
    int* O_ = O();
    const int* L_ = L();
    int tot = 0;
    for (int j = t; j < n; j += T) {
      const int o = O_[j];
      if (o == 0) continue;
      const int bl = L_[j], so = iabs(o) - 1;
      const int cs = min(max(tg - so, 0), bl);
      const int ce = min(max(tg + dlen - so, 0), bl);
      const int cov = ce - cs;
      tot += cov;
      if (o > 0 && cov > 0 && cov == bl) {  // a full cover of a live run
        O_[j] = -o;
        atomicAdd(&s_blk[j / K], bl);
      }
    }
    tot = warp_sum(tot);
    if (ln == 0 && tot != 0) atomicAdd(&red[0], tot);
  }

  // -- slot plumbing (warp 0) --------------------------------------------

  __device__ int sum_before_slot(const int* tbl, int l) const {
    const int n = min(l, NBL);
    int s = 0;
    for (int j = ln; j < n; j += 32) s += tbl[j];
    return warp_sum(s);
  }
  __device__ int total_of(const int* cum) const { return slot(cum, nlog - 1); }
  // Smallest logical slot whose inclusive prefix reaches rank1.
  __device__ int slot_of_cum(const int* cum, int rank1) const {
    const int n = min(nlog, NBL);
    int c = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + ln;
      c += __popc(__ballot_sync(kFull, j < n && cum[j] < rank1));
    }
    return min(c, nlog - 1);
  }
  // The last logical slot in use holding physical block b, else 0.
  __device__ int logical_of_physical(int b) const {
    const int n = min(nlog, NBL);
    int l = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + ln;
      const unsigned m = __ballot_sync(kFull, j < n && blkord[j] == b);
      if (m != 0) l = j0 + 31 - __clz(m);
    }
    return l;
  }
  // Table upkeep after an insert or delete in slot l. The prefixes of
  // slots at or past nlog are stale and never read (a split moves the
  // entry of slot nlog - 1 up, never a stale one), so they are not kept.
  __device__ void grow_slot(int l, int amt, int dliv, int draw) {
    __syncwarp();
    if (ln == 0) {
      rws[l] += amt;
      liv[l] += dliv;
      raw[l] += draw;
    }
    for (int j = l + ln; j < nlog; j += 32) {
      cumliv[j] += dliv;
      cumraw[j] += draw;
    }
    __syncwarp();
  }

  // Leaf split (split): the top half of slot l's rows moves to a fresh
  // physical block spliced in at slot l+1. At table capacity it is a no-op
  // that raises err[0].
  __device__ void split(int l) {
    if (nlog >= NB) {
      flag_err(0);
      return;
    }
    const int b = slot(blkord, l), r = slot(rws, l);
    const int keep = r / 2, mv = r - keep, nb = nlog;
    const int liv_l = slot(liv, l), raw_l = slot(raw, l);
    const int* O_ = O();
    const int* L_ = L();
    int lh = 0, rh = 0;
    for (int k = max(keep, 0) + ln; k < r && k < K; k += 32) {
      const int bl = L_[b * K + k];
      rh += bl;
      if (O_[b * K + k] > 0) lh += bl;
    }
    const int liv_hi = warp_sum(lh), raw_hi = warp_sum(rh);
    const int up = roll_amount(keep, K, K);
    // The fresh block's rows past mv are 0 already: no block at or past
    // nlog was ever written.
    for (int k = ln; k < mv && k < K; k += 32) {
      int s = k + up;
      if (s >= K) s -= K;
      int v[kMoved];
#pragma unroll
      for (int q = 0; q < kMoved; ++q) v[q] = P[q][b * K + s];
#pragma unroll
      for (int q = 0; q < kMoved; ++q) P[q][nb * K + k] = v[q];
    }
    __syncwarp();  // every row of block b is read
    for (int k = max(keep, 0) + ln; k < K; k += 32)
#pragma unroll
      for (int q = 0; q < kMoved; ++q) P[q][b * K + k] = 0;
    // Slots > l take their predecessor's entry; every table entry at or
    // past nlog is 0 or stale, so [l + 1, nlog] is what changes.
    for (int hi = nlog; hi >= l + 1; hi -= 32) {
      const int j = hi - ln;
      const bool act = j >= l + 1;
      int v[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) v[q] = act ? blkord[q * NBL + j - 1] : 0;
      __syncwarp();
      if (act)
#pragma unroll
        for (int q = 0; q < 6; ++q) blkord[q * NBL + j] = v[q];
      __syncwarp();
    }
    if (ln == 0) {
      rws[l] = keep;
      liv[l] = liv_l - liv_hi;
      raw[l] = raw_l - raw_hi;
      cumliv[l] -= liv_hi;
      cumraw[l] -= raw_hi;
      blkord[l + 1] = nb;
      rws[l + 1] = mv;
      liv[l + 1] = liv_hi;
      raw[l + 1] = raw_hi;
    }
    __syncwarp();
    nlog += 1;
  }

  // -- order -> run lookup ----------------------------------------------

  // Row of the run containing order o in block b (find_in_block); K if none.
  __device__ int find_in_block(int b, int o) const {
    const int* O_ = O();
    const int* L_ = L();
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + ln;
      bool hit = false;
      if (k < K) {
        const int bo = O_[b * K + k];
        const int so = iabs(bo) - 1;
        hit = bo != 0 && so <= o && o < so + L_[b * K + k];
      }
      const unsigned m = __ballot_sync(kFull, hit);
      if (m != 0) return k0 + __ffs(m) - 1;
    }
    return K;
  }

  // (block, row) of the run containing order o (locate_order): the ordblk
  // hint, verified; else one search of the allocated blocks; then the hint
  // heals. A negative o looks up order 0 and neither raises the miss flag
  // nor heals.
  __device__ void locate_order(int o_in, int& b, int& r) {
    const long long c0 = clock64();
    const int o = max(o_in, 0);
    const int bh = clampi(tab(ordblk, o), 0, NB - 1);
    r = find_in_block(bh, o);
    ++st[0];
    if (r < K) {
      b = bh;
    } else {
      ++st[1];
      __syncwarp();
      if (ln == 0) {
        job[1] = o;
        job[2] = nlog * K;
        red[0] = CAP - 1;
        red[1] = 0;
      }
      run_job(kJobSearch);
      const int g = red[0];
      if (red[1] == 0 && o_in >= 0) flag_err(2);
      b = g / K;
      r = g % K;
    }
    __syncwarp();
    if (ln == 0 && o_in >= 0 && o < OTL) ordblk[o] = b;
    __syncwarp();
    st[7] += clock64() - c0;
  }

  // RAW document position of the char with order o (pos_of_order).
  __device__ int pos_of_order(int o) {
    int b, r;
    locate_order(o, b, r);
    const int l = logical_of_physical(b);
    int rb = 0;
    for (int k = ln; k < r; k += 32) rb += L()[b * K + k];
    const int raw_before = warp_sum(rb);
    const int so_row = iabs(row(O(), b, r)) - 1;
    return sum_before_slot(raw, l) + raw_before + (o - so_row);
  }

  __device__ int cursor_after(int o) {
    return o == kRoot ? 0 : pos_of_order(o) + 1;
  }

  // The run of block b (r0 rows) holding char #local: the rows whose
  // inclusive prefix of lengths (live ones only when `live`) is below
  // local (`le`: at most local) are a prefix of the block, of which the
  // first r0 count. Returns that count and, in excl, the prefix before it.
  __device__ int locate(int b, int r0, int local, bool live, bool le,
                        int& excl) const {
    const int* O_ = O();
    const int* L_ = L();
    int run = 0, c = K, at_c = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + ln;
      int v = 0;
      if (k < K) {
        v = L_[b * K + k];
        if (live && O_[b * K + k] <= 0) v = 0;
      }
      const int inc = warp_scan(v) + run;
      const bool stop = k < K && (le ? inc > local : inc >= local);
      const unsigned m = __ballot_sync(kFull, stop);
      if (m != 0) {
        const int f = __ffs(m) - 1;
        c = k0 + f;
        at_c = __shfl_sync(kFull, inc - v, f);
        break;
      }
      run = __shfl_sync(kFull, inc, 31);
    }
    const int i_r = min(c, r0);
    if (i_r >= K) {
      excl = 0;  // no such row: the TPU kernel's masked read is 0
    } else if (i_r == c) {
      excl = at_c;
    } else {
      int s = 0;
      for (int k = ln; k < i_r; k += 32) {
        const int v = L_[b * K + k];
        s += (live && O_[b * K + k] <= 0) ? 0 : v;
      }
      excl = warp_sum(s);
    }
    return i_r;
  }

  // The run holding RAW position c (run_at2): slot, block, row, signed
  // start order, length and 0-based char offset.
  __device__ void run_at2(int c, int& l, int& b, int& i_r, int& o_r,
                          int& l_r, int& off) const {
    l = slot_of_cum(cumraw, c + 1);
    b = slot(blkord, l);
    const int r0 = slot(rws, l);
    const int local = c - sum_before_slot(raw, l);
    int excl;
    i_r = locate(b, r0, local, false, true, excl);
    o_r = row(O(), b, i_r);
    l_r = row(L(), b, i_r);
    off = local - excl;
  }

  // -- inserts --------------------------------------------------------------

  // Rows [q, K) of block b's moved planes shift up by a (row k >= q + a
  // takes row k - a, the top a rows drop off), as the TPU kernel's circular
  // roll of rows >= q does; every caller overwrites rows [q, q + a) next.
  // Groups of four 32-row passes, top down, each read before it is
  // written.
  __device__ void shift_rows(int b, int q, int a) {
    __syncwarp();  // earlier reads of the block are done
    if (a <= 0) return;
    for (int hi = K - a; hi > q; hi -= 32 * kGroup) {
      int v[kGroup][kMoved];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int s = hi - 1 - ln - 32 * u;
#pragma unroll
        for (int qq = 0; qq < kMoved; ++qq)
          v[u][qq] = s >= q ? P[qq][b * K + s] : 0;
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int s = hi - 1 - ln - 32 * u;
        if (s >= q)
#pragma unroll
          for (int qq = 0; qq < kMoved; ++qq) P[qq][b * K + s + a] = v[u][qq];
      }
      __syncwarp();
    }
  }

  __device__ void put(int b, int k, int o, int l, int ol_, int or_,
                      int rk) {
    if (k >= 0 && k < K) {
      P[0][b * K + k] = o;
      P[1][b * K + k] = l;
      P[2][b * K + k] = ol_;
      P[3][b * K + k] = or_;
      P[4][b * K + k] = rk;
    }
  }

  // The insert splice of block b (_insert_splice / _insert_splice_raw) and
  // its mirror on the aux planes (aux_splice): rows >= ins_at shift down by
  // amt, the new run takes the op's (origin-left, origin-right, rank), a
  // split tail chains to its predecessor char and reads its true
  // origin-right from orl.
  __device__ void splice(int b, bool at_head, int i_r, int l_r, int off,
                         int il, int st_, bool mrg, bool is_split,
                         int tail_o, int tail_ol, int new_ol, int new_or,
                         int new_rk) {
    const long long c0 = clock64();
    const int ins_at = at_head ? 0 : i_r + 1;
    const int amt = mrg ? 0 : (is_split ? 2 : 1);
    const int t_rk = is_split ? row(P[4], b, i_r) : 0;
    const int t_or = is_split ? tab(orl, tail_ol + 1) : 0;
    shift_rows(b, ins_at, roll_amount(amt, 2, K));
    if (ln == 0) {
      if (is_split && i_r >= 0 && i_r < K) P[1][b * K + i_r] = off;
      if (!mrg) put(b, ins_at, st_ + 1, il, new_ol, new_or, new_rk);
      if (is_split) put(b, ins_at + 1, tail_o, l_r - off, tail_ol, t_or, t_rk);
      if (mrg && i_r >= 0 && i_r < K) P[1][b * K + i_r] = l_r + il;
    }
    __syncwarp();
    st[8] += clock64() - c0;
  }

  // Index and origin-table upkeep plus the op's origins (record_insert).
  __device__ void record_insert(int k, int b, int st_, int il, int left,
                                int right) {
    for (int j = ln; j < il; j += 32) {
      if (st_ + j < OTL) {
        ordblk[st_ + j] = b;
        orl[st_ + j] = right;
      }
    }
    if (ln == 0) {
      if (st_ < OTL) oll[st_] = left;
      ol[(size_t)k * B + lane] = left;
      orr[(size_t)k * B + lane] = right;
    }
    __syncwarp();
  }

  // do_local_insert: an il-char run after LIVE rank p.
  __device__ void do_local_insert(int k, int p, int il, int st_) {
    int l = p == 0 ? 0 : slot_of_cum(cumliv, p);
    if (slot(rws, l) + 2 > K) split(l);
    l = p == 0 ? 0 : slot_of_cum(cumliv, p);
    const int r0 = slot(rws, l);
    const int b = slot(blkord, l);
    // _locate_run: the run holding live char #local (1-based). At p == 0
    // the run feeds no output: the insert goes to row 0 with origin-left
    // ROOT, and neither splits nor merges.
    int i_r = 0, o_r = 0, l_r = 0, off = 0;
    if (p > 0) {
      const int local = p - sum_before_slot(liv, l);
      int excl;
      i_r = locate(b, r0, local, true, false, excl);
      o_r = row(O(), b, i_r);
      l_r = row(L(), b, i_r);
      off = local - excl;
    }
    const bool mrg = p > 0 && off == l_r && st_ + 1 == o_r + l_r;
    const bool is_split = p > 0 && off < l_r;
    const int left = p == 0 ? kRoot : (o_r - 1) + (off - 1);
    // Raw successor (tombstones not skipped), from the PRE-splice block.
    int succ;
    if (p == 0) {
      succ = r0 > 0 ? row(O(), b, 0) : 0;
    } else if (is_split) {
      succ = o_r + off;
    } else if (i_r + 1 < r0) {
      succ = row(O(), b, i_r + 1);
    } else if (l + 1 < nlog) {
      succ = O()[slot(blkord, min(l + 1, NBL - 1)) * K];
    } else {
      succ = 0;
    }
    const int right = succ == 0 ? kRoot : iabs(succ) - 1;
    splice(b, p == 0, i_r, l_r, off, il, st_, mrg, is_split, o_r + off,
           (iabs(o_r) - 1) + off - 1, left, right, tab(rkl, st_));
    grow_slot(l, mrg ? 0 : (is_split ? 2 : 1), il, il);
    record_insert(k, b, st_, il, left, right);
  }

  // One block's share of the fast YATA scan (a warp's part of job_scan):
  // the rows [r_lo, r_hi) of physical block b, in order. A row is a direct
  // sibling (S) when its origin-left is the op's, else it must be a
  // physically chained piece; anything else (and a sibling of equal rank
  // or poisoned origin-right) defeats the scan. Returns the block's
  // summary packed in two ints, rows as indices in [0, K] (K: none) in
  // 16 bits each (a block's 2 K ints of delete scratch keep K below
  // 29,100 where they fit a thread block): a = fb | lt << 16, or -1 when
  // the scan is defeated, g = ga | g0 << 16, where fb is the first
  // breaking sibling (rank > mine, same o_right), lt the last lower-ranked
  // sibling before it, ga the first higher-ranked different-o_right
  // sibling after lt and before fb, g0 the first such sibling before fb.
  __device__ void scan_block(int b, int r_lo, int r_hi, int o_left,
                             int o_right, int my_rank, int& a, int& g) const {
    const int* O_ = O();
    const int* L_ = L();
    int fb = K, lt = K, ga = K, g0 = K;
    bool bad = false;
    for (int g0r = r_lo & ~31; g0r < r_hi && !bad; g0r += 32 * kGroup) {
      int o[kGroup], h[kGroup], olv[kGroup], orv[kGroup], rk[kGroup];
      int ep[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int k = g0r + 32 * u + ln;
        const bool in = k >= r_lo && k < r_hi;
        const int j = b * K + k;
        o[u] = in ? O_[j] : 0;
        h[u] = iabs(o[u]) - 1;
        olv[u] = o[u] != 0 ? P[2][j] : 0;
        orv[u] = o[u] != 0 ? P[3][j] : 0;
        rk[u] = o[u] != 0 ? P[4][j] : 0;
        ep[u] = (o[u] != 0 && k > 0) ? iabs(O_[j - 1]) - 1 + L_[j - 1] - 1
                                     : 0;
      }
      bool b_ = false;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int k = g0r + 32 * u + ln;
        const bool W = o[u] != 0;
        const bool S = W && olv[u] == o_left;
        const bool chain = W && !S && h[u] > 0 && olv[u] == h[u] - 1 &&
                           k > 0 && ep[u] == h[u] - 1;
        b_ = b_ || (W && !S && !chain) ||
             (S && (rk[u] == my_rank || orv[u] == -2));
      }
      bad = __ballot_sync(kFull, b_) != 0;
      if (bad || fb < K) continue;
      unsigned mfb[kGroup], mlt[kGroup], mgn[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const bool S = o[u] != 0 && olv[u] == o_left;
        const bool gt = rk[u] > my_rank;
        mfb[u] = __ballot_sync(kFull, S && gt && orv[u] == o_right);
        mlt[u] = __ballot_sync(kFull, S && !gt);
        mgn[u] = __ballot_sync(kFull, S && gt && orv[u] != o_right);
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int k0 = g0r + 32 * u;
        if (fb < K) break;
        unsigned lim = kFull;
        if (mfb[u] != 0) {
          const int f = __ffs(mfb[u]) - 1;
          fb = k0 + f;
          lim = (1u << f) - 1;
        }
        const unsigned lt_m = mlt[u] & lim, gn = mgn[u] & lim;
        if (g0 == K && gn != 0) g0 = k0 + __ffs(gn) - 1;
        if (lt_m != 0) {
          const int last = 31 - __clz(lt_m);
          lt = k0 + last;
          const unsigned after = last == 31 ? 0u : gn & ~((2u << last) - 1);
          ga = after != 0 ? k0 + __ffs(after) - 1 : K;
        } else if (ga == K && gn != 0) {
          ga = k0 + __ffs(gn) - 1;
        }
      }
    }
    a = bad ? -1 : fb | (lt << 16);
    g = ga | (g0 << 16);
  }

  // Every warp summarises one block of the window: warp w the slot
  // job[1] + w when it is at most job[2], into red[2w], red[2w+1].
  __device__ void job_scan() {
    const int l = job[1] + warp, l_b = job[2], lo = job[3], key_hi = job[4];
    int a = K | (K << 16), g = K | (K << 16);
    if (l <= l_b) {
      const int base = l * K;
      scan_block(blkord[l], max(0, lo - base), min(K, key_hi - base), job[5],
                 job[6], job[7], a, g);
    }
    if (ln == 0) {
      red[2 * warp] = a;
      red[2 * warp + 1] = g;
    }
  }

  // The fast YATA scan's one pass over the window: the rows of slots
  // [l_a, l_b] whose doc-order keys l*K + row lie strictly between key_lo
  // and key_hi, the warps of the thread block a block each, in rounds (a
  // round of one block is warp 0's alone); warp 0 joins the blocks'
  // summaries in key order. A defeated scan
  // returns false at once. kfb = the first sibling that breaks (rank >
  // mine, same o_right); kll = the last lower-ranked sibling before it;
  // kss = the first higher-ranked different-o_right sibling after kll and
  // before kfb.
  __device__ bool scan_window(int key_lo, int key_hi, int o_left,
                              int o_right, int my_rank, int& kfb, int& kll,
                              int& kss) {
    const long long c0 = clock64();
    const int BIGK = NBL * K + K;
    kfb = BIGK;
    kll = -1;
    kss = BIGK;
    const int lo = key_lo + 1;
    ++st[2];
    if (key_hi <= lo) {
      st[6] += clock64() - c0;
      return true;
    }
    const int l_a = lo / K, l_b = min(nlog - 1, (key_hi - 1) / K);
    if (l_b >= l_a) {
      const long long span = l_b - l_a + 1;
      st[3] += span;
      st[4] = max(st[4], span);
    }
    const int nw = T >> 5;
    bool found = false, ok = true;
    for (int l0 = l_a; l0 <= l_b && ok; l0 += nw) {
      const int n = min(nw, l_b - l0 + 1);
      if (n == 1) {
        // A round of one block: warp 0 summarises it alone, no barrier.
        const int base = l0 * K;
        int a, g;
        scan_block(blkord[l0], max(0, lo - base), min(K, key_hi - base),
                   o_left, o_right, my_rank, a, g);
        __syncwarp();
        if (ln == 0) {
          red[0] = a;
          red[1] = g;
        }
        __syncwarp();
      } else {
        __syncwarp();
        if (ln == 0) {
          job[1] = l0;
          job[2] = l_b;
          job[3] = lo;
          job[4] = key_hi;
          job[5] = o_left;
          job[6] = o_right;
          job[7] = my_rank;
        }
        run_job(kJobScan);
      }
      for (int w = 0; w < n; ++w) {
        const int a = red[2 * w], g = red[2 * w + 1];
        if (a < 0) {
          ok = false;
          break;
        }
        if (found) continue;
        const int base = (l0 + w) * K;
        const int fb = a & 0xffff, lt = a >> 16;
        const int ga = g & 0xffff, g0 = g >> 16;
        if (lt != K) {
          kll = base + lt;
          kss = ga != K ? base + ga : BIGK;
        } else if (kss == BIGK && g0 != K) {
          kss = base + g0;
        }
        if (fb != K) {
          kfb = base + fb;
          found = true;
        }
      }
    }
    st[6] += clock64() - c0;
    return ok;
  }

  // The fast YATA scan (integrate_fast). Returns the cursor; flag asks for
  // the serial walk.
  __device__ int integrate_fast(int cursor0, int my_rank, int o_left,
                                int o_right, bool& flag) {
    const int BIGK = NBL * K + K;
    const int n = total_of(cumraw);
    const int tpos = o_right == kRoot ? n : pos_of_order(o_right);
    int l0, b0, i0, o_r0, l_r0, off0;
    run_at2(cursor0, l0, b0, i0, o_r0, l_r0, off0);
    const int key_lo = l0 * K + i0 - (off0 == 0 ? 1 : 0);
    int key_hi = BIGK;
    if (tpos < n) {
      int lT, bT, iT, o_rT, l_rT, offT;
      run_at2(tpos, lT, bT, iT, o_rT, l_rT, offT);
      key_hi = lT * K + iT + (offT == 0 ? 0 : 1);
    }
    int kfb, kll, kss;
    flag = !scan_window(key_lo, key_hi, o_left, o_right, my_rank, kfb, kll,
                        kss);
    if (flag) return 0;  // the serial walk decides
    // Mid-run window start: the char at cursor0 is a direct sibling whose
    // origin-right and rank come from the by-order tables.
    const bool pseudo = off0 > 0 && cursor0 < tpos;
    const int kP = key_lo;  // strictly below every window key
    if (pseudo) {
      const int order0 = clampi(iabs(o_r0) - 1 + off0, 0, OTL - 1);
      const int p_or = orl[order0], p_rk = rkl[order0];
      const bool p_gt = p_rk > my_rank;
      if (p_rk == my_rank) {
        flag = true;
        return 0;
      }
      if (p_gt && p_or == o_right) kfb = kP;
      if (!p_gt && kP < kfb && kll < 0) kll = kP;
      if (p_gt && p_or != o_right && kll < kP && kP < kfb) kss = kP;
    }
    // kss was reduced against the pre-pseudo kfb: compare with kfb.
    const int kwin = kss < kfb ? kss : kfb;
    if (kwin >= BIGK) return tpos;
    if (kwin == kP) return cursor0;
    const int l_w = clampi(kwin / K, 0, NBL - 1), i_w = kwin % K;
    const int b_w = slot(blkord, l_w);
    int head = 0;
    for (int k = ln; k < i_w; k += 32) head += L()[b_w * K + k];
    return sum_before_slot(raw, l_w) + warp_sum(head);
  }

  // The exact YATA scan over runs (integrate_cursor), pinned scan_start.
  __device__ int integrate_cursor(int cursor0, int my_rank, int o_right) {
    const int left_cursor = cursor0;
    const int n = total_of(cumraw);
    int cursor = cursor0, scan_start = cursor0;
    bool scanning = false;
    ++st[5];
    while (cursor < n) {
      int l, b, i_r, o_r, l_r, off;
      run_at2(cursor, l, b, i_r, o_r, l_r, off);
      const int so = iabs(o_r) - 1;
      const int other_order = so + off;
      const int other_left = tab(oll, other_order);
      const int other_right = tab(orl, other_order);
      const int other_rank = tab(rkl, other_order);
      const int olc = cursor_after(other_left);
      bool brk = other_order == o_right || olc < left_cursor;
      const bool eq = !brk && olc == left_cursor;
      const bool gt = my_rank > other_rank;
      if (eq && !gt) {
        if (o_right == other_right) {
          brk = true;
        } else {
          if (!scanning) scan_start = cursor;
          scanning = true;
        }
      } else if (eq) {
        scanning = false;
      }
      if (brk) break;
      const int step = (other_order < o_right && o_right < so + l_r)
                           ? o_right - other_order
                           : l_r - off;
      if (step <= 0) {  // corrupt state: stop instead of spinning
        flag_err(2);
        break;
      }
      cursor += step;
    }
    return scanning ? scan_start : cursor;
  }

  __device__ void do_remote_insert(int k, int my_rank, int o_left,
                                   int o_right, int il, int st_) {
    // integrate_entry
    const int cursor0 = cursor_after(o_left);
    int c;
    if (fast) {
      bool flag;
      c = integrate_fast(cursor0, my_rank, o_left, o_right, flag);
      if (flag) c = integrate_cursor(cursor0, my_rank, o_right);
    } else {
      c = integrate_cursor(cursor0, my_rank, o_right);
    }
    int l = c == 0 ? 0 : slot_of_cum(cumraw, c);
    if (slot(rws, l) + 2 > K) split(l);
    l = c == 0 ? 0 : slot_of_cum(cumraw, c);
    const int b = slot(blkord, l);
    const int r0 = slot(rws, l);
    // _locate_run_raw: the run holding raw char #local (1-based); at c == 0
    // it feeds no output.
    int i_r = 0, o_r = 0, l_r = 0, off = 0;
    if (c > 0) {
      const int local = c - sum_before_slot(raw, l);
      int excl;
      i_r = locate(b, r0, local, false, false, excl);
      o_r = row(O(), b, i_r);
      l_r = row(L(), b, i_r);
      off = local - excl;
    }
    const bool mrg = c > 0 && o_r > 0 && off == l_r &&
                     st_ + 1 == o_r + l_r && o_left == o_r + l_r - 2;
    const bool is_split = c > 0 && off < l_r;
    splice(b, c == 0, i_r, l_r, off, il, st_, mrg, is_split,
           o_r > 0 ? o_r + off : o_r - off, (iabs(o_r) - 1) + off - 1,
           o_left, o_right, my_rank);
    grow_slot(l, mrg ? 0 : (is_split ? 2 : 1), il, il);
    record_insert(k, b, st_, il, o_left, o_right);
  }

  // -- deletes --------------------------------------------------------------

  // One 3-way run split of block b at row i_p: [head?] [tombstone mid]
  // [tail?] (_delete_block_math's apply_partial, retire_endpoint's _fix).
  // Pieces after the first chain to their predecessor char, take orp = -2
  // and inherit the rank (_split_piece_aux). so = the run's 0-based start
  // order, o_r its signed start, [a, e) the covered char range. Returns the
  // rows added.
  __device__ int split3(int b, int i_p, int o_r, int ln_, int so, int a,
                        int e) {
    const int cov = e - a;
    const bool has_head = a > 0, has_tail = e < ln_;
    const int amt = (has_head ? 1 : 0) + (has_tail ? 1 : 0);
    const int t_rk = row(P[4], b, i_p);
    const int p1_ol = has_head ? so + a - 1 : so + e - 1;
    const int p2_ol = so + e - 1;
    shift_rows(b, i_p + 1, roll_amount(amt, 2, K));
    if (ln == 0) {
      if (i_p >= 0 && i_p < K) {
        P[0][b * K + i_p] = has_head ? o_r : -(so + a + 1);
        P[1][b * K + i_p] = has_head ? a : cov;
      }
      if (amt >= 1)
        put(b, i_p + 1, has_head ? -(so + a + 1) : so + e + 1,
            has_head ? cov : ln_ - e, p1_ol, -2, t_rk);
      if (amt == 2) put(b, i_p + 2, so + e + 1, ln_ - e, p2_ol, -2, t_rk);
    }
    __syncwarp();
    return amt;
  }

  // do_local_delete: tombstone d live chars after live rank p, one block
  // per iteration (_delete_block_math); raw counts are unchanged.
  __device__ void do_local_delete(int p, int d) {
    int rem = d, iters = 0;
    while (rem > 0 && iters <= 2 * NBL) {
      int l = slot_of_cum(cumliv, p + 1);
      if (slot(rws, l) + 2 > K) split(l);
      l = slot_of_cum(cumliv, p + 1);
      const int b = slot(blkord, l);
      const int base = sum_before_slot(liv, l);
      int* O_ = O();
      const int* L_ = L();
      // Rows past the covered span cover nothing: the pass stops there.
      int run = 0, tot = 0, npart = 0, i1 = K, i2 = -1;
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int k = k0 + ln;
        const int o = k < K ? O_[b * K + k] : 0;
        const int bl = k < K ? L_[b * K + k] : 0;
        const int lv = o > 0 ? bl : 0;
        const int inc = warp_scan(lv);
        const int before = base + run + inc - lv;
        const int cs = clampi(p - before, 0, lv);
        const int ce = clampi(p + rem - before, 0, lv);
        const int cov = ce - cs;
        const bool full = cov > 0 && cov == bl;
        const bool part = cov > 0 && !full;
        tot += cov;
        if (part) {
          s_x[k] = cs;
          s_y[k] = ce;
        }
        if (full) O_[b * K + k] = -o;
        const unsigned m = __ballot_sync(kFull, part);
        if (m != 0) {
          npart += __popc(m);
          i1 = min(i1, k0 + __ffs(m) - 1);
          i2 = k0 + 31 - __clz(m);
        }
        run += __shfl_sync(kFull, inc, 31);
        if (base + run >= p + rem) break;
      }
      tot = warp_sum(tot);
      __syncwarp();
      // Higher-index boundary first so i1's row index stays valid. Each
      // partial run is live: start order o - 1.
      int added = 0;
      for (int pass = 0; pass < 2; ++pass) {
        const int i_p = pass == 0 ? i2 : i1;
        if (pass == 0 ? npart < 1 : npart != 2) continue;
        const int o = O_[b * K + i_p], ln_ = L_[b * K + i_p];
        added += split3(b, i_p, o, ln_, o - 1, s_x[i_p], s_y[i_p]);
      }
      grow_slot(l, added, -tot, 0);
      rem -= tot;
      ++iters;
    }
    if (rem > 0) flag_err(1);
  }

  // retire_endpoint: split the covered part out of the run containing
  // order o; a no-op unless that run is live and partially covered.
  __device__ void retire_endpoint(int tg, int dlen, int o) {
    int b, r;
    locate_order(o, b, r);
    const int l = logical_of_physical(b);
    int o_r = row(O(), b, r), l_r = row(L(), b, r);
    int so = iabs(o_r) - 1;
    int a = max(tg - so, 0), e = min(l_r, tg + dlen - so);
    if (!(o_r > 0 && (a > 0 || e < l_r) && e > a)) return;
    if (slot(rws, l) + 2 > K) split(l);
    locate_order(o, b, r);  // the split may have moved the run
    const int l2 = logical_of_physical(b);
    o_r = row(O(), b, r);
    l_r = row(L(), b, r);
    so = iabs(o_r) - 1;
    a = max(tg - so, 0);
    e = min(l_r, tg + dlen - so);
    const int amt = split3(b, r, o_r, l_r, so, a, e);
    grow_slot(l2, amt, -(e - a), 0);
  }

  // do_remote_delete: one-pass order-interval tombstone [tg, tg+dlen).
  __device__ void do_remote_delete(int tg, int dlen) {
    for (int j = ln; j < nlog && j < NB; j += 32) s_blk[j] = 0;
    __syncwarp();
    if (ln == 0) {
      job[1] = tg;
      job[2] = dlen;
      job[3] = nlog * K;
      red[0] = 0;
    }
    run_job(kJobFlip);
    if (red[0] < dlen) flag_err(1);
    // Per-slot live counts fall by their physical block's flipped chars;
    // the slots at or past nlog are stale and not kept.
    int run = 0;
    for (int j0 = 0; j0 < nlog; j0 += 32) {
      const int j = j0 + ln;
      int g = 0;
      if (j < nlog) {
        const int bj = blkord[j];
        g = (bj >= 0 && bj < NB) ? s_blk[bj] : 0;
      }
      const int inc = warp_scan(g) + run;
      if (j < nlog) {
        liv[j] -= g;
        cumliv[j] -= inc;
      }
      run = __shfl_sync(kFull, inc, 31);
    }
    __syncwarp();
    retire_endpoint(tg, dlen, tg + dlen - 1);
    retire_endpoint(tg, dlen, tg);
  }
};

__global__ void __launch_bounds__(kMaxThreads) rle_mixed_replay_kernel(
    const int* __restrict__ kind, const int* __restrict__ pos,
    const int* __restrict__ dlen, const int* __restrict__ dtgt,
    const int* __restrict__ olop, const int* __restrict__ orop,
    const int* __restrict__ rank, const int* __restrict__ ilen,
    const int* __restrict__ start,          // [S] op columns
    const int* __restrict__ oll_in, const int* __restrict__ orl_in,
    const int* __restrict__ rkl,            // [OTL] by-order tables
    int* ol, int* orr,                      // [S, B] u32 bits, zeroed
    int* ordp, int* lenp,                   // [CAP, B]
    int* blk_out, int* rows_out,            // [1, NBL, B]
    int* meta_out,                          // [1, 8, B]
    int* err,                               // [8, B], zeroed
    int* planes,  // [5 - nsm, B, CAP] the planes not in shared memory,
                  // of O, L, OLP, ORP, RKP in that order
    int* tables,  // [3, B, OTL] lane tables: ordblk, oll, orl
    long long* stats,  // [B, kStats], or null
    int S, int B, int CAP, int K, int NB, int NBL, int OTL, int fast,
    int nsm) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x;
  Mixed M;
  M.t = threadIdx.x;
  M.T = blockDim.x;
  M.ln = M.t & 31;
  M.warp = M.t >> 5;
  M.B = B;
  M.lane = lane;
  M.K = K;
  M.NB = NB;
  M.NBL = NBL;
  M.CAP = CAP;
  M.OTL = OTL;
  M.fast = fast != 0;
  M.blkord = smem;
  M.rws = M.blkord + NBL;
  M.liv = M.rws + NBL;
  M.raw = M.liv + NBL;
  M.cumliv = M.raw + NBL;
  M.cumraw = M.cumliv + NBL;
  M.s_x = M.cumraw + NBL;
  M.s_y = M.s_x + K;
  M.s_blk = M.s_y + K;
  M.job = M.s_blk + NB;
  M.red = M.job + 8;
  int* p = M.red + 32;
  for (int q = 0; q < kMoved; ++q) {
    if (q < nsm) {
      M.P[q] = p;
      p += CAP;
    } else {
      M.P[q] = planes + ((size_t)(q - nsm) * B + lane) * CAP;
    }
  }
  const size_t to = (size_t)lane * OTL;
  M.ordblk = tables + to;
  M.oll = tables + (size_t)B * OTL + to;
  M.orl = tables + (size_t)2 * B * OTL + to;
  M.rkl = rkl;
  M.err = err;
  M.ol = ol;
  M.orr = orr;
  M.nlog = 1;  // one empty block in slot 0
  for (int i = 0; i < kStats; ++i) M.st[i] = 0;
  const int t = M.t, T = M.T;

  for (int j = t; j < CAP; j += T)
    for (int q = 0; q < kMoved; ++q) M.P[q][j] = 0;
  for (int j = t; j < OTL; j += T) {
    M.ordblk[j] = 0;
    M.oll[j] = oll_in[j];
    M.orl[j] = orl_in[j];
  }
  for (int j = t; j < 6 * NBL + 2 * K + NB + 40; j += T) smem[j] = 0;
  __syncthreads();

  if (M.warp == 0) {
    const long long c0 = clock64();
    Columns<9> cols{{kind, pos, dlen, dtgt, olop, orop, rank, ilen, start}};
    for (int k0 = 0; k0 < S; k0 += 32) {
      cols.load(k0, S, 0);
      const int n = min(32, S - k0);
      for (int j = 0; j < n; ++j) {
        const int k = k0 + j;
        const int kd = cols.get(0, j), ps = cols.get(1, j);
        const int d = cols.get(2, j), tg = cols.get(3, j);
        const int o_l = cols.get(4, j), o_rt = cols.get(5, j);
        const int rk = cols.get(6, j), il = cols.get(7, j);
        const int st_ = cols.get(8, j);
        if (kd == kLocal && d > 0) M.do_local_delete(ps, d);
        if (kd == kLocal && il > 0) M.do_local_insert(k, ps, il, st_);
        if (kd == kRemoteIns && il > 0)
          M.do_remote_insert(k, rk, o_l, o_rt, il, st_);
        if (kd == kRemoteDel) M.do_remote_delete(tg, d);
      }
    }
    M.st[9] = clock64() - c0;
    if (stats != nullptr && M.ln == 0)
      for (int i = 0; i < kStats; ++i)
        stats[(size_t)lane * kStats + i] = M.st[i];
    __syncwarp();
    if (M.ln == 0) M.job[1] = M.nlog;
    M.end_jobs();
  } else {
    M.serve();
  }
  __syncthreads();  // every write of warp 0 is visible

  for (int j = t; j < NBL; j += T) {
    blk_out[(size_t)j * B + lane] = M.blkord[j];
    rows_out[(size_t)j * B + lane] = M.rws[j];
  }
  for (int j = t; j < 8; j += T)
    meta_out[(size_t)j * B + lane] = j == 0 ? M.job[1] : 0;
  for (int j = t; j < CAP; j += T) {
    ordp[(size_t)j * B + lane] = M.P[0][j];
    lenp[(size_t)j * B + lane] = M.P[1][j];
  }
}

}  // namespace

extern "C" int rle_mixed_replay_launch(
    const int* kind, const int* pos, const int* dlen, const int* dtgt,
    const int* olop, const int* orop, const int* rank, const int* ilen,
    const int* start, const int* oll_in, const int* orl_in, const int* rkl,
    int* ol, int* orr, int* ordp, int* lenp, int* blk_out, int* rows_out,
    int* meta_out, int* err, int* planes, int* tables, long long* stats,
    int S, int B, int CAP, int K, int NB, int NBL, int OTL, int fast,
    int nsm, int warps, int smem, void* stream) {
  // smem: bytes of the kernel's shared layout, nsm: how many of the five
  // moved planes sit there, and warps: the thread block's warps, from the
  // Python wrapper (ops/rle_mixed.py::kernel_smem_bytes, WARPS), which
  // also refuses K below 8 and a layout past the shared memory a thread
  // block may use.
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rle_mixed_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  rle_mixed_replay_kernel<<<B, warps * 32, smem, (cudaStream_t)stream>>>(
      kind, pos, dlen, dtgt, olop, orop, rank, ilen, start, oll_in, orl_in,
      rkl, ol, orr, ordp, lenp, blk_out, rows_out, meta_out, err, planes,
      tables, stats, S, B, CAP, K, NB, NBL, OTL, fast, nsm);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
