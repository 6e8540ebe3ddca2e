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
// healed. By-order tables oll/orl are mutable, rkl is read-only. Four aux
// planes hold each run head's origin-left (olp), origin-right (orp) and
// rank (rkp), and each physical row's logical slot (lpp). Remote inserts
// integrate by the vectorised YATA scan (integrate_fast); when its flag
// rises the exact serial run-walk (integrate_cursor) decides. Remote deletes
// are one-pass interval tombstones with at most two endpoint splits. Local
// edits follow ops/rle plus upkeep of raw counts, index and tables. err row
// 0 means block capacity, row 1 a bad delete, row 2 an order-index miss.
//
// Mapping. One thread block per lane, NT threads (thread t owns row t of
// the block being edited). A loop over all steps inside the thread block
// replaces the TPU grid's sequential axis. The slot tables live in shared
// memory; every control scalar is computed block-wide (each thread computes
// the same value from shared or global memory, or gets it from a
// block_reduce), so control flow is uniform and every __syncthreads is
// reached by all threads. The planes live in device memory, lane-major
// [6, B, CAP] working copies (a lane's rows are contiguous), transposed into
// the public [CAP, B] layout once at the end. The mutable order tables are
// one private copy per lane in device memory ([3, B, OT*128]); the read-only
// rkl is shared by all lanes. Plane-wide steps (the fast scan's
// classification, the remote delete's flip and per-block sums, the order
// lookup's fallback search, the split's lpp update) are strided loops over
// CAP rows joined by block reductions. Every lane replays the same stream,
// so the TPU kernel's lane-max control scalars equal this block's own.
//
// What bounds it. Not bytes: one storm replay must move ~14-16 MB of inputs
// and outputs at 128 lanes, ~0.005 ms at 3.35 TB/s. The floor is the serial
// chain of 3,200-3,791 dependent steps, each several block-wide reductions
// over one K-row block plus, in this design, a few passes over the whole
// CAP-row plane. The design keeps every step inside one thread block (no
// launches, no grid-wide synchronisation) and runs all B chains at once on
// B SMs; the planes of all lanes (~35 MB) fit in the 50 MB L2, though
// whether they stay there is not measured. It recomputes the shared control
// state once per lane and scans whole planes where the window is a few
// blocks, which later work can cut.

#include <cuda_runtime.h>

#include "block_ops.cuh"

namespace {

using namespace block_ops;

constexpr int kLocal = 0, kRemoteIns = 1, kRemoteDel = 2;
constexpr int kRoot = -1;  // ROOT_ORDER as int32

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The five planes a splice moves together (lpp stays per physical row).
constexpr int kMoved = 5;

struct Mixed {
  int* P[6];     // this lane's planes [CAP]: O, L, OLP, ORP, RKP, LPP
  int* ordblk;   // this lane's order -> block hints [OTL]
  int* oll;      // this lane's origin-left by order [OTL]
  int* orl;      // this lane's origin-right by order [OTL]
  const int* rkl;  // rank by order [OTL], read-only, shared
  int* blkord;   // shared [NBL]; rws, liv, raw, cumliv, cumraw follow
  int* rws;
  int* liv;
  int* raw;
  int* cumliv;
  int* cumraw;
  int* s_row[kMoved];  // shared [K] row exchange, one per moved plane
  int* s_x;      // shared [K] prefix-sum exchange
  int* s_y;
  int* s_blk;    // shared [NB] per-block sums
  int* red;      // shared [32] reduction scratch
  int* err;      // [8, B]
  int* ol;       // [S, B]
  int* orr;
  int B, lane, K, NB, NBL, CAP, OTL, t, T;
  bool fast;
  int nlog;  // logical blocks in use; identical in every thread

  __device__ int* O() const { return P[0]; }
  __device__ int* L() const { return P[1]; }

  __device__ void flag_err(int row) const {
    if (t == 0) err[row * B + lane] = 1;
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

  // -- slot plumbing (no barriers: every thread reads the same shared
  // values; writers bracket their writes with barriers) -----------------

  __device__ int sum_before_slot(const int* tbl, int l) const {
    int s = 0;
    for (int j = 0; j < imin(l, NBL); ++j) s += tbl[j];
    return s;
  }
  __device__ int total_of(const int* cum) const { return slot(cum, nlog - 1); }
  // Smallest logical slot whose inclusive prefix reaches rank1.
  __device__ int slot_of_cum(const int* cum, int rank1) const {
    int n = 0;
    for (int j = 0; j < imin(nlog, NBL); ++j) n += cum[j] < rank1;
    return imin(n, nlog - 1);
  }
  __device__ int logical_of_physical(int b) const {
    int l = 0;
    for (int j = 0; j < imin(nlog, NBL); ++j)
      if (blkord[j] == b) l = j;
    return l;
  }
  // Table upkeep after an insert or delete in slot l.
  __device__ void grow_slot(int l, int amt, int dliv, int draw) {
    __syncthreads();
    if (t == 0) {
      rws[l] += amt;
      liv[l] += dliv;
      raw[l] += draw;
    }
    for (int j = l + t; j < NBL; j += T) {
      cumliv[j] += dliv;
      cumraw[j] += draw;
    }
    __syncthreads();
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
    int bo = 0, bl = 0;
    if (t < K) {
      bo = O()[b * K + t];
      bl = L()[b * K + t];
    }
    const bool hi = t < K && t >= keep && t < r;
    const int liv_hi = block_reduce(hi && bo > 0 ? bl : 0, red, SumOp());
    const int raw_hi = block_reduce(hi ? bl : 0, red, SumOp());
    const int up = roll_amount(keep, K, K);
    int own[kMoved], src[kMoved];
    if (t < K) {
      for (int q = 0; q < kMoved; ++q) {
        own[q] = P[q][b * K + t];
        src[q] = P[q][b * K + (t + up) % K];
      }
    }
    __syncthreads();  // every row of block b is read
    if (t < K) {
      for (int q = 0; q < kMoved; ++q) {
        P[q][nb * K + t] = t < mv ? src[q] : 0;
        P[q][b * K + t] = t < keep ? own[q] : 0;
      }
    }
    // Logical positions: slots after l shift one down, block nb lands at
    // l + 1. lpp rows past a block's row count are deliberately NOT
    // zeroed: a row validated later must already hold its block's slot.
    int* lpp = P[5];
    for (int j = t; j < CAP; j += T) {
      int v = lpp[j];
      if (v > l) v += 1;
      if (j / K == nb) v = l + 1;
      lpp[j] = v;
    }
    if (t < 6) {  // one thread per table: slots > l take their predecessor
      int* tb = blkord + t * NBL;
      for (int j = NBL - 1; j > l; --j) tb[j] = tb[j - 1];
    }
    __syncthreads();
    if (t == 0) {
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
    nlog += 1;
    __syncthreads();
  }

  // -- order -> run lookup ----------------------------------------------

  // Row of the run containing order o in block b (find_in_block); K if none.
  __device__ int find_in_block(int b, int o) {
    int r = K;
    if (t < K) {
      const int bo = O()[b * K + t], bl = L()[b * K + t];
      const int so = iabs(bo) - 1;
      if (bo != 0 && so <= o && o < so + bl) r = t;
    }
    return block_reduce(r, red, MinOp());
  }

  // (block, row) of the run containing order o (locate_order): the ordblk
  // hint, verified; else one full-plane search; then the hint heals. A
  // negative o looks up order 0 and neither raises the miss flag nor heals.
  __device__ void locate_order(int o_in, int& b, int& r) {
    const int o = imax(o_in, 0);
    const int bh = clampi(tab(ordblk, o), 0, NB - 1);
    r = find_in_block(bh, o);
    if (r < K) {
      b = bh;
    } else {
      int g = CAP - 1, any = 0;
      for (int j = t; j < CAP; j += T) {
        const int bo = O()[j], bl = L()[j];
        const int so = iabs(bo) - 1;
        if (bo != 0 && so <= o && o < so + bl) {
          g = imin(g, j);
          any = 1;
        }
      }
      g = block_reduce(g, red, MinOp());
      any = block_reduce(any, red, MaxOp());
      if (!any && o_in >= 0) flag_err(2);
      b = g / K;
      r = g % K;
    }
    __syncthreads();
    if (t == 0 && o_in >= 0 && o < OTL) ordblk[o] = b;
    __syncthreads();
  }

  // RAW document position of the char with order o (pos_of_order).
  __device__ int pos_of_order(int o) {
    int b, r;
    locate_order(o, b, r);
    const int l = logical_of_physical(b);
    const int raw_before =
        block_reduce(t < K && t < r ? L()[b * K + t] : 0, red, SumOp());
    const int so_row = iabs(row(O(), b, r)) - 1;
    return sum_before_slot(raw, l) + raw_before + (o - so_row);
  }

  __device__ int cursor_after(int o) {
    return o == kRoot ? 0 : pos_of_order(o) + 1;
  }

  // The run holding RAW position c (run_at2): slot, block, row, signed
  // start order, length and 0-based char offset.
  __device__ void run_at2(int c, int& l, int& b, int& i_r, int& o_r,
                          int& l_r, int& off) {
    l = slot_of_cum(cumraw, c + 1);
    b = slot(blkord, l);
    const int r0 = slot(rws, l);
    const int local = c - sum_before_slot(raw, l);
    const int bl = t < K ? L()[b * K + t] : 0;
    const int cum = block_scan(bl, red);
    if (t < K) s_x[t] = cum;
    i_r = block_reduce(t < K && cum <= local && t < r0 ? 1 : 0, red,
                       SumOp());
    o_r = row(O(), b, i_r);
    l_r = row(L(), b, i_r);
    off = local - ((i_r < K ? s_x[i_r] : 0) - l_r);
  }

  // -- inserts --------------------------------------------------------------

  // The in-register insert splice of block b (_insert_splice /
  // _insert_splice_raw) and its mirror on the aux planes (aux_splice):
  // rows >= ins_at shift down by amt, the new run takes the op's
  // (origin-left, origin-right, rank), a split tail chains to its
  // predecessor char and reads its true origin-right from orl.
  __device__ void splice(int b, bool at_head, int i_r, int l_r, int off,
                         int il, int st, bool mrg, bool is_split, int tail_o,
                         int tail_ol, int new_ol, int new_or, int new_rk) {
    const int ins_at = at_head ? 0 : i_r + 1;
    const int amt = mrg ? 0 : (is_split ? 2 : 1);
    const int a = roll_amount(amt, 2, K);
    const int t_rk = row(P[4], b, i_r);
    const int t_or = tab(orl, tail_ol + 1);
    int v[kMoved];
    if (t < K) {
      const int s = t < ins_at ? t : roll_src(t, a, K);
      for (int q = 0; q < kMoved; ++q) v[q] = P[q][b * K + s];
    }
    __syncthreads();  // every old row is read
    if (t < K) {
      if (is_split && t == i_r) v[1] = off;
      if (!mrg && t == ins_at) {
        v[0] = st + 1;
        v[1] = il;
        v[2] = new_ol;
        v[3] = new_or;
        v[4] = new_rk;
      }
      if (is_split && t == ins_at + 1) {
        v[0] = tail_o;
        v[1] = l_r - off;
        v[2] = tail_ol;
        v[3] = t_or;
        v[4] = t_rk;
      }
      if (mrg && t == i_r) v[1] = l_r + il;
      for (int q = 0; q < kMoved; ++q) P[q][b * K + t] = v[q];
    }
    __syncthreads();
  }

  // Index and origin-table upkeep plus the op's origins (record_insert).
  __device__ void record_insert(int k, int b, int st, int il, int left,
                                int right) {
    for (int j = t; j < il; j += T) {
      if (st + j < OTL) {
        ordblk[st + j] = b;
        orl[st + j] = right;
      }
    }
    if (t == 0) {
      if (st < OTL) oll[st] = left;
      ol[(size_t)k * B + lane] = left;
      orr[(size_t)k * B + lane] = right;
    }
    __syncthreads();
  }

  // do_local_insert: an il-char run after LIVE rank p.
  __device__ void do_local_insert(int k, int p, int il, int st) {
    int l = p == 0 ? 0 : slot_of_cum(cumliv, p);
    if (slot(rws, l) + 2 > K) split(l);
    l = p == 0 ? 0 : slot_of_cum(cumliv, p);
    const int r0 = slot(rws, l);
    const int b = slot(blkord, l);
    const int local = p - sum_before_slot(liv, l);
    // _locate_run: the run holding live char #local (1-based).
    int bo = 0, bl = 0;
    if (t < K) {
      bo = O()[b * K + t];
      bl = L()[b * K + t];
    }
    const int cum = block_scan(bo > 0 ? bl : 0, red);
    if (t < K) s_x[t] = cum;
    const int i_r = block_reduce(t < K && cum < local && t < r0 ? 1 : 0,
                                 red, SumOp());
    const int o_r = row(O(), b, i_r), l_r = row(L(), b, i_r);
    const int lv_i = o_r > 0 ? l_r : 0;
    const int off = local - ((i_r < K ? s_x[i_r] : 0) - lv_i);
    const bool mrg = p > 0 && off == l_r && st + 1 == o_r + l_r;
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
      succ = O()[slot(blkord, imin(l + 1, NBL - 1)) * K];
    } else {
      succ = 0;
    }
    const int right = succ == 0 ? kRoot : iabs(succ) - 1;
    splice(b, p == 0, i_r, l_r, off, il, st, mrg, is_split, o_r + off,
           (iabs(o_r) - 1) + off - 1, left, right, tab(rkl, st));
    grow_slot(l, mrg ? 0 : (is_split ? 2 : 1), il, il);
    record_insert(k, b, st, il, left, right);
  }

  // The fast YATA scan (integrate_fast): one classification of every run
  // row and three masked reductions. Returns the cursor; flag asks for the
  // serial walk.
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
    const int* O_ = O();
    const int* L_ = L();
    const int* OLP = P[2];
    const int* ORP = P[3];
    const int* RKP = P[4];
    const int* LPP = P[5];
    // Pass 1: kfb and the flag. A row is in the window W when it holds a
    // run and its doc-order key lies strictly between the bounds.
    int kfb = BIGK, bad = 0;
    for (int j = t; j < CAP; j += T) {
      const int o = O_[j];
      const int rib = j % K;
      const int key = LPP[j] * K + rib;
      if (o == 0 || key <= key_lo || key >= key_hi) continue;
      const int h = iabs(o) - 1, olv = OLP[j], orv = ORP[j], rk = RKP[j];
      if (olv == o_left) {  // S: a direct sibling
        if (rk == my_rank || orv == -2) bad = 1;
        if (rk > my_rank && orv == o_right) kfb = imin(kfb, key);
      } else {
        // A physically chained piece: its predecessor char is the
        // previous row's last char (row 0 of a block cannot verify it).
        bool chain = false;
        if (h > 0 && olv == h - 1 && rib > 0) {
          const int e_prev = iabs(O_[j - 1]) - 1 + L_[j - 1] - 1;
          chain = e_prev == h - 1;
        }
        if (!chain) bad = 1;
      }
    }
    kfb = block_reduce(kfb, red, MinOp());
    flag = block_reduce(bad, red, MaxOp()) != 0;
    // Pass 2: kll, the last lower-ranked sibling before kfb.
    int kll = -1;
    for (int j = t; j < CAP; j += T) {
      const int o = O_[j];
      const int key = LPP[j] * K + j % K;
      if (o == 0 || key <= key_lo || key >= key_hi) continue;
      if (OLP[j] == o_left && !(RKP[j] > my_rank) && key < kfb)
        kll = imax(kll, key);
    }
    kll = block_reduce(kll, red, MaxOp());
    // Pass 3: kss, the first higher-ranked different-o_right sibling after
    // kll and before kfb.
    int kss = BIGK;
    for (int j = t; j < CAP; j += T) {
      const int o = O_[j];
      const int key = LPP[j] * K + j % K;
      if (o == 0 || key <= key_lo || key >= key_hi) continue;
      if (OLP[j] == o_left && RKP[j] > my_rank && ORP[j] != o_right &&
          key > kll && key < kfb)
        kss = imin(kss, key);
    }
    kss = block_reduce(kss, red, MinOp());

    // Mid-run window start: the char at cursor0 is a direct sibling whose
    // origin-right and rank come from the by-order tables.
    const bool pseudo = off0 > 0 && cursor0 < tpos;
    const int kP = key_lo;  // strictly below every window key
    if (pseudo) {
      const int order0 = clampi(iabs(o_r0) - 1 + off0, 0, OTL - 1);
      const int p_or = orl[order0], p_rk = rkl[order0];
      const bool p_gt = p_rk > my_rank;
      if (p_rk == my_rank) flag = true;
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
    const int head = block_reduce(t < K && t < i_w ? L_[b_w * K + t] : 0,
                                  red, SumOp());
    return sum_before_slot(raw, l_w) + head;
  }

  // The exact YATA scan over runs (integrate_cursor), pinned scan_start.
  __device__ int integrate_cursor(int cursor0, int my_rank, int o_right) {
    const int left_cursor = cursor0;
    const int n = total_of(cumraw);
    int cursor = cursor0, scan_start = cursor0;
    bool scanning = false;
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
                                   int o_right, int il, int st) {
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
    const int local = c - sum_before_slot(raw, l);
    // _locate_run_raw: the run holding raw char #local (1-based).
    const int bl = t < K ? L()[b * K + t] : 0;
    const int cum = block_scan(bl, red);
    if (t < K) s_x[t] = cum;
    const int i_r = block_reduce(t < K && cum < local && t < r0 ? 1 : 0,
                                 red, SumOp());
    const int o_r = row(O(), b, i_r), l_r = row(L(), b, i_r);
    const int off = local - ((i_r < K ? s_x[i_r] : 0) - l_r);
    const bool mrg = c > 0 && o_r > 0 && off == l_r &&
                     st + 1 == o_r + l_r && o_left == o_r + l_r - 2;
    const bool is_split = c > 0 && off < l_r;
    splice(b, c == 0, i_r, l_r, off, il, st, mrg, is_split,
           o_r > 0 ? o_r + off : o_r - off, (iabs(o_r) - 1) + off - 1,
           o_left, o_right, my_rank);
    grow_slot(l, mrg ? 0 : (is_split ? 2 : 1), il, il);
    record_insert(k, b, st, il, o_left, o_right);
  }

  // -- deletes --------------------------------------------------------------

  // One 3-way run split of block b at row i_p: [head?] [tombstone mid]
  // [tail?] (_delete_block_math's apply_partial, retire_endpoint's _fix).
  // v holds this thread's row of the moved planes and is updated; pieces
  // after the first chain to their predecessor char, take orp = -2 and
  // inherit the rank (_split_piece_aux). so = the run's 0-based start
  // order, o_r its signed start, [a, e) the covered char range. Returns
  // the rows added.
  __device__ int split3(int* v, int i_p, int o_r, int ln, int so, int a,
                        int e) {
    __syncthreads();  // earlier readers of the row exchange are done
    if (t < K)
      for (int q = 0; q < kMoved; ++q) s_row[q][t] = v[q];
    __syncthreads();
    const int cov = e - a;
    const bool has_head = a > 0, has_tail = e < ln;
    const int amt = (has_head ? 1 : 0) + (has_tail ? 1 : 0);
    const int sh = roll_amount(amt, 2, K);
    const int t_rk = (i_p >= 0 && i_p < K) ? s_row[4][i_p] : 0;
    const int p1_ol = has_head ? so + a - 1 : so + e - 1;
    const int p2_ol = so + e - 1;
    if (t < K) {
      if (t > i_p) {
        const int src = roll_src(t, sh, K);
        for (int q = 0; q < kMoved; ++q) v[q] = s_row[q][src];
      }
      if (t == i_p) {
        v[0] = has_head ? o_r : -(so + a + 1);
        v[1] = has_head ? a : cov;
      }
      if (t == i_p + 1 && amt >= 1) {
        v[0] = has_head ? -(so + a + 1) : so + e + 1;
        v[1] = has_head ? cov : ln - e;
        v[2] = p1_ol;
        v[3] = -2;
        v[4] = t_rk;
      }
      if (t == i_p + 2 && amt == 2) {
        v[0] = so + e + 1;
        v[1] = ln - e;
        v[2] = p2_ol;
        v[3] = -2;
        v[4] = t_rk;
      }
    }
    return amt;
  }

  __device__ void load_rows(int b, int* v) const {
    for (int q = 0; q < kMoved; ++q) v[q] = t < K ? P[q][b * K + t] : 0;
  }
  __device__ void store_rows(int b, const int* v) const {
    if (t < K)
      for (int q = 0; q < kMoved; ++q) P[q][b * K + t] = v[q];
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
      int v[kMoved];
      load_rows(b, v);
      const int lv = v[0] > 0 ? v[1] : 0;
      const int cum = block_scan(lv, red);
      const int before = base + cum - lv;
      const int cs = clampi(p - before, 0, lv);
      const int ce = clampi(p + rem - before, 0, lv);
      const int cov = t < K ? ce - cs : 0;
      const bool full = cov > 0 && cov == v[1];
      const bool part = cov > 0 && !full;
      if (t < K) {
        s_x[t] = cs;
        s_y[t] = ce;
      }
      const int tot = block_reduce(cov, red, SumOp());
      const int npart = block_reduce(part ? 1 : 0, red, SumOp());
      const int i1 = block_reduce(part ? t : K, red, MinOp());
      const int i2 = block_reduce(part ? t : -1, red, MaxOp());
      if (full) v[0] = -v[0];
      // Higher-index boundary first so i1's row index stays valid. Each
      // partial run is live: start order o - 1.
      int added = 0;
      for (int pass = 0; pass < 2; ++pass) {
        const int i_p = pass == 0 ? i2 : i1;
        if (pass == 0 ? npart < 1 : npart != 2) continue;
        __syncthreads();
        if (t < K) {
          s_row[0][t] = v[0];
          s_row[1][t] = v[1];
        }
        __syncthreads();
        const int o = s_row[0][i_p], ln = s_row[1][i_p];
        const int cs_i = s_x[i_p], ce_i = s_y[i_p];
        added += split3(v, i_p, o, ln, o - 1, cs_i, ce_i);
      }
      __syncthreads();
      store_rows(b, v);
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
    int a = imax(tg - so, 0), e = imin(l_r, tg + dlen - so);
    if (!(o_r > 0 && (a > 0 || e < l_r) && e > a)) return;
    if (slot(rws, l) + 2 > K) split(l);
    locate_order(o, b, r);  // the split may have moved the run
    const int l2 = logical_of_physical(b);
    o_r = row(O(), b, r);
    l_r = row(L(), b, r);
    so = iabs(o_r) - 1;
    a = imax(tg - so, 0);
    e = imin(l_r, tg + dlen - so);
    int v[kMoved];
    load_rows(b, v);
    const int amt = split3(v, r, o_r, l_r, so, a, e);
    __syncthreads();
    store_rows(b, v);
    grow_slot(l2, amt, -(e - a), 0);
  }

  // do_remote_delete: one-pass order-interval tombstone [tg, tg+dlen).
  __device__ void do_remote_delete(int tg, int dlen) {
    for (int j = t; j < NB; j += T) s_blk[j] = 0;
    __syncthreads();
    int* O_ = O();
    const int* L_ = L();
    int tot = 0;
    for (int j = t; j < CAP; j += T) {
      const int o = O_[j];
      if (o == 0) continue;
      const int bl = L_[j], so = iabs(o) - 1;
      const int cs = imin(imax(tg - so, 0), bl);
      const int ce = imin(imax(tg + dlen - so, 0), bl);
      const int cov = ce - cs;
      tot += cov;
      if (o > 0 && cov > 0 && cov == bl) {  // a full cover of a live run
        O_[j] = -o;
        atomicAdd(&s_blk[j / K], bl);
      }
    }
    tot = block_reduce(tot, red, SumOp());
    if (tot < dlen) flag_err(1);
    // Per-slot live counts fall by their physical block's flipped chars
    // (every slot, stale ones included, as on the TPU).
    if (t == 0) {
      int run = 0;
      for (int j = 0; j < NBL; ++j) {
        const int bj = blkord[j];
        const int g = (bj >= 0 && bj < NB) ? s_blk[bj] : 0;
        run += g;
        liv[j] -= g;
        cumliv[j] -= run;
      }
    }
    __syncthreads();
    retire_endpoint(tg, dlen, tg + dlen - 1);
    retire_endpoint(tg, dlen, tg);
  }
};

__global__ void rle_mixed_replay_kernel(
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
    int* pO, int* pL, int* pOLP, int* pORP, int* pRKP,
    int* pLPP,                              // [B, CAP] working planes
    int* tOB, int* tOLL, int* tORL,         // [B, OTL] lane tables
    int S, int B, int CAP, int K, int NB, int NBL, int OTL, int fast) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x;
  Mixed M;
  M.t = threadIdx.x;
  M.T = blockDim.x;
  M.B = B;
  M.lane = lane;
  M.K = K;
  M.NB = NB;
  M.NBL = NBL;
  M.CAP = CAP;
  M.OTL = OTL;
  M.fast = fast != 0;
  const size_t po = (size_t)lane * CAP, to = (size_t)lane * OTL;
  int* planes[6] = {pO, pL, pOLP, pORP, pRKP, pLPP};
  for (int q = 0; q < 6; ++q) M.P[q] = planes[q] + po;
  M.ordblk = tOB + to;
  M.oll = tOLL + to;
  M.orl = tORL + to;
  M.rkl = rkl;
  M.blkord = smem;
  M.rws = M.blkord + NBL;
  M.liv = M.rws + NBL;
  M.raw = M.liv + NBL;
  M.cumliv = M.raw + NBL;
  M.cumraw = M.cumliv + NBL;
  int* p = M.cumraw + NBL;
  for (int q = 0; q < kMoved; ++q, p += K) M.s_row[q] = p;
  M.s_x = p;
  M.s_y = M.s_x + K;
  M.s_blk = M.s_y + K;
  M.red = M.s_blk + NB;
  M.err = err;
  M.ol = ol;
  M.orr = orr;
  M.nlog = 1;  // one empty block in slot 0
  const int t = M.t, T = M.T;

  for (int j = t; j < CAP; j += T)
    for (int q = 0; q < 6; ++q) M.P[q][j] = 0;
  for (int j = t; j < OTL; j += T) {
    M.ordblk[j] = 0;
    M.oll[j] = oll_in[j];
    M.orl[j] = orl_in[j];
  }
  for (int j = t; j < 6 * NBL; j += T) M.blkord[j] = 0;
  __syncthreads();

  for (int k = 0; k < S; ++k) {
    const int kd = kind[k], d = dlen[k], il = ilen[k], st = start[k];
    if (kd == kLocal && d > 0) M.do_local_delete(pos[k], d);
    if (kd == kLocal && il > 0) M.do_local_insert(k, pos[k], il, st);
    if (kd == kRemoteIns && il > 0)
      M.do_remote_insert(k, rank[k], olop[k], orop[k], il, st);
    if (kd == kRemoteDel) M.do_remote_delete(dtgt[k], d);
  }
  __syncthreads();  // every thread's plane and table writes are visible

  for (int j = t; j < NBL; j += T) {
    blk_out[(size_t)j * B + lane] = M.blkord[j];
    rows_out[(size_t)j * B + lane] = M.rws[j];
  }
  for (int j = t; j < 8; j += T)
    meta_out[(size_t)j * B + lane] = j == 0 ? M.nlog : 0;
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
    int* meta_out, int* err, int* pO, int* pL, int* pOLP, int* pORP,
    int* pRKP, int* pLPP, int* tOB, int* tOLL, int* tORL, int S, int B,
    int CAP, int K, int NB, int NBL, int OTL, int fast, void* stream) {
  const int threads = K > 512 ? (K + 31) / 32 * 32 : 512;
  const size_t smem =
      (size_t)(6 * NBL + (kMoved + 2) * K + NB + 32) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rle_mixed_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rle_mixed_replay_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      kind, pos, dlen, dtgt, olop, orop, rank, ilen, start, oll_in, orl_in,
      rkl, ol, orr, ordp, lenp, blk_out, rows_out, meta_out, err, pO, pL,
      pOLP, pORP, pRKP, pLPP, tOB, tOLL, tORL, S, B, CAP, K, NB, NBL, OTL,
      fast);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
