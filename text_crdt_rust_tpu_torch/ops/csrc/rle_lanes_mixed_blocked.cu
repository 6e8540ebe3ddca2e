// Blocked per-lane mixed replay (divergent documents, local and remote
// ops), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// text_crdt_rust_tpu/ops/rle_lanes_mixed.py::_mixed_lanes_blocked_kernel
// and computes what it computes, bit for bit, on all fourteen outputs. The
// plain PyTorch version of the same function is
// text_crdt_rust_tpu_torch/ops/rle_lanes_mixed.py::
// lanes_mixed_blocked_replay_plain; the two are held against each other on
// the card. Each function below carries the name of its counterpart in
// both.
//
// What it computes. B different documents each replay their own op stream
// (kind LOCAL, REMOTE_INS or REMOTE_DEL, one op per document per step).
// A document is RLE runs, ordp = ±(start_order+1) and lenp = length, in
// K-row physical blocks ordered by per-document logical slot tables
// (blkord, rws, live and raw counts liv/raw and their inclusive prefixes
// cumliv/cumraw). An order -> block HINT (ordblk) is verified on every
// lookup; a stale hint follows the split forward pointers (fwd) two hops,
// then falls back to a search of the whole plane, and the found run's span
// is healed. By-order tables oll/orl are carried across launches (the
// prefill delta merges in at step 0), rkl is read-only. Remote inserts
// integrate by the exact run-level YATA walk; remote deletes walk the
// covered runs by hinted lookup, flip full covers and split the partial
// ends. err row 0: out of blocks; row 1: a bad delete; row 2: an order miss.
//
// Mapping. One warp per document, four documents per thread block. The
// TPU kernel works on a tile of documents at once and gates work with
// jnp.any over the tile; every such gate only skips work whose effect on a
// document is masked off, so each document run alone gives the same bits
// (the CPU tests hold a B-lane replay against B one-lane replays). A
// warp's slot tables live in shared memory, its working K-row block in
// shared scratch; its planes live in device memory as lane-major working
// copies (a block is K contiguous ints), transposed from and to the public
// [CAP, B] layout by tiled transposes around the replay. The by-order
// tables stay in the public [OCAP, B] layout and are read by direct index
// (entry o of document b at o*B + b), clamped into [0, OCAP) as t_read
// clamps. Row passes over one block (prefix sums, reductions, the splice)
// are strided over the warp's 32 threads; the control scalars of the step
// are computed by every thread alike.
//
// What bounds it. The serial chain of steps per document: each step is a
// handful of dependent warp reductions over one K-row block and the
// NBT-slot tables, a few hundred cycles, while the bytes a replay must move
// (op columns, planes and tables read once, results written once) take
// well under a millisecond at 3.35 TB/s. The design runs all B chains at
// once, one warp each, with no barrier across documents; the cost left is
// the redundant control arithmetic in each thread and the strided table
// accesses, which later work can cut.

#include <cuda_runtime.h>

#include "lanes_mixed.cuh"

namespace {

using namespace lanes;

constexpr int kWarpsPerBlock = 4;

// One document's replay state, held by its warp.
struct Doc {
  int* O;       // ordp working plane [CAP] (device memory, lane-major)
  int* L;       // lenp working plane [CAP]
  int *blk, *rws, *liv, *raw, *cliv, *craw, *fwd, *tmp;  // shared [NBT]
  int *wo, *wl, *xo, *xl, *s1, *s2, *s3;                   // shared [K]
  Tab oll, orl, rkl, ordblk;
  int K, NB, NBT, CAP, WMAX;
  int nlog;
  int e0, e1, e2;  // err rows 0, 1, 2
};

__device__ __forceinline__ int trow(const int* t, int l, int n) {
  return row_or0(t, l, n);
}

// gather_block: block b of a plane into (wo, wl); ids outside [0, NB) read
// block 0. The leading __syncwarp keeps the copy from overwriting a block
// that another thread of the warp is still reading (some paths reach here
// with no warp collective since their last read).
__device__ void gather(Doc& d, int b) {
  __syncwarp();
  const int bc = (b >= 0 && b < d.NB) ? b : 0;
  for (int j = lane_id(); j < d.K; j += 32) {
    d.wo[j] = d.O[bc * d.K + j];
    d.wl[j] = d.L[bc * d.K + j];
  }
  __syncwarp();
}

// scatter_block: (wo, wl) back to block b; ids outside [0, NB) write
// nothing.
__device__ void scatter(Doc& d, int b) {
  if (b >= 0 && b < d.NB) {
    for (int j = lane_id(); j < d.K; j += 32) {
      d.O[b * d.K + j] = d.wo[j];
      d.L[b * d.K + j] = d.wl[j];
    }
  }
  __syncwarp();
}

// gather_head: row 0 of block b (block 0 for ids outside [0, NB)).
__device__ __forceinline__ int head_of(const Doc& d, int b) {
  return d.O[((b >= 0 && b < d.NB) ? b : 0) * d.K];
}

// slot_of: smallest logical slot whose prefix reaches rank1 (strict:
// cum < rank1 counts; else cum <= rank1), capped at nlog - 1.
__device__ int slot_of(const Doc& d, const int* cum, int rank1, bool strict) {
  int c = 0;
  for (int t = lane_id(); t < d.NBT; t += 32)
    c += (t < d.nlog && (strict ? cum[t] < rank1 : cum[t] <= rank1));
  return imin(wsum(c), d.nlog - 1);
}

__device__ __forceinline__ int live_before(const Doc& d, int l) {
  return trow(d.cliv, l, d.NBT) - trow(d.liv, l, d.NBT);
}
__device__ __forceinline__ int raw_before(const Doc& d, int l) {
  return trow(d.craw, l, d.NBT) - trow(d.raw, l, d.NBT);
}

// Add `v` to a slot table's rows t >= l.
__device__ void add_from(const Doc& d, int* t, int l, int v) {
  __syncwarp();
  for (int i = lane_id(); i < d.NBT; i += 32)
    if (i >= l) t[i] += v;
  __syncwarp();
}

// split: the top half of slot l's rows moves to a fresh physical block at
// logical slot l + 1, with live and raw table upkeep. At table capacity it
// raises err[0] and does nothing.
__device__ void split(Doc& d, int l) {
  if (d.nlog >= d.NB) {
    d.e0 = 1;
    return;
  }
  const int K = d.K, NBT = d.NBT, lane = lane_id();
  const int b = trow(d.blk, l, NBT), r = trow(d.rws, l, NBT);
  const int keep = floordiv(r, 2), mv = r - keep, nbv = d.nlog;
  gather(d, b);
  int lh = 0, rh = 0;
  for (int j = lane; j < K; j += 32) {
    const bool hi = j >= keep && j < r;
    lh += (hi && d.wo[j] > 0) ? d.wl[j] : 0;
    rh += hi ? d.wl[j] : 0;
  }
  const int liv_hi = wsum(lh), raw_hi = wsum(rh);
  const int up = roll_amount(keep, K, K);
  if (b >= 0 && b < d.NB) {
    for (int j = lane; j < K; j += 32) {
      d.O[b * K + j] = j < keep ? d.wo[j] : 0;
      d.L[b * K + j] = j < keep ? d.wl[j] : 0;
    }
  }
  __syncwarp();
  for (int j = lane; j < K; j += 32) {  // nbv < NB: always in range
    d.O[nbv * K + j] = j < mv ? d.wo[(j + up) % K] : 0;
    d.L[nbv * K + j] = j < mv ? d.wl[(j + up) % K] : 0;
  }
  __syncwarp();
  // Slots after l move one down (a circular roll masked to rows > l).
  int* tabs[6] = {d.blk, d.rws, d.liv, d.raw, d.cliv, d.craw};
  for (int q = 0; q < 6; ++q) {
    int* t = tabs[q];
    for (int i = lane; i < NBT; i += 32) d.tmp[i] = t[i];
    __syncwarp();
    for (int i = lane; i < NBT; i += 32)
      if (i > l) t[i] = d.tmp[(i + NBT - 1) % NBT];
    __syncwarp();
  }
  if (lane == 0) {
    if (l >= 0 && l < NBT) {
      d.rws[l] = keep;
      d.liv[l] -= liv_hi;
      d.raw[l] -= raw_hi;
      d.cliv[l] -= liv_hi;
      d.craw[l] -= raw_hi;
    }
    if (l + 1 >= 0 && l + 1 < NBT) {
      d.rws[l + 1] = mv;
      d.liv[l + 1] = liv_hi;
      d.raw[l + 1] = raw_hi;
      d.blk[l + 1] = nbv;
    }
    if (b >= 0 && b < NBT) d.fwd[b] = nbv;
  }
  __syncwarp();
  d.nlog += 1;
}

// _verify_block: (found, block, in-block row) of order o in candidate block
// b_raw; ids outside [0, NB) never match; the row defaults to K - 1.
struct Hit {
  bool f;
  int b, row;
};

__device__ Hit verify_block(const Doc& d, int b_raw, int o) {
  const bool ok = b_raw >= 0 && b_raw < d.NB;
  const int bc = ok ? b_raw : 0;
  int n = 0, row = d.K - 1;
  for (int j = lane_id(); j < d.K; j += 32) {
    const int wo = d.O[bc * d.K + j], so = iabs(wo) - 1;
    if (wo != 0 && so <= o && o < so + d.L[bc * d.K + j]) {
      ++n;
      row = imin(row, j);
    }
  }
  Hit h;
  h.f = ok && wsum(n) > 0;
  h.b = bc;
  h.row = wmin(row);
  return h;
}

// The whole-plane search of the fallback: the first hit row (CAP - 1 when
// none) and whether any row holds order o.
__device__ int plane_search(const Doc& d, int o, bool& found) {
  int n = 0, row = d.CAP - 1;
  for (int i = lane_id(); i < d.CAP; i += 32) {
    const int wo = d.O[i], so = iabs(wo) - 1;
    if (wo != 0 && so <= o && o < so + d.L[i]) {
      ++n;
      row = imin(row, i);
    }
  }
  found = wsum(n) > 0;
  return wmin(row);
}

// locate_order for a wanted lookup: the hint, verified; two forward-pointer
// hops; the plane search. A hop or fallback hit heals the whole span of the
// found run in ordblk. `flag` raises err[2] when nothing holds o.
__device__ Hit locate_order(Doc& d, int o, bool flag) {
  const int oc = clampi(o, 0, d.oll.OCAP - 1);
  Hit h = verify_block(d, d.ordblk.get(oc), o);
  if (h.f) return h;
  const Hit h2 = verify_block(d, trow(d.fwd, h.b, d.NBT), o);
  Hit r;
  if (h2.f) {
    r = h2;
  } else {
    const Hit h3 = verify_block(d, trow(d.fwd, h2.b, d.NBT), o);
    if (h3.f) {
      r = h3;
    } else {
      bool g;
      const int grow = plane_search(d, o, g);
      r.f = g;
      r.b = grow / d.K;
      r.row = grow % d.K;
    }
  }
  if (r.f) {
    const int gr = r.b * d.K + r.row;
    const int h_o = row_or0(d.O, gr, d.CAP), h_l = row_or0(d.L, gr, d.CAP);
    const int h_so = iabs(h_o) - 1;
    const int lo = imax(h_so, 0), hi = imin(h_so + h_l, d.ordblk.OCAP);
    for (int q = lo + lane_id(); q < hi; q += 32) d.ordblk.put(q, r.b);
    __syncwarp();
  }
  if (flag && !r.f) d.e2 = 1;
  return r;
}

// locate_order_pure: the hint, verified, else the plane search; no heal,
// no flag.
__device__ Hit locate_order_pure(const Doc& d, int o) {
  const int oc = clampi(o, 0, d.oll.OCAP - 1);
  const Hit h = verify_block(d, d.ordblk.get(oc), o);
  if (h.f) return h;
  bool g;
  const int grow = plane_search(d, o, g);
  Hit r;
  r.f = g;
  r.b = grow / d.K;
  r.row = grow % d.K;
  return r;
}

// slot_of_block: the logical slot holding physical block nb (0 if none).
__device__ int slot_of_block(const Doc& d, int nb) {
  int best = 0;
  for (int t = lane_id(); t < d.NBT; t += 32)
    if (t < d.nlog && d.blk[t] == nb) best = imax(best, t);
  return wmax(best);
}

// raw_pos_of_order: RAW document position of order o (flags misses).
__device__ int raw_pos_of_order(Doc& d, int o) {
  const Hit h = locate_order(d, o, true);
  const int l = slot_of_block(d, h.b);
  const int bc = (h.b >= 0 && h.b < d.NB) ? h.b : 0;
  int in = 0;
  for (int j = lane_id(); j < d.K; j += 32)
    in += j < h.row ? d.L[bc * d.K + j] : 0;
  const int inblk = wsum(in);
  const int so_hit = iabs(row_or0(d.O + bc * d.K, h.row, d.K)) - 1;
  return raw_before(d, l) + inblk + (o - so_hit);
}

// cursor_after for a lane that needs it: 0 after ROOT, else one past the
// raw position of o; an unknown entry (-2) raises err[2].
__device__ int cursor_after(Doc& d, int o) {
  if (o == kUnknown) d.e2 = 1;
  if (o == kRoot) return 0;
  return raw_pos_of_order(d, imax(o, 0)) + 1;
}

// lane_apply_partial on the working block, with the covered ranges in
// (s2, s3).
__device__ int apply_partial(Doc& d, int i_p) {
  const int o = row_or0(d.wo, i_p, d.K), ln = row_or0(d.wl, i_p, d.K);
  const int cs = row_or0(d.s2, i_p, d.K), ce = row_or0(d.s3, i_p, d.K);
  const Pieces p = split_pieces(o, ln, cs, ce);
  apply_pieces(d.wo, d.wl, d.xo, d.xl, d.K, i_p, p);
  return p.amt;
}

// do_local_delete: tombstone d live chars after live rank p, block by
// block (raw counts unchanged).
__device__ void do_local_delete(Doc& d, int p, int dl) {
  const int K = d.K, lane = lane_id();
  int rem = dl;
  for (int iters = 0; rem > 0 && iters <= 2 * d.NBT; ++iters) {
    int l = slot_of(d, d.cliv, p + 1, true);
    if (trow(d.rws, l, d.NBT) + 2 > K) {
      split(d, l);
      l = slot_of(d, d.cliv, p + 1, true);
    }
    const int b = trow(d.blk, l, d.NBT);
    const int base = live_before(d, l);
    gather(d, b);
    for (int j = lane; j < K; j += 32) d.s1[j] = d.wo[j] > 0 ? d.wl[j] : 0;
    __syncwarp();
    wprefix(d.s1, d.xo, K);  // cum
    int tot = 0, np = 0, i1 = K, i2 = -1;
    for (int j = lane; j < K; j += 32) {
      const int lv = d.s1[j], before = base + d.xo[j] - lv;
      const int cs = imin(imax(p - before, 0), lv);
      const int ce = imin(imax(p + rem - before, 0), lv);
      const int cov = ce - cs;
      d.s2[j] = cs;
      d.s3[j] = ce;
      tot += cov;
      const bool full = cov > 0 && cov == d.wl[j];
      const bool part = cov > 0 && !full;
      if (part) {
        ++np;
        i1 = imin(i1, j);
        i2 = imax(i2, j);
      }
      if (full) d.wo[j] = -d.wo[j];
    }
    tot = wsum(tot);
    np = wsum(np);
    i1 = wmin(i1);
    i2 = wmax(i2);
    __syncwarp();
    int a2 = 0, a1 = 0;
    if (np >= 1) a2 = apply_partial(d, i2);
    if (np == 2) a1 = apply_partial(d, i1);
    scatter(d, b);
    if (lane == 0 && l >= 0 && l < d.NBT) {
      d.rws[l] += a1 + a2;
      d.liv[l] -= tot;
    }
    __syncwarp();
    add_from(d, d.cliv, l, -tot);
    rem -= tot;
  }
  if (rem > 0) d.e1 = 1;
}

// The fused W-row insert splice of the working block (fused_splice_rows
// with one active lane). Returns amt; sets mrg, is_split and lrun.
__device__ int fused_splice(Doc& d, int p, int i_r, int o_r, int l_r,
                            int off, int il, int st, int w, bool& mrg,
                            bool& is_split, int& lrun) {
  const int K = d.K;
  lrun = floordiv(il, imax(w, 1));
  mrg = w == 1 && p > 0 && off == l_r && st + 1 == o_r + l_r;
  is_split = p > 0 && off < l_r;
  const int ins_at = p == 0 ? 0 : i_r + 1;
  const int amt = mrg ? 0 : w + (int)is_split;
  const int ra = roll_amount(amt, d.WMAX + 1, K);
  __syncwarp();
  for (int j = lane_id(); j < K; j += 32) {
    d.xo[j] = d.wo[j];
    d.xl[j] = d.wl[j];
  }
  __syncwarp();
  for (int j = lane_id(); j < K; j += 32) {
    int no = d.xo[j], nl = d.xl[j];
    if (j >= ins_at) {
      const int s = roll_src(j, ra, K);
      no = d.xo[s];
      nl = d.xl[s];
    }
    if (is_split && j == i_r) nl = off;
    if (!mrg && j >= ins_at && j < ins_at + w) {
      no = st + il - (j - ins_at + 1) * lrun + 1;
      nl = lrun;
    }
    if (is_split && j == ins_at + w) {
      no = o_r + off;
      nl = l_r - off;
    }
    if (mrg && j == i_r) nl = l_r + il;
    d.wo[j] = no;
    d.wl[j] = nl;
  }
  __syncwarp();
  return amt;
}

// _fused_table_writes plus the ordblk hint of the new orders.
__device__ void record_local(Doc& d, int st, int il, int lrun, int left,
                             int right, int b) {
  const int ls = imax(lrun, 1), OCAP = d.oll.OCAP;
  for (int q = lane_id(); q < il; q += 32) {
    const int o = st + q;
    if (o < 0 || o >= OCAP) continue;
    if (q % ls == 0) d.oll.put(o, left);
    d.orl.put(o, q < ls ? right : st + (q / ls - 1) * ls);
    d.ordblk.put(o, b);
  }
  __syncwarp();
}

// do_local_insert: live-rank insert with by-order table upkeep; returns
// the op's origins.
__device__ void do_local_insert(Doc& d, int p, int il, int st, int w,
                                int& ol_out, int& or_out) {
  const int K = d.K, NBT = d.NBT, lane = lane_id();
  int l = p == 0 ? 0 : slot_of(d, d.cliv, p, true);
  if (trow(d.rws, l, NBT) + w + 1 > K) {
    split(d, l);
    l = p == 0 ? 0 : slot_of(d, d.cliv, p, true);
  }
  const int r0 = trow(d.rws, l, NBT), b = trow(d.blk, l, NBT);
  const int local = p - live_before(d, l);
  gather(d, b);
  for (int j = lane; j < K; j += 32) d.s1[j] = d.wo[j] > 0 ? d.wl[j] : 0;
  __syncwarp();
  wprefix(d.s1, d.s2, K);  // cum
  int c = 0;
  for (int j = lane; j < K; j += 32) c += (d.s2[j] < local && j < r0);
  const int i_r = wsum(c);
  const int o_r = row_or0(d.wo, i_r, K), l_r = row_or0(d.wl, i_r, K);
  const int off = local - (row_or0(d.s2, i_r, K) - row_or0(d.s1, i_r, K));
  const int left = p == 0 ? kRoot : (o_r - 1) + (off - 1);
  // Successor reads come from the pre-splice state.
  const int nxt_in_blk = row_or0(d.wo, i_r + 1, K);
  const int nxt_slot_o = head_of(d, trow(d.blk, imin(l + 1, NBT - 1), NBT));
  const int first_o = head_of(d, trow(d.blk, 0, NBT));
  const int succ_p0 = trow(d.rws, 0, NBT) > 0 ? first_o : 0;
  bool mrg, is_split;
  int lrun;
  const int amt = fused_splice(d, p, i_r, o_r, l_r, off, il, st, w, mrg,
                               is_split, lrun);
  const int succ_after =
      i_r + 1 < r0 ? nxt_in_blk : (l + 1 < d.nlog ? nxt_slot_o : 0);
  const int succ = p == 0 ? succ_p0 : (is_split ? o_r + off : succ_after);
  const int right = succ == 0 ? kRoot : iabs(succ) - 1;
  scatter(d, b);
  if (lane == 0 && l >= 0 && l < NBT) {
    d.rws[l] += amt;
    d.liv[l] += il;
    d.raw[l] += il;
  }
  __syncwarp();
  add_from(d, d.cliv, l, il);
  add_from(d, d.craw, l, il);
  record_local(d, st, il, lrun, left, right, b);
  ol_out = left;
  or_out = right;
}

// run_at_raw: (signed start, length, 0-based offset) of the run holding
// RAW position c.
__device__ void run_at_raw(Doc& d, int c, int& o_r, int& l_r, int& off) {
  const int K = d.K;
  const int ls = slot_of(d, d.craw, c, false);
  const int b = trow(d.blk, ls, d.NBT), r0 = trow(d.rws, ls, d.NBT);
  const int local = c - raw_before(d, ls);
  gather(d, b);
  wprefix(d.wl, d.s1, K);  // cumb
  int n = 0;
  for (int j = lane_id(); j < K; j += 32) n += (d.s1[j] <= local && j < r0);
  const int i_r = wsum(n);
  o_r = row_or0(d.wo, i_r, K);
  l_r = row_or0(d.wl, i_r, K);
  off = local - (row_or0(d.s1, i_r, K) - l_r);
}

// integrate_cursor: the exact run-level YATA scan for one inserting lane.
__device__ int integrate_cursor(Doc& d, int my_rank, int o_left,
                                int o_right) {
  const int n = trow(d.craw, d.nlog - 1, d.NBT);  // total_raw
  Yata y;
  y.cursor = cursor_after(d, o_left);
  y.left_cursor = y.cursor;
  y.scanning = 0;
  y.scan_start = y.cursor;
  while (y.cursor < n) {
    int o_r, l_r, off;
    run_at_raw(d, y.cursor, o_r, l_r, off);
    const int so = iabs(o_r) - 1, other = so + off;
    const int other_left = d.oll.get(other), other_right = d.orl.get(other);
    const int other_rank = d.rkl.get(other);
    const int olc = cursor_after(d, other_left);
    bool stuck;
    if (yata_probe(y, my_rank, o_right, so, l_r, off, olc, other_right,
                   other_rank, stuck))
      break;
    if (stuck) {  // corrupt state: the TPU loop would never end here
      d.e2 = 1;
      break;
    }
  }
  return y.scanning ? y.scan_start : y.cursor;
}

// do_remote_insert: YATA integrate, then the raw-position splice (the split
// run may be a tombstone; merging needs a live, chained predecessor).
__device__ void do_remote_insert(Doc& d, int my_rank, int o_left,
                                 int o_right, int il, int st) {
  const int K = d.K, NBT = d.NBT, lane = lane_id();
  const int c = integrate_cursor(d, my_rank, o_left, o_right);
  int l = c == 0 ? 0 : slot_of(d, d.craw, c, true);
  if (trow(d.rws, l, NBT) + 2 > K) {
    split(d, l);
    l = c == 0 ? 0 : slot_of(d, d.craw, c, true);
  }
  const int r0 = trow(d.rws, l, NBT), b = trow(d.blk, l, NBT);
  const int local = c - raw_before(d, l);
  gather(d, b);
  wprefix(d.wl, d.s1, K);  // cumb
  int cnt = 0;
  for (int j = lane; j < K; j += 32) cnt += (d.s1[j] < local && j < r0);
  const int i_r = wsum(cnt);
  const int o_r = row_or0(d.wo, i_r, K), l_r = row_or0(d.wl, i_r, K);
  const int off = local - (row_or0(d.s1, i_r, K) - l_r);
  const bool mrg = c > 0 && o_r > 0 && off == l_r && st + 1 == o_r + l_r &&
                   o_left == o_r + l_r - 2;
  const bool is_split = c > 0 && off < l_r;
  const int ins_at = c == 0 ? 0 : i_r + 1;
  const int amt = mrg ? 0 : (is_split ? 2 : 1);
  const int ra = roll_amount(amt, 2, K);
  __syncwarp();
  for (int j = lane; j < K; j += 32) {
    d.xo[j] = d.wo[j];
    d.xl[j] = d.wl[j];
  }
  __syncwarp();
  for (int j = lane; j < K; j += 32) {
    int no = d.xo[j], nl = d.xl[j];
    if (j >= ins_at) {
      const int s = roll_src(j, ra, K);
      no = d.xo[s];
      nl = d.xl[s];
    }
    if (is_split && j == i_r) nl = off;
    if (!mrg && j == ins_at) {
      no = st + 1;
      nl = il;
    }
    if (is_split && j == ins_at + 1) {
      no = o_r > 0 ? o_r + off : o_r - off;
      nl = l_r - off;
    }
    if (mrg && j == i_r) nl = l_r + il;
    d.wo[j] = no;
    d.wl[j] = nl;
  }
  __syncwarp();
  scatter(d, b);
  if (lane == 0 && l >= 0 && l < NBT) {
    d.rws[l] += amt;
    d.liv[l] += il;
    d.raw[l] += il;
  }
  __syncwarp();
  add_from(d, d.cliv, l, il);
  add_from(d, d.craw, l, il);
  const int OCAP = d.ordblk.OCAP;
  for (int q = lane; q < il; q += 32)
    if (st + q >= 0 && st + q < OCAP) d.ordblk.put(st + q, b);
  __syncwarp();
}

// do_remote_delete: the hint-guided covered-run walk over orders
// [t, t + dlen): flip full live covers, split the partial ends, count
// covered dead runs without flipping (`double_delete.rs:6-9`).
__device__ void do_remote_delete(Doc& d, int t, int dlen) {
  const int K = d.K, lane = lane_id();
  const int end = t + dlen;
  int o_cur = t, rem = dlen;
  for (int iters = 0; rem > 0 && iters <= d.CAP + d.NBT; ++iters) {
    Hit h = locate_order(d, o_cur, false);
    if (!h.f) {  // target orders absent: a bad delete, stop cleanly
      d.e1 = 1;
      rem = 0;
      break;
    }
    gather(d, h.b);
    int o_r = row_or0(d.wo, h.row, K), l_r = row_or0(d.wl, h.row, K);
    int so = iabs(o_r) - 1, aa = o_cur - so, ee = imin(l_r, end - so);
    const bool partial0 = o_r > 0 && (aa > 0 || ee < l_r);
    int l = slot_of_block(d, h.b);
    if (partial0 && trow(d.rws, l, d.NBT) + 2 > K) {
      split(d, l);
      h = locate_order_pure(d, o_cur);
    }
    l = slot_of_block(d, h.b);
    const bool housed = !partial0 || trow(d.rws, l, d.NBT) + 2 <= K;
    gather(d, h.b);
    o_r = row_or0(d.wo, h.row, K);
    l_r = row_or0(d.wl, h.row, K);
    so = iabs(o_r) - 1;
    aa = o_cur - so;
    ee = imin(l_r, end - so);
    const int cov = ee - aa;
    const bool live = o_r > 0;
    const bool part = live && (aa > 0 || ee < l_r);
    __syncwarp();  // every thread has read the run before it changes
    if (housed) {
      if (part) {
        apply_pieces(d.wo, d.wl, d.xo, d.xl, K, h.row,
                     split_pieces(o_r, l_r, aa, ee));
      } else if (live) {
        if (lane == 0) d.wo[h.row] = -o_r;
        __syncwarp();
      }
      if (live) scatter(d, h.b);
      const int dec = live ? cov : 0;
      if (lane == 0 && l >= 0 && l < d.NBT) {
        if (part) d.rws[l] += (int)(aa > 0) + (int)(ee < l_r);
        d.liv[l] -= dec;
      }
      __syncwarp();
      add_from(d, d.cliv, l, -dec);
      rem -= cov;
    } else {
      rem = 0;  // the split could not be housed (err[0] raised)
    }
    o_cur = so + ee;
  }
  if (rem > 0) d.e1 = 1;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    lanes_mixed_blocked_kernel(
        const int* __restrict__ kind, const int* __restrict__ pos,
        const int* __restrict__ dlen, const int* __restrict__ dtgt,
        const int* __restrict__ olop, const int* __restrict__ orop,
        const int* __restrict__ rank, const int* __restrict__ ilen,
        const int* __restrict__ start, const int* __restrict__ wcol,
        const int* __restrict__ nlog0, const int* __restrict__ blk0,
        const int* __restrict__ rws0, const int* __restrict__ liv0,
        const int* __restrict__ raw0, const int* __restrict__ fwd0,
        const int* __restrict__ rkl, int* __restrict__ ol,
        int* __restrict__ orr, int* __restrict__ nlog_out,
        int* __restrict__ blk_out, int* __restrict__ rws_out,
        int* __restrict__ liv_out, int* __restrict__ raw_out,
        int* __restrict__ oll, int* __restrict__ orl,
        int* __restrict__ ordblk, int* __restrict__ fwd_out,
        int* __restrict__ err, int* __restrict__ wsO,
        int* __restrict__ wsL, int S, int B, int CAP, int K, int NBT,
        int OCAP, int WMAX) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warps only: no collective is split
  int* my = smem + warp * (8 * NBT + 7 * K);
  Doc d;
  d.O = wsO + (long long)b * CAP;
  d.L = wsL + (long long)b * CAP;
  d.blk = my;
  d.rws = my + NBT;
  d.liv = my + 2 * NBT;
  d.raw = my + 3 * NBT;
  d.cliv = my + 4 * NBT;
  d.craw = my + 5 * NBT;
  d.fwd = my + 6 * NBT;
  d.tmp = my + 7 * NBT;
  int* kb = my + 8 * NBT;
  d.wo = kb;
  d.wl = kb + K;
  d.xo = kb + 2 * K;
  d.xl = kb + 3 * K;
  d.s1 = kb + 4 * K;
  d.s2 = kb + 5 * K;
  d.s3 = kb + 6 * K;
  d.oll = Tab{oll + b, B, OCAP};
  d.orl = Tab{orl + b, B, OCAP};
  d.rkl = Tab{const_cast<int*>(rkl) + b, B, OCAP};
  d.ordblk = Tab{ordblk + b, B, OCAP};
  d.K = K;
  d.NB = CAP / K;
  d.NBT = NBT;
  d.CAP = CAP;
  d.WMAX = WMAX;
  d.nlog = imax(nlog0[b], 1);
  d.e0 = d.e1 = d.e2 = 0;
  for (int i = lane; i < NBT; i += 32) {
    const long long g = (long long)i * B + b;
    d.blk[i] = blk0[g];
    d.rws[i] = rws0[g];
    d.liv[i] = liv0[g];
    d.raw[i] = raw0[g];
    d.fwd[i] = fwd0[g];
  }
  __syncwarp();
  wprefix(d.liv, d.cliv, NBT);
  wprefix(d.raw, d.craw, NBT);

  for (int k = 0; k < S; ++k) {
    const long long g = (long long)k * B + b;
    const int kd = kind[g], p = pos[g], dl = dlen[g], il = ilen[g];
    const int st = start[g], w = imax(wcol[g], 1);
    int ol_v = 0, or_v = 0;
    if (kd == kLocal && dl > 0) do_local_delete(d, p, dl);
    if (kd == kLocal && il > 0) do_local_insert(d, p, il, st, w, ol_v, or_v);
    if (kd == kRemoteIns && il > 0) {
      ol_v = olop[g];
      or_v = orop[g];
      do_remote_insert(d, rank[g], ol_v, or_v, il, st);
    }
    if (kd == kRemoteDel && dl > 0) do_remote_delete(d, dtgt[g], dl);
    if (lane == 0) {
      ol[g] = ol_v;
      orr[g] = or_v;
    }
  }

  for (int i = lane; i < NBT; i += 32) {
    const long long g = (long long)i * B + b;
    blk_out[g] = d.blk[i];
    rws_out[g] = d.rws[i];
    liv_out[g] = d.liv[i];
    raw_out[g] = d.raw[i];
    fwd_out[g] = d.fwd[i];
  }
  if (lane == 0) {
    nlog_out[b] = d.nlog;
    const int e[8] = {d.e0, d.e1, d.e2, 0, 0, 0, 0, 0};
    for (int r = 0; r < 8; ++r) err[(long long)r * B + b] = e[r];
  }
}

}  // namespace

extern "C" int rle_lanes_mixed_blocked_launch(
    const int* kind, const int* pos, const int* dlen, const int* dtgt,
    const int* olop, const int* orop, const int* rank, const int* ilen,
    const int* start, const int* wcol, const int* ord0, const int* len0,
    const int* nlog0, const int* blk0, const int* rws0, const int* liv0,
    const int* raw0, const int* oll0, const int* orl0, const int* ordblk0,
    const int* fwd0, const int* olld, const int* orld, const int* rkl,
    int* ol, int* orr, int* ordp, int* lenp, int* nlog, int* blk, int* rws,
    int* liv, int* raw, int* oll, int* orl, int* ordblk, int* fwd, int* err,
    int* scratch, int S, int B, int CAP, int K, int NBT, int OCAP, int WMAX,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int* wsO = scratch;
  int* wsL = scratch + (long long)B * CAP;
  lanes::launch_transpose(ord0, wsO, CAP, B, st);
  lanes::launch_transpose(len0, wsL, CAP, B, st);
  lanes::launch_merge(olld, oll0, orld, orl0, oll, orl, (long long)OCAP * B,
                      st);
  cudaError_t e = cudaMemcpyAsync(ordblk, ordblk0,
                                  (size_t)OCAP * B * sizeof(int),
                                  cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem =
      (size_t)kWarpsPerBlock * (8 * NBT + 7 * K) * sizeof(int);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(lanes_mixed_blocked_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lanes_mixed_blocked_kernel<<<blocks, 32 * kWarpsPerBlock, smem, st>>>(
      kind, pos, dlen, dtgt, olop, orop, rank, ilen, start, wcol, nlog0,
      blk0, rws0, liv0, raw0, fwd0, rkl, ol, orr, nlog, blk, rws, liv, raw,
      oll, orl, ordblk, fwd, err, wsO, wsL, S, B, CAP, K, NBT, OCAP, WMAX);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lanes::launch_transpose(wsO, ordp, B, CAP, st);
  lanes::launch_transpose(wsL, lenp, B, CAP, st);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
