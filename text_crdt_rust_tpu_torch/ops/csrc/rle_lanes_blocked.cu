// Blocked per-lane local replay (divergent documents, local edits), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// text_crdt_rust_tpu/ops/rle_lanes.py::_lanes_blocked_kernel and computes
// what it computes, bit for bit, on all nine outputs. The plain PyTorch
// version of the same function is
// text_crdt_rust_tpu_torch/ops/rle_lanes.py::lanes_blocked_replay_plain;
// the two are held against each other on the card. Each function below
// carries the name of its counterpart in both.
//
// What it computes. B different documents each replay their own local edit
// stream, one op per document per step (a delete of d live chars after
// live rank p, then an insert of il chars at p, w runs in a fused step). A
// document is RLE runs, ordp = ±(start_order+1) and lenp = length, in
// K-row physical blocks ordered by per-document logical slot tables
// (blkord, rws, liv, and liv's inclusive prefix cumliv, which is scratch:
// recomputed from liv at every launch and kept up incrementally). A fresh
// document holds one empty block in slot 0 (nlog is at least 1). An insert
// descends over the slot prefix, splits a full block (its top half moves
// to the fresh physical block nlog, spliced into the logical order at the
// next slot) and splices <= w + 1 rows into one block. A delete walks
// block to block: each iteration descends again, may split, flips the
// full covers of one block and splits its at most two partly covered
// runs, until the delete drains or 2 * NBT + 1 iterations ran (a delete
// past the end of the document). A split refused at nlog >= NB raises
// err[0], and the op then splices into the full block, whose rows wrap (a
// circular roll, as pltpu.roll does). err row 1: a delete past the end.
//
// Mapping. One warp per document, `warps` documents per thread block
// (1-4, from the wrapper; 4 by default). The TPU kernel's jnp.any gates
// over a tile of documents (the pl.whens, the re-descent conds, the
// tile-wide delete loop) only skip work whose effect on a document is
// masked off, so each document run alone gives the same bits (the CPU
// tests hold a B-lane replay against B one-lane replays). A warp's slot
// tables live in shared memory. Its rows live, for the whole launch,
// either in shared memory (CHIP: the thread block copies its documents'
// columns of the public [CAP, B] planes in and out, a warp's load
// covering 32 / warps rows of all its documents), or in lane-major
// working planes in device memory (a block is K contiguous ints,
// transposed from and to the public layout around the replay); the
// wrapper takes shared memory where a document fits a thread block.
// Either way every step edits its block where it lives: no block is
// copied out and back. Each step's op is read one step ahead, so no step
// waits for it.
//
// What bounds it. Each document's serial chain of dependent warp steps,
// not bytes (the bytes a replay must move take ~0.09 ms at 3.35 TB/s).
// The first port copied the edited block into shared scratch and
// back for every delete iteration and every insert (1.04 copies a step
// at config 5), read two block heads from device memory an insert, ran a
// prefix pass and a reduction over all K rows, copied and rewrote all K
// rows for a splice, and shifted the slot tables through a copy for a
// split: ~9,460 cycles a step with work (its counters, config 5).
// What the design does: the rows stay where they live; an in-block
// locate is one warp sum a 32-row round and a scan of the round that
// crosses (no prefix array); a delete's pass keeps the live prefix in
// registers, works only in the rounds its range covers and carries its
// at most two partly covered runs in registers; a splice shifts only the
// rows past its new rows, in place, top down (of the TPU kernel's
// circular roll only that shows); the live prefix is kept up over the
// slots in use only (its entries past nlog are scratch that no read
// reaches before a split's shift overwrites them); a split moves the top
// half block to block and shifts the four tables in one pass. That is
// ~3,980 cycles a step (splices 23 %, delete passes 21 %, table upkeep
// 9 %, slot locates 7 %). With the rows in shared memory the chain runs
// ~12 % faster than with them in device memory (config 5, the launches
// queued ahead). The counters are compiled only into the stats build (S).

#include <cuda_runtime.h>

#include "lanes_mixed.cuh"

namespace {

using namespace lanes;

constexpr int kMaxWarps = 4;  // most documents a thread block
// stats[b, :]: steps with work, deletes, delete iterations, inserts,
// splits, block copies, head reads from device memory; clock64 cycles in
// slot locates, in block copies, in delete passes, in inserts' locates
// and splices, in slot-table upkeep, in splits, in all steps; blocks in
// use at the end; 1 if the document's rows were in shared memory.
constexpr int kStats = 16;

// Ints of one warp's shared memory: the counters (kStats long longs, so
// even, keeping every region 8-byte aligned), the four slot tables and,
// with the rows on chip, the document's 2 x CAP rows.
__host__ __device__ __forceinline__ long long doc_ints(int CAP, int NBT,
                                                       bool chip) {
  return 2 * kStats + 4LL * NBT + (chip ? 2LL * CAP : 0LL);
}

// One document's replay state, held by its warp. CHIP: its rows are in
// shared memory. S: keep the counters.
template <bool CHIP, bool S>
struct Doc {
  long long* st;  // shared [kStats] counters (lane 0 keeps them)
  int* O;         // ordp rows [CAP]: shared memory, or device memory
  int* L;         // lenp rows [CAP]
  int *xo, *xl;   // device-memory scratch [K]: a copy of one block
  int *yo, *yl;   // device-memory scratch [K]: the whole-roll copy
  int *blk, *rws, *liv, *cliv;  // shared [NBT]
  int K, NB, NBT, WMAX;
  int nlog;
  int e0, e1;  // err rows 0, 1

  __device__ __forceinline__ void count(int i, long long v = 1) {
    if (S && (threadIdx.x & 31) == 0) st[i] += v;
  }
  __device__ __forceinline__ long long clk() const {
    return S ? clock64() : 0;
  }
};

__device__ __forceinline__ int trow(const int* t, int l, int n) {
  return row_or0(t, l, n);
}

// Source row of row j after a circular roll toward higher rows by a, for
// 0 <= j, a < n (roll_src without the division).
__device__ __forceinline__ int roll_from(int j, int a, int n) {
  const int s = j - a;
  return s < 0 ? s + n : s;
}

// Copy K rows (o, l) to (to, tl), with a __syncwarp on each side.
__device__ void copy_rows(const int* o, const int* l, int* to, int* tl,
                          int K) {
  __syncwarp();
  for (int j = lane_id(); j < K; j += 32) {
    to[j] = o[j];
    tl[j] = l[j];
  }
  __syncwarp();
}

// The rows of block b that a step edits, where they live. A block id
// outside [0, NB) (only a corrupt table names one) gets a copy of block 0
// that is never written back: gather_block reads block 0 there, and
// scatter_block writes nothing.
struct Blk {
  int* o;
  int* l;
};

template <bool CHIP, bool S>
__device__ Blk block_rows(Doc<CHIP, S>& d, int b) {
  if (b >= 0 && b < d.NB) return Blk{d.O + b * d.K, d.L + b * d.K};
  const long long c0 = d.clk();
  d.count(5);
  copy_rows(d.O, d.L, d.xo, d.xl, d.K);
  d.count(8, d.clk() - c0);
  return Blk{d.xo, d.xl};
}

// gather_head: row 0 of block b (block 0 for ids outside [0, NB)).
template <bool CHIP, bool S>
__device__ __forceinline__ int head_of(Doc<CHIP, S>& d, int b) {
  if (!CHIP) d.count(6);
  return d.O[((b >= 0 && b < d.NB) ? b : 0) * d.K];
}

// slot_of_live_rank: smallest logical slot whose live prefix reaches
// rank1 (slots at or past nlog masked), capped at nlog - 1.
template <bool CHIP, bool S>
__device__ int slot_of_live_rank(Doc<CHIP, S>& d, int rank1) {
  const long long c0 = d.clk();
  const int n = imin(d.nlog, d.NBT);
  int c = 0;
  for (int t0 = 0; t0 < n; t0 += 32) {
    const int t = t0 + lane_id();
    c += __popc(__ballot_sync(kFull, t < n && d.cliv[t] < rank1));
  }
  d.count(7, d.clk() - c0);
  return imin(c, d.nlog - 1);
}

template <bool CHIP, bool S>
__device__ __forceinline__ int live_before(const Doc<CHIP, S>& d, int l) {
  return trow(d.cliv, l, d.NBT) - trow(d.liv, l, d.NBT);
}

// Slot l's rows and live count, and the live prefix, after an op on its
// block: lane 0 writes the slot; the prefix moves over the slots in use
// (add_from of the TPU kernel, whose entries past nlog no read reaches).
template <bool CHIP, bool S>
__device__ void upkeep(Doc<CHIP, S>& d, int l, int drows, int dlive) {
  const long long c0 = d.clk();
  if (lane_id() == 0 && l >= 0 && l < d.NBT) {
    d.rws[l] += drows;
    d.liv[l] += dlive;
  }
  const int n = imin(d.nlog, d.NBT);
  for (int i = imax(l, 0) + lane_id(); i < n; i += 32) d.cliv[i] += dlive;
  __syncwarp();
  d.count(11, d.clk() - c0);
}

// The in-block count of the TPU kernel: i_r = the rows j < min(r0, K)
// whose inclusive live prefix is < x, over the K rows (O, L) of one block;
// with the prefix at i_r and the live count at i_r (0 at or past K, as
// row_or0 reads). Run lengths are never negative, so the prefix never
// decreases and the counted rows are the rows before the first one that
// reaches x: one warp sum a 32-row round, and a scan only of the round
// that crosses.
struct BLoc {
  int i_r, cum, v;
};

__device__ BLoc block_locate(const int* O, const int* L, int K, int r0,
                             int x) {
  const int lane = lane_id();
  int run = 0, c = K, cum_c = 0, v_c = 0;
  for (int j0 = 0; j0 < K; j0 += 32) {
    const int j = j0 + lane;
    const int v = j < K ? (O[j] > 0 ? L[j] : 0) : 0;
    const int sum = wsum(v);
    if (run + sum >= x) {
      const int inc = run + wscan(v);
      const unsigned m = __ballot_sync(kFull, j < K && inc >= x);
      const int f = __ffs(m) - 1;
      c = j0 + f;
      cum_c = __shfl_sync(kFull, inc, f);
      v_c = __shfl_sync(kFull, v, f);
      break;
    }
    run += sum;
  }
  BLoc r;
  r.i_r = imax(imin(c, r0), 0);
  if (r.i_r == c) {
    r.cum = cum_c;
    r.v = v_c;
  } else if (r.i_r >= K) {
    r.cum = r.v = 0;
  } else {  // the count stops at r0, before the crossing
    int pre = 0;
    for (int j = lane; j <= r.i_r; j += 32) pre += O[j] > 0 ? L[j] : 0;
    r.cum = wsum(pre);
    r.v = O[r.i_r] > 0 ? L[r.i_r] : 0;
  }
  return r;
}

// Rows j in [q, K) of a block take row j - a (a <= q), in place, top
// down, 32 rows a round: every lane reads its row before any lane writes,
// and a round reads only rows below those the rounds before it wrote. A
// splice of a rows at row q - a then writes rows [q - a, q): of a circular
// roll by a of the rows from q - a, only this shows (the rows it wraps
// land on rows the splice overwrites).
__device__ void shift_tail(int* bo, int* bl, int K, int q, int a) {
  const int lane = lane_id();
  __syncwarp();
  if (a > 0) {
    for (int top = K; top > q; top -= 32) {
      const int j = top - 1 - lane;
      int o = 0, l = 0;
      if (j >= q) {
        o = bo[j - a];
        l = bl[j - a];
      }
      __syncwarp();
      if (j >= q) {
        bo[j] = o;
        bl[j] = l;
      }
    }
  }
  __syncwarp();
}

// lane_apply_partial: run row i (signed start o, length ln) split around
// its covered live range [cs, ce): rows past i move down by the pieces'
// amt (of the circular roll only the shift shows: rows i + 1 .. i + amt
// take pieces), then the pieces land. Returns amt.
__device__ int apply_partial(int* bo, int* bl, int K, int i, int o, int ln,
                             int cs, int ce) {
  const Pieces p = split_pieces(o, ln, cs, ce);
  shift_tail(bo, bl, K, i + 1 + p.amt, p.amt);
  if (lane_id() == 0) {
    if (i >= 0 && i < K) {
      bo[i] = p.o0;
      bl[i] = p.l0;
    }
    if (p.amt >= 1 && i + 1 >= 0 && i + 1 < K) {
      bo[i + 1] = p.o1;
      bl[i + 1] = p.l1;
    }
    if (p.amt == 2 && i + 2 >= 0 && i + 2 < K) {
      bo[i + 2] = p.o2;
      bl[i + 2] = p.l2;
    }
  }
  __syncwarp();
  return p.amt;
}

// split: the top half of slot l's rows moves to the fresh physical block
// nlog at logical slot l + 1. At table capacity (nlog >= NB) it raises
// err[0] and does nothing.
template <bool CHIP, bool S>
__device__ void split(Doc<CHIP, S>& d, int l) {
  if (d.nlog >= d.NB) {
    d.e0 = 1;
    return;
  }
  const long long c0 = d.clk();
  d.count(4);
  const int K = d.K, NBT = d.NBT, lane = lane_id();
  const int b = trow(d.blk, l, NBT), r = trow(d.rws, l, NBT);
  const int keep = floordiv(r, 2), mv = r - keep, nbv = d.nlog;
  const bool real = b >= 0 && b < d.NB;
  const int bc = real ? b : 0;
  // The moved half is read from the old block; a table that names the
  // fresh block as slot l's (only a corrupt one) has it read from a copy.
  const bool same = nbv == bc;
  const int* so = d.O + bc * K;
  const int* sl = d.L + bc * K;
  if (same) {
    d.count(5);
    copy_rows(so, sl, d.xo, d.xl, K);
    so = d.xo;
    sl = d.xl;
  }
  int lh = 0;
  for (int j = keep + lane; j < imin(r, K); j += 32)
    if (j >= 0) lh += so[j] > 0 ? sl[j] : 0;
  const int liv_hi = wsum(lh);
  const int up = roll_amount(keep, K, K);
  int* no = d.O + nbv * K;  // nbv < NB: always in range
  int* nl = d.L + nbv * K;
  // scatter_block2: the kept half to b, then the moved half to nbv (it
  // wins where the two coincide); the moved half goes first where they
  // do not, while the old block still holds it.
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == (same ? 1 : 0)) {
      for (int j = lane; j < K; j += 32) {
        no[j] = j < mv ? so[(j + up) % K] : 0;
        nl[j] = j < mv ? sl[(j + up) % K] : 0;
      }
    } else if (real) {
      for (int j = imax(keep, 0) + lane; j < K; j += 32) {
        d.O[b * K + j] = 0;
        d.L[b * K + j] = 0;
      }
    }
    __syncwarp();
  }
  // Slots after l move one down (a circular roll masked to rows > l), in
  // place, top down, the four tables in one pass.
  for (int top = NBT; top > l + 1; top -= 32) {
    const int i = top - 1 - lane;
    const bool moved = i > l && i >= 1;
    int vb = 0, vr = 0, vl = 0, vc = 0;
    if (moved) {
      vb = d.blk[i - 1];
      vr = d.rws[i - 1];
      vl = d.liv[i - 1];
      vc = d.cliv[i - 1];
    }
    __syncwarp();
    if (moved) {
      d.blk[i] = vb;
      d.rws[i] = vr;
      d.liv[i] = vl;
      d.cliv[i] = vc;
    }
  }
  __syncwarp();
  if (lane == 0) {
    if (l >= 0 && l < NBT) {
      d.rws[l] = keep;
      d.liv[l] -= liv_hi;
      d.cliv[l] -= liv_hi;
    }
    if (l + 1 >= 0 && l + 1 < NBT) {
      d.rws[l + 1] = mv;
      d.liv[l + 1] = liv_hi;
      d.blk[l + 1] = nbv;
    }
  }
  __syncwarp();
  d.nlog += 1;
  d.count(12, d.clk() - c0);
}

// do_delete: tombstone dl live chars after live rank p, block by block.
template <bool CHIP, bool S>
__device__ void do_delete(Doc<CHIP, S>& d, int p, int dl) {
  const int K = d.K, lane = lane_id();
  int rem = dl;
  for (int iters = 0; rem > 0 && iters <= 2 * d.NBT; ++iters) {
    d.count(2);
    int l = slot_of_live_rank(d, p + 1);
    if (trow(d.rws, l, d.NBT) + 2 > K) {
      split(d, l);
      l = slot_of_live_rank(d, p + 1);
    }
    const int base = live_before(d, l);
    const Blk w = block_rows(d, trow(d.blk, l, d.NBT));
    const long long c0 = d.clk();
    // 32 rows a round with their live prefix from one scan; a round that
    // ends at or before p or starts at or past p + rem covers nothing. The
    // at most two partly covered runs (the range's ends) are kept in
    // registers: row, run and covered range.
    int run = 0, tot = 0, np = 0;
    int i1 = K, o1 = 0, n1 = 0, cs1 = 0, ce1 = 0;
    int i2 = -1, o2 = 0, n2 = 0, cs2 = 0, ce2 = 0;
    for (int j0 = 0; j0 < K; j0 += 32) {
      const int j = j0 + lane;
      const int bo = j < K ? w.o[j] : 0, bl = j < K ? w.l[j] : 0;
      const int lv = bo > 0 ? bl : 0;
      const int sum = wsum(lv);
      if (base + run + sum > p && base + run < p + rem) {
        const int before = base + run + wscan(lv) - lv;
        const int cs = imin(imax(p - before, 0), lv);
        const int ce = imin(imax(p + rem - before, 0), lv);
        const int cov = ce - cs;
        tot += cov;
        const bool full = cov > 0 && cov == bl;
        const bool part = cov > 0 && !full;
        if (full) w.o[j] = -bo;
        const unsigned m = __ballot_sync(kFull, part);
        if (m != 0) {
          const int f = __ffs(m) - 1, g = 31 - __clz(m);
          const int fo = __shfl_sync(kFull, bo, f);
          const int fl = __shfl_sync(kFull, bl, f);
          const int fcs = __shfl_sync(kFull, cs, f);
          const int fce = __shfl_sync(kFull, ce, f);
          if (np == 0) {
            i1 = j0 + f;
            o1 = fo;
            n1 = fl;
            cs1 = fcs;
            ce1 = fce;
          }
          i2 = j0 + g;
          o2 = __shfl_sync(kFull, bo, g);
          n2 = __shfl_sync(kFull, bl, g);
          cs2 = __shfl_sync(kFull, cs, g);
          ce2 = __shfl_sync(kFull, ce, g);
          np += __popc(m);
        }
      }
      run += sum;
    }
    tot = wsum(tot);
    __syncwarp();
    int a2 = 0, a1 = 0;
    if (np >= 1) a2 = apply_partial(w.o, w.l, K, i2, o2, n2, cs2, ce2);
    if (np == 2) a1 = apply_partial(w.o, w.l, K, i1, o1, n1, cs1, ce1);
    d.count(9, d.clk() - c0);
    upkeep(d, l, a1 + a2, -tot);
    rem -= tot;
  }
  if (rem > 0) d.e1 = 1;
}

// The fused W-row insert splice of a block (fused_splice_rows with one
// active lane), in place. Returns amt; sets is_split.
template <bool CHIP, bool S>
__device__ int fused_splice(Doc<CHIP, S>& d, const Blk& w, int p, int i_r,
                            int o_r, int l_r, int off, int il, int st,
                            int wd, bool& is_split) {
  const int K = d.K;
  const int lrun = floordiv(il, imax(wd, 1));
  const bool mrg = wd == 1 && p > 0 && off == l_r && st + 1 == o_r + l_r;
  is_split = p > 0 && off < l_r;
  const int ins_at = p == 0 ? 0 : i_r + 1;
  const int amt = mrg ? 0 : wd + (int)is_split;
  const int ra = roll_amount(amt, d.WMAX + 1, K);
  if (ra == amt) {
    // Rows [ins_at, ins_at + amt) all take new runs or the split tail, so
    // of the circular roll only the shift of the rows past them shows.
    shift_tail(w.o, w.l, K, ins_at + amt, amt);
    for (int j = ins_at + lane_id(); j < ins_at + amt && j < K; j += 32) {
      if (j < ins_at + wd) {
        w.o[j] = st + il - (j - ins_at + 1) * lrun + 1;
        w.l[j] = lrun;
      } else {  // is_split: the tail at ins_at + wd
        w.o[j] = o_r + off;
        w.l[j] = l_r - off;
      }
    }
    if (lane_id() == 0 && i_r >= 0 && i_r < K) {
      if (is_split) w.l[i_r] = off;
      if (mrg) w.l[i_r] = l_r + il;
    }
    __syncwarp();
    return amt;
  }
  // A step wider than the stream's WMAX (or than K) rolls by other than
  // amt, as the TPU kernel's one-roll-per-bit shift does: the whole roll,
  // from a copy of the block.
  const long long c0 = d.clk();
  d.count(5);
  copy_rows(w.o, w.l, d.yo, d.yl, K);
  d.count(8, d.clk() - c0);
  for (int j = lane_id(); j < K; j += 32) {
    int no = d.yo[j], nl = d.yl[j];
    if (j >= ins_at) {
      const int s = roll_from(j, ra, K);
      no = d.yo[s];
      nl = d.yl[s];
    }
    if (is_split && j == i_r) nl = off;
    if (!mrg && j >= ins_at && j < ins_at + wd) {
      no = st + il - (j - ins_at + 1) * lrun + 1;
      nl = lrun;
    }
    if (is_split && j == ins_at + wd) {
      no = o_r + off;
      nl = l_r - off;
    }
    if (mrg && j == i_r) nl = l_r + il;
    w.o[j] = no;
    w.l[j] = nl;
  }
  __syncwarp();
  return amt;
}

// do_insert: live-rank insert; returns the op's origins.
template <bool CHIP, bool S>
__device__ void do_insert(Doc<CHIP, S>& d, int p, int il, int st, int wd,
                          int& ol_out, int& or_out) {
  const int K = d.K, NBT = d.NBT;
  int l = p == 0 ? 0 : slot_of_live_rank(d, p);
  if (trow(d.rws, l, NBT) + wd + 1 > K) {
    split(d, l);
    l = p == 0 ? 0 : slot_of_live_rank(d, p);
  }
  const int r0 = trow(d.rws, l, NBT);
  const int local = p - live_before(d, l);
  const Blk w = block_rows(d, trow(d.blk, l, NBT));
  const long long c0 = d.clk();
  const BLoc lc = block_locate(w.o, w.l, K, r0, local);
  const int i_r = lc.i_r;
  const int o_r = row_or0(w.o, i_r, K), l_r = row_or0(w.l, i_r, K);
  const int off = local - (lc.cum - lc.v);
  const int left = p == 0 ? kRoot : (o_r - 1) + (off - 1);
  // Successor reads come from the pre-splice state.
  const int nxt_in_blk = row_or0(w.o, i_r + 1, K);
  const int nxt_slot_o = head_of(d, trow(d.blk, imin(l + 1, NBT - 1), NBT));
  const int first_o = head_of(d, trow(d.blk, 0, NBT));
  const int succ_p0 = trow(d.rws, 0, NBT) > 0 ? first_o : 0;
  bool is_split;
  const int amt = fused_splice(d, w, p, i_r, o_r, l_r, off, il, st, wd,
                               is_split);
  const int succ_after =
      i_r + 1 < r0 ? nxt_in_blk : (l + 1 < d.nlog ? nxt_slot_o : 0);
  const int succ = p == 0 ? succ_p0 : (is_split ? o_r + off : succ_after);
  d.count(10, d.clk() - c0);
  upkeep(d, l, amt, il);
  ol_out = left;
  or_out = succ == 0 ? kRoot : iabs(succ) - 1;
}

// One document's replay: its slot tables in, the step chain (each step's
// op read one step ahead: nothing in a step waits for it), its tables,
// origins, errors and counters out. `my` is the warp's shared memory.
template <bool CHIP, bool S>
__device__ void replay(int* my, int b, const int* __restrict__ pos,
                       const int* __restrict__ dlen,
                       const int* __restrict__ ilen,
                       const int* __restrict__ start,
                       const int* __restrict__ wcol,
                       const int* __restrict__ nlog0,
                       const int* __restrict__ blk0,
                       const int* __restrict__ rws0,
                       const int* __restrict__ liv0, int* __restrict__ ol,
                       int* __restrict__ orr, int* __restrict__ nlog_out,
                       int* __restrict__ blk_out, int* __restrict__ rws_out,
                       int* __restrict__ liv_out, int* __restrict__ err,
                       int* wsO, int* wsL, int* bscr,
                       long long* __restrict__ stats, int NS, int B, int CAP,
                       int K, int NBT, int WMAX) {
  const int lane = lane_id();
  Doc<CHIP, S> d;
  d.st = reinterpret_cast<long long*>(my);
  if (S && lane < kStats) d.st[lane] = 0;
  int* tabs = my + 2 * kStats;
  d.blk = tabs;
  d.rws = tabs + NBT;
  d.liv = tabs + 2 * NBT;
  d.cliv = tabs + 3 * NBT;
  d.O = CHIP ? tabs + 4 * NBT : wsO + (long long)b * CAP;
  d.L = CHIP ? tabs + 4 * NBT + CAP : wsL + (long long)b * CAP;
  int* sc = bscr + (long long)b * 4 * K;
  d.xo = sc;
  d.xl = sc + K;
  d.yo = sc + 2 * K;
  d.yl = sc + 3 * K;
  d.K = K;
  d.NB = CAP / K;
  d.NBT = NBT;
  d.WMAX = WMAX;
  d.nlog = imax(nlog0[b], 1);  // a fresh lane holds one empty block
  d.e0 = d.e1 = 0;
  for (int i = lane; i < NBT; i += 32) {
    const long long g = (long long)i * B + b;
    d.blk[i] = blk0[g];
    d.rws[i] = rws0[g];
    d.liv[i] = liv0[g];
  }
  __syncwarp();
  wprefix(d.liv, d.cliv, NBT);

  const long long t0 = d.clk();
  int np = 0, nd = 0, ni = 0, ns = 0, nw = 0;
  if (NS > 0) {
    np = pos[b];
    nd = dlen[b];
    ni = ilen[b];
    ns = start[b];
    nw = wcol[b];
  }
  for (int k = 0; k < NS; ++k) {
    const long long g = (long long)k * B + b;
    const int p = np, dl = nd, il = ni, st = ns;
    const int wd = imax(nw, 1);  // pad rows carry 0
    if (k + 1 < NS) {
      np = pos[g + B];
      nd = dlen[g + B];
      ni = ilen[g + B];
      ns = start[g + B];
      nw = wcol[g + B];
    }
    int ol_v = 0, or_v = 0;
    if (dl > 0 || il > 0) d.count(0);
    if (dl > 0) {
      d.count(1);
      do_delete(d, p, dl);
    }
    if (il > 0) {
      d.count(3);
      do_insert(d, p, il, st, wd, ol_v, or_v);
    }
    if (lane == 0) {
      ol[g] = ol_v;
      orr[g] = or_v;
    }
  }
  d.count(13, d.clk() - t0);

  __syncwarp();
  for (int i = lane; i < NBT; i += 32) {
    const long long g = (long long)i * B + b;
    blk_out[g] = d.blk[i];
    rws_out[g] = d.rws[i];
    liv_out[g] = d.liv[i];
  }
  if (S && lane == 0) {
    d.st[14] = d.nlog;
    d.st[15] = CHIP ? 1 : 0;
    for (int q = 0; q < kStats; ++q) stats[(long long)b * kStats + q] = d.st[q];
  }
  if (lane == 0) {
    nlog_out[b] = d.nlog;
    const int e[8] = {d.e0, d.e1, 0, 0, 0, 0, 0, 0};
    for (int r = 0; r < 8; ++r) err[(long long)r * B + b] = e[r];
  }
}

// A thread block replays documents b0 .. b0 + nw - 1, one a warp. With
// the rows on chip, the block copies its documents' columns of the public
// planes into shared memory and back: a warp's load covers 32 / nw rows
// of all nw documents, neighbours on neighbouring addresses.
template <bool CHIP, bool S>
__global__ void __launch_bounds__(32 * kMaxWarps, 4) lanes_blocked_kernel(
    const int* __restrict__ pos, const int* __restrict__ dlen,
    const int* __restrict__ ilen, const int* __restrict__ start,
    const int* __restrict__ wcol, const int* __restrict__ ord0,
    const int* __restrict__ len0, const int* __restrict__ nlog0,
    const int* __restrict__ blk0, const int* __restrict__ rws0,
    const int* __restrict__ liv0, int* __restrict__ ol,
    int* __restrict__ orr, int* __restrict__ ordp, int* __restrict__ lenp,
    int* __restrict__ nlog_out, int* __restrict__ blk_out,
    int* __restrict__ rws_out, int* __restrict__ liv_out,
    int* __restrict__ err, int* wsO, int* wsL, int* bscr,
    long long* __restrict__ stats, int NS, int B, int CAP, int K, int NBT,
    int WMAX) {
  extern __shared__ int smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * nw;
  const long long per_doc = doc_ints(CAP, NBT, CHIP);
  const long long rows_at = 2 * kStats + 4LL * NBT;  // a document's rows
  const int cw = threadIdx.x % nw;  // the column a thread copies
  if (CHIP && b0 + cw < B) {
    int* so = smem + cw * per_doc + rows_at;
#pragma unroll 4
    for (int i = threadIdx.x / nw; i < CAP; i += 32) {
      const long long g = (long long)i * B + b0 + cw;
      so[i] = ord0[g];
      so[CAP + i] = len0[g];
    }
  }
  if (CHIP) __syncthreads();
  if (b0 + warp < B)  // whole warps only: no collective is split
    replay<CHIP, S>(smem + warp * per_doc, b0 + warp, pos, dlen, ilen, start,
                    wcol, nlog0, blk0, rws0, liv0, ol, orr, nlog_out,
                    blk_out, rws_out, liv_out, err, wsO, wsL, bscr, stats, NS,
                    B, CAP, K, NBT, WMAX);
  if (CHIP) __syncthreads();
  if (CHIP && b0 + cw < B) {
    const int* so = smem + cw * per_doc + rows_at;
#pragma unroll 4
    for (int i = threadIdx.x / nw; i < CAP; i += 32) {
      const long long g = (long long)i * B + b0 + cw;
      ordp[g] = so[i];
      lenp[g] = so[CAP + i];
    }
  }
}

using KernelFn = decltype(&lanes_blocked_kernel<true, true>);

KernelFn pick_kernel(bool chip, bool stats) {
  if (chip)
    return stats ? lanes_blocked_kernel<true, true>
                 : lanes_blocked_kernel<true, false>;
  return stats ? lanes_blocked_kernel<false, true>
               : lanes_blocked_kernel<false, false>;
}

}  // namespace

// `warps` documents a thread block (1-4); `on_chip`: each document's rows
// in shared memory (scratch then holds only 4 K-row block copies a
// document) or in lane-major planes in device memory (scratch: the two
// [B, CAP] planes, then the block copies); `stats` an int64 [B, kStats]
// array or null.
extern "C" int rle_lanes_blocked_launch(
    const int* pos, const int* dlen, const int* ilen, const int* start,
    const int* wcol, const int* ord0, const int* len0, const int* nlog0,
    const int* blk0, const int* rws0, const int* liv0, int* ol, int* orr,
    int* ordp, int* lenp, int* nlog, int* blk, int* rws, int* liv, int* err,
    int* scratch, long long* stats, int S, int B, int CAP, int K, int NBT,
    int WMAX, int warps, int on_chip, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const bool chip = on_chip != 0;
  int* wsO = scratch;
  int* wsL = scratch + (long long)B * CAP;
  int* bscr = chip ? scratch : scratch + 2LL * B * CAP;
  if (!chip) {
    lanes::launch_transpose(ord0, wsO, CAP, B, st);
    lanes::launch_transpose(len0, wsL, CAP, B, st);
  }
  const size_t smem = (size_t)warps * doc_ints(CAP, NBT, chip) * sizeof(int);
  const KernelFn kern = pick_kernel(chip, stats != nullptr);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(B + warps - 1) / warps, 32 * warps, smem, st>>>(
      pos, dlen, ilen, start, wcol, ord0, len0, nlog0, blk0, rws0, liv0, ol,
      orr, ordp, lenp, nlog, blk, rws, liv, err, wsO, wsL, bscr, stats, S, B,
      CAP, K, NBT, WMAX);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (!chip) {
    lanes::launch_transpose(wsO, ordp, B, CAP, st);
    lanes::launch_transpose(wsL, lenp, B, CAP, st);
  }
  return (int)cudaGetLastError();
}

// Thread blocks of `warps` documents that one SM holds at once (0 on
// error).
extern "C" int rle_lanes_blocked_blocks_per_sm(int warps, int CAP, int NBT,
                                               int on_chip) {
  const bool chip = on_chip != 0;
  const int smem = warps * (int)doc_ints(CAP, NBT, chip) * (int)sizeof(int);
  const KernelFn kern = pick_kernel(chip, false);
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, 32 * warps,
                                                      smem);
  return e == cudaSuccess ? n : 0;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
