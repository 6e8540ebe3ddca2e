// One document's run column kept on chip by one warp: the shared machinery
// of the two un-blocked per-lane replays (rle_lanes.cu, local edits;
// rle_lanes_mixed.cu, local and remote ops).
//
// A column is two planes of CAP rows, O = ±(start_order+1) and L = length.
// A warp keeps the first `sh` rows of its document's column in shared
// memory for the whole launch (the wrapper sizes sh: all CAP rows where
// every document of the launch then fits the card at once, else the share
// of shared memory that lets them, so that a capacity sized for the worst
// case does not halve residency). A column whose extent passes sh, at the
// start or after a splice, moves to the lane-major planes in device
// memory for the rest of the launch, where the same passes run (sh = 0:
// the whole launch there). Nothing else is kept per row: live counts,
// prefix sums and the covered ranges of a delete are registers, computed
// where they are used.
//
// The extent `hi` is the first row past which every row of O and L is 0.
// It is found from the input when the launch starts and grows with each
// splice (to at most CAP), and every pass runs over [0, hi): the rows past
// it add 0 to every sum and match no order, so the result is the TPU
// kernel's whole-column pass for any input, including stale rows past
// `rows` and a column whose `rows` passed CAP after an overflow. A read of
// one row past the extent is 0 without a memory access (`at`).
//
// Run lengths are never negative (no op writes one), so the live and raw
// prefix sums never decrease along the column. The locate and the YATA
// walk use that: the rows whose prefix is below p are the rows before the
// first one whose prefix reaches p.
//
// A splice of `a` rows at row q overwrites rows [q, q + a), so of the TPU
// kernel's circular roll by r = roll_amount(..) only "row j >= q + a takes
// row j - r" shows (r <= a): rows move top down, in place, over [q + a,
// min(CAP, hi + r)), and rows that move past CAP are lost, as the roll
// wraps them onto rows the splice then overwrites.
//
// Every helper that writes the column opens with __syncwarp (a lane may
// still be reading a row that another lane is about to write) and closes
// with one (the next reader may be another lane).
#pragma once

#include "lanes_mixed.cuh"

namespace lanecol {

using namespace lanes;

struct Col {
  int* O;  // the rows: shared memory, or gO/gL
  int* L;
  int* gO;  // the document's lane-major planes in device memory
  int* gL;
  int CAP, WMAX;
  int lim;  // rows that O and L hold (sh in shared memory, else CAP)
  int rows, hi;
  int e0, e1, e2;
};

__device__ __forceinline__ int live_of(int o, int l) { return o > 0 ? l : 0; }

// Row r of a plane: 0 outside [0, hi) (row_or0 of the TPU kernels, whose
// rows past the extent are 0).
__device__ __forceinline__ int at(const int* x, int r, int hi) {
  return (r >= 0 && r < hi) ? x[r] : 0;
}

// Open document b's column: its extent over all CAP rows of the
// lane-major planes, and its first sh rows copied into the warp's shared
// memory `s` (O, then L) when the extent fits them (returns true); else it
// stays in device memory.
__device__ bool open_column(Col& c, int* gO, int* gL, int* s, int sh) {
  c.gO = gO;
  c.gL = gL;
  int top = 0;
  for (int i = lane_id(); i < c.CAP; i += 32) {
    const int o = gO[i], l = gL[i];
    if (i < sh) {
      s[i] = o;
      s[sh + i] = l;
    }
    if (o != 0 || l != 0) top = i + 1;
  }
  c.hi = wmax(top);
  const bool on_chip = sh > 0 && c.hi <= sh;
  c.O = on_chip ? s : gO;
  c.L = on_chip ? s + sh : gL;
  c.lim = on_chip ? sh : c.CAP;
  __syncwarp();
  return on_chip;
}

// Write a column still in shared memory back to its planes: rows [0, hi)
// (the planes' rows past it are the input's, past its extent: 0).
__device__ void close_column(const Col& c) {
  __syncwarp();
  if (c.O == c.gO) return;
  for (int i = lane_id(); i < c.hi; i += 32) {
    c.gO[i] = c.O[i];
    c.gL[i] = c.L[i];
  }
}

// The rows a step may write at most: a delete's two splits add <= 4 rows
// past the extent, an insert <= w + 1 past max(extent, rows + 1) (its row
// count stops at `rows`), a remote op fewer.
__device__ __forceinline__ int step_room(const Col& c, int w) {
  return imin(c.CAP, imax(c.hi, clampi(c.rows, 0, c.CAP) + 1) + w + 5);
}

// A column in shared memory that a step could outgrow moves to its planes
// in device memory for the rest of the launch (their rows past the extent
// are the input's, past its extent: 0).
__device__ void move_to_device(Col& c) {
  __syncwarp();
  for (int i = lane_id(); i < c.hi; i += 32) {
    c.gO[i] = c.O[i];
    c.gL[i] = c.L[i];
  }
  __syncwarp();
  c.O = c.gO;
  c.L = c.gL;
  c.lim = c.CAP;
}

// Rows [s0, s1) of a lane in the contiguous split of [0, hi): chunks of an
// odd number of rows, so the 32 lanes' rows at one step lie in 32 banks.
__device__ __forceinline__ int chunk_rows(int hi) {
  return ((hi + 31) >> 5) | 1;
}

// Sum over [0, lim) (lim <= hi) of the live counts (LIVE) or lengths.
template <bool LIVE>
__device__ __forceinline__ int prefix_to(const Col& c, int lim) {
  int s = 0;
  for (int i = lane_id(); i < lim; i += 32)
    s += LIVE ? live_of(c.O[i], c.L[i]) : c.L[i];
  return wsum(s);
}

// The locate of an insert: i_r = the rows i < rows whose inclusive prefix
// of live counts (LIVE) or lengths is < p (STRICT) or <= p, with that
// prefix and the value at row i_r (both 0 at or past CAP, as row_or0
// reads). Each lane sums its chunk, one warp scan finds the chunk where
// the prefix crosses, and a scan over that chunk's rows finds the row.
struct Loc {
  int i_r, cum, v;
};

template <bool LIVE, bool STRICT>
__device__ __forceinline__ Loc locate(const Col& c, int p) {
  const int lane = lane_id(), hi = c.hi, CAP = c.CAP, cr = chunk_rows(hi);
  const int s0 = imin(lane * cr, hi), s1 = imin(s0 + cr, hi);
  int sum = 0;
#pragma unroll 4
  for (int i = s0; i < s1; ++i)
    sum += LIVE ? live_of(c.O[i], c.L[i]) : c.L[i];
  const int incl = wscan(sum);
  const int total = __shfl_sync(kFull, incl, 31);
  const unsigned m =
      __ballot_sync(kFull, s0 < s1 && (STRICT ? incl >= p : incl > p));
  int k, cum_k, v_k;
  if (m) {
    const int own = __ffs(m) - 1;
    const int o0 = own * cr, o1 = imin(o0 + cr, hi);
    int base = __shfl_sync(kFull, incl - sum, own);
    k = o1;
    cum_k = v_k = 0;
    for (int g = o0; g < o1; g += 32) {
      const int j = g + lane;
      const int v = j < o1 ? (LIVE ? live_of(c.O[j], c.L[j]) : c.L[j]) : 0;
      const int x = base + wscan(v);
      const unsigned mm =
          __ballot_sync(kFull, j < o1 && (STRICT ? x >= p : x > p));
      if (mm) {
        const int f = __ffs(mm) - 1;
        k = g + f;
        cum_k = __shfl_sync(kFull, x, f);
        v_k = __shfl_sync(kFull, v, f);
        break;
      }
      base = __shfl_sync(kFull, x, 31);
    }
  } else {
    // No row of [0, hi) crosses; the rows past hi hold the total.
    k = (STRICT ? total >= p : total > p) ? hi : CAP;
    cum_k = k < CAP ? total : 0;
    v_k = 0;
  }
  const int rows_c = clampi(c.rows, 0, CAP);
  Loc r;
  if (k <= rows_c) {
    r.i_r = k;
    r.cum = cum_k;
    r.v = v_k;
  } else {  // the count stops at `rows` (stale rows past it)
    r.i_r = rows_c;
    if (rows_c >= hi) {
      r.cum = rows_c < CAP ? total : 0;
      r.v = 0;
    } else {
      r.cum = prefix_to<LIVE>(c, rows_c + 1);
      r.v = LIVE ? live_of(c.O[rows_c], c.L[rows_c]) : c.L[rows_c];
    }
  }
  return r;
}

// Rows j in [q + a, min(CAP, hi + r)) take row j - r (r <= a), top down,
// 128 rows a round: every lane reads its four rows before any lane
// writes, and a round reads only rows below those the rounds before it
// wrote. The caller then writes rows [q, q + a).
__device__ __forceinline__ void shift_down(Col& c, int q, int a,
                                           int r) {
  const int d0 = q + a, d1 = imin(c.CAP, c.hi + r), lane = lane_id();
  __syncwarp();
  if (r > 0) {
    for (int top = d1; top > d0; top -= 128) {
      int vo[4], vl[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = top - 1 - (u * 32 + lane);
        if (j >= d0) {
          vo[u] = c.O[j - r];
          vl[u] = c.L[j - r];
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = top - 1 - (u * 32 + lane);
        if (j >= d0) {
          c.O[j] = vo[u];
          c.L[j] = vl[u];
        }
      }
    }
  }
  __syncwarp();
  c.hi = imin(c.CAP, imax(c.hi + r, d0));
}

// apply_partial: split row i (covered over [cs, ce)) into its <= 3
// pieces, the rows past it moving down by the pieces added.
__device__ __forceinline__ int apply_partial(Col& c, int i, int cs,
                                            int ce) {
  __syncwarp();
  const int CAP = c.CAP;
  const Pieces p =
      split_pieces(at(c.O, i, c.hi), at(c.L, i, c.hi), cs, ce);
  shift_down(c, i + 1, p.amt, p.amt);
  if (lane_id() == 0) {
    if (i >= 0 && i < CAP) {
      c.O[i] = p.o0;
      c.L[i] = p.l0;
    }
    if (p.amt >= 1 && i + 1 < CAP) {
      c.O[i + 1] = p.o1;
      c.L[i + 1] = p.l1;
    }
    if (p.amt == 2 && i + 2 < CAP) {
      c.O[i + 2] = p.o2;
      c.L[i + 2] = p.l2;
    }
  }
  __syncwarp();
  return p.amt;
}

// The partly covered rows of a delete, kept per lane as the lowest and
// highest with their covered ranges, then joined over the warp.
struct Partial {
  int n, i1, cs1, ce1, i2, cs2, ce2;

  __device__ __forceinline__ void init(int CAP) {
    n = 0;
    i1 = CAP;
    i2 = -1;
    cs1 = ce1 = cs2 = ce2 = 0;
  }
  __device__ __forceinline__ void add(int i, int cs, int ce) {
    ++n;
    if (i < i1) {
      i1 = i;
      cs1 = cs;
      ce1 = ce;
    }
    if (i > i2) {
      i2 = i;
      cs2 = cs;
      ce2 = ce;
    }
  }
  // Warp-wide: the count, and the lowest and highest rows with the
  // covered ranges of the lanes that saw them.
  __device__ __forceinline__ void join() {
    n = wsum(n);
    const int g1 = wmin(i1), g2 = wmax(i2);
    const int l1 = __ffs(__ballot_sync(kFull, i1 == g1)) - 1;
    const int l2 = __ffs(__ballot_sync(kFull, i2 == g2)) - 1;
    cs1 = __shfl_sync(kFull, cs1, l1);
    ce1 = __shfl_sync(kFull, ce1, l1);
    cs2 = __shfl_sync(kFull, cs2, l2);
    ce2 = __shfl_sync(kFull, ce2, l2);
    i1 = g1;
    i2 = g2;
  }
  // The splits of the TPU kernel: the highest row, then the lowest when
  // there are exactly two. Returns the rows added.
  __device__ __forceinline__ int apply(Col& c) const {
    int a = 0;
    if (n >= 1) a += apply_partial(c, i2, cs2, ce2);
    if (n == 2) a += apply_partial(c, i1, cs1, ce1);
    return a;
  }
};

// do_delete / do_local_delete: tombstone d live chars after live rank p.
// Each lane sums the live counts of its chunk; one scan gives each lane
// the live prefix before its chunk, and the lane walks its rows with it.
__device__ __forceinline__ void local_delete(Col& c, int p, int d) {
  const int lane = lane_id(), hi = c.hi, cr = chunk_rows(hi);
  if (c.rows + 2 > c.CAP) c.e0 = 1;
  const int s0 = imin(lane * cr, hi), s1 = imin(s0 + cr, hi);
  int sum = 0;
#pragma unroll 4
  for (int i = s0; i < s1; ++i) sum += live_of(c.O[i], c.L[i]);
  int before = wscan(sum) - sum;
  int tot = 0;
  Partial part;
  part.init(c.CAP);
  __syncwarp();
  for (int i = s0; i < s1; ++i) {
    const int bo = c.O[i], bl = c.L[i], lv = live_of(bo, bl);
    const int cs = imin(imax(p - before, 0), lv);
    const int ce = imin(imax(p + d - before, 0), lv);
    const int cov = ce - cs;
    tot += cov;
    const bool full = cov > 0 && cov == bl;
    if (cov > 0 && !full) part.add(i, cs, ce);
    if (full) c.O[i] = -bo;
    before += lv;
  }
  tot = wsum(tot);
  part.join();
  __syncwarp();
  if (tot < d) c.e1 = 1;
  c.rows += part.apply(c);
}

// The origins and run stride of a local insert.
struct LocalIns {
  int left, right, lrun;
};

// do_insert / do_local_insert: the fused W-row splice at live rank p.
__device__ __forceinline__ LocalIns local_insert(Col& c, int p, int il,
                                                 int st, int w) {
  const int CAP = c.CAP, lane = lane_id(), rows = c.rows;
  if (rows + w + 1 > CAP) c.e0 = 1;
  const Loc lc = locate<true, true>(c, p);
  const int i_r = lc.i_r;
  const int o_r = at(c.O, i_r, c.hi), l_r = at(c.L, i_r, c.hi);
  const int off = p - (lc.cum - lc.v);
  LocalIns r;
  r.left = p == 0 ? kRoot : (o_r - 1) + (off - 1);
  r.lrun = floordiv(il, imax(w, 1));
  const bool mrg = w == 1 && p > 0 && off == l_r && st + 1 == o_r + l_r;
  const bool is_split = p > 0 && off < l_r;
  const int ins_at = p == 0 ? 0 : i_r + 1;
  const int amt = mrg ? 0 : w + (int)is_split;
  const int nxt = at(c.O, i_r + 1, c.hi), first_o = at(c.O, 0, c.hi);
  shift_down(c, ins_at, amt, roll_amount(amt, c.WMAX + 1, CAP));
  if (!mrg)
    for (int j = ins_at + lane; j < ins_at + w && j < CAP; j += 32) {
      c.O[j] = st + il - (j - ins_at + 1) * r.lrun + 1;
      c.L[j] = r.lrun;
    }
  if (lane == 0 && i_r < CAP) {
    if (is_split) c.L[i_r] = off;
    if (mrg) c.L[i_r] = l_r + il;
  }
  if (lane == 0 && is_split && ins_at + w < CAP) {
    c.O[ins_at + w] = o_r + off;
    c.L[ins_at + w] = l_r - off;
  }
  __syncwarp();
  if ((is_split || mrg) && i_r < CAP) c.hi = imax(c.hi, i_r + 1);
  const int succ_p0 = rows > 0 ? first_o : 0;
  const int succ_after = i_r + 1 < rows ? nxt : 0;
  const int succ = p == 0 ? succ_p0 : (is_split ? o_r + off : succ_after);
  r.right = succ == 0 ? kRoot : iabs(succ) - 1;
  c.rows = rows + amt;
  return r;
}

// The ops of one step, loaded 32 steps at a time (lane u holds step
// k0 + u) and broadcast from that lane.
__device__ __forceinline__ int bcast(int v, int u) {
  return __shfl_sync(kFull, v, u);
}

}  // namespace lanecol
