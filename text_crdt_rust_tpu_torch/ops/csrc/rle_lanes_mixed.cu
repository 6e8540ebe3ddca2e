// Un-blocked per-lane mixed replay (divergent documents, local and remote
// ops), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// text_crdt_rust_tpu/ops/rle_lanes_mixed.py::_mixed_lanes_kernel and
// computes what it computes, bit for bit, on all eight outputs. The plain
// PyTorch version of the same function is
// text_crdt_rust_tpu_torch/ops/rle_lanes_mixed.py::lanes_mixed_replay_plain;
// the two are held against each other on the card. Each function below
// carries the name of its counterpart in both.
//
// What it computes. B different documents each replay their own op stream
// (kind LOCAL, REMOTE_INS or REMOTE_DEL, one op per document per step).
// A document is one column of RLE runs, ordp = ±(start_order+1) and lenp =
// length, packed at the front (rows in use: `rows`). Every op works on the
// whole column: order lookups are one range test over all rows, positions
// come from a prefix sum, splices shift the rows past the edit by a
// circular roll (as pltpu.roll does: a column that overflows its capacity
// wraps, and the capacity flag says so). By-order tables oll/orl are
// carried across launches (the prefill delta merges in at step 0), rkl is
// read-only. Remote inserts integrate by the run-level YATA walk; remote
// deletes are one interval pass that flips full covers and splits the at
// most two partial ends. err row 0: capacity; row 1: a bad delete; row 2:
// an order miss.
//
// Mapping. One warp per document, four documents per thread block. The
// TPU kernel's jnp.any gates over a tile of documents only skip work whose
// effect on a document is masked off, so each document run alone gives the
// same bits (the CPU tests hold a B-lane replay against B one-lane
// replays); its SHARED_CUM hoist is a cost gate that changes no result and
// is not needed here. The columns and their per-row temporaries (live
// counts, prefix sums, covered ranges, shift copies) live in device memory
// as lane-major working planes; the public [CAP, B] planes are transposed
// in and out around the replay. By-order tables are read by direct index,
// clamped into [0, OCAP) as t_read clamps.
//
// What bounds it. The serial chain of steps per document, each a few
// passes over the document's whole column (CAP rows, 32 per warp
// instruction). This engine is the cross-check of the blocked one and the
// engine of the sync demo; the blocked kernel is the one sized for speed.

#include <cuda_runtime.h>

#include "lanes_mixed.cuh"

namespace {

using namespace lanes;

constexpr int kWarpsPerBlock = 4;

struct Col {
  int *O, *L, *XO, *XL, *LV, *CUM, *CS, *CE;  // [CAP] each, lane-major
  Tab oll, orl, rkl;
  int CAP, WMAX;
  int rows;
  int e0, e1, e2;
};

// flag_capacity: err[0] where the column lacks `need` spare rows.
__device__ __forceinline__ void flag_capacity(Col& c, int need) {
  if (c.rows + need > c.CAP) c.e0 = 1;
}

// _live_prefix: LV = live chars per row, CUM = their inclusive prefix.
__device__ void live_prefix(Col& c) {
  __syncwarp();
  for (int i = lane_id(); i < c.CAP; i += 32)
    c.LV[i] = c.O[i] > 0 ? c.L[i] : 0;
  __syncwarp();
  wprefix(c.LV, c.CUM, c.CAP);
}

// find_run_of_order: (row, found) of the run holding order o; err[2] when
// none does. The row is 0 when not found.
__device__ int find_run_of_order(Col& c, int o) {
  int n = 0, row = c.CAP;
  for (int i = lane_id(); i < c.CAP; i += 32) {
    const int bo = c.O[i], so = iabs(bo) - 1;
    if (bo != 0 && so <= o && o < so + c.L[i]) {
      ++n;
      row = imin(row, i);
    }
  }
  const bool found = wsum(n) > 0;
  row = wmin(row);
  if (!found) c.e2 = 1;
  return found ? row : 0;
}

// raw_pos_of_order: RAW document position of order o.
__device__ int raw_pos_of_order(Col& c, int o) {
  const int row = find_run_of_order(c, o);
  int s = 0;
  for (int i = lane_id(); i < c.CAP; i += 32) s += i < row ? c.L[i] : 0;
  const int raw_before = wsum(s);
  const int so_hit = iabs(row_or0(c.O, row, c.CAP)) - 1;
  return raw_before + (o - so_hit);
}

// cursor_after for a lane that needs it.
__device__ int cursor_after(Col& c, int o) {
  if (o == kUnknown) c.e2 = 1;
  if (o == kRoot) return 0;
  return raw_pos_of_order(c, imax(o, 0)) + 1;
}

// apply_partial: split row i around its covered range (CS, CE).
__device__ int apply_partial(Col& c, int i) {
  const Pieces p = split_pieces(row_or0(c.O, i, c.CAP),
                                row_or0(c.L, i, c.CAP),
                                row_or0(c.CS, i, c.CAP),
                                row_or0(c.CE, i, c.CAP));
  apply_pieces(c.O, c.L, c.XO, c.XL, c.CAP, i, p);
  return p.amt;
}

// Full covers flip; returns (tot, npart, i1, i2) of the covered ranges in
// CS/CE. `live_only` restricts full and partial covers to live runs (the
// remote delete); `flip` applies the flips.
struct Cover {
  int tot, np, i1, i2;
};

__device__ Cover scan_cover(Col& c, bool live_only, bool flip) {
  Cover r = {0, 0, c.CAP, -1};
  for (int i = lane_id(); i < c.CAP; i += 32) {
    const int bo = c.O[i], bl = c.L[i], cov = c.CE[i] - c.CS[i];
    r.tot += cov;
    const bool ok = !live_only || bo > 0;
    const bool full = ok && cov > 0 && cov == bl;
    const bool part = ok && cov > 0 && cov != bl;
    if (part) {
      ++r.np;
      r.i1 = imin(r.i1, i);
      r.i2 = imax(r.i2, i);
    }
    if (full && flip) c.O[i] = -bo;
  }
  r.tot = wsum(r.tot);
  r.np = wsum(r.np);
  r.i1 = wmin(r.i1);
  r.i2 = wmax(r.i2);
  __syncwarp();
  return r;
}

// do_local_delete: tombstone d live chars after live rank p in one pass.
__device__ void do_local_delete(Col& c, int p, int d) {
  flag_capacity(c, 2);
  live_prefix(c);
  __syncwarp();
  for (int i = lane_id(); i < c.CAP; i += 32) {
    const int lv = c.LV[i], before = c.CUM[i] - lv;
    c.CS[i] = imin(imax(p - before, 0), lv);
    c.CE[i] = imin(imax(p + d - before, 0), lv);
  }
  __syncwarp();
  const Cover cv = scan_cover(c, false, true);
  if (cv.tot < d) c.e1 = 1;
  int a2 = 0, a1 = 0;
  if (cv.np >= 1) a2 = apply_partial(c, cv.i2);
  if (cv.np == 2) a1 = apply_partial(c, cv.i1);
  c.rows += a1 + a2;
}

// do_local_insert: the fused W-row splice at live rank p plus the by-order
// table upkeep; returns the op's origins.
__device__ void do_local_insert(Col& c, int p, int il, int st, int w,
                                int& ol_out, int& or_out) {
  const int CAP = c.CAP, lane = lane_id();
  const int rows = c.rows;
  flag_capacity(c, w + 1);
  live_prefix(c);
  int n = 0;
  for (int i = lane; i < CAP; i += 32) n += (c.CUM[i] < p && i < rows);
  const int i_r = wsum(n);
  const int o_r = row_or0(c.O, i_r, CAP), l_r = row_or0(c.L, i_r, CAP);
  const int off = p - (row_or0(c.CUM, i_r, CAP) - row_or0(c.LV, i_r, CAP));
  const int left = p == 0 ? kRoot : (o_r - 1) + (off - 1);
  const int lrun = floordiv(il, imax(w, 1));
  const bool mrg = w == 1 && p > 0 && off == l_r && st + 1 == o_r + l_r;
  const bool is_split = p > 0 && off < l_r;
  const int ins_at = p == 0 ? 0 : i_r + 1;
  const int amt = mrg ? 0 : w + (int)is_split;
  const int nxt = row_or0(c.O, i_r + 1, CAP), first_o = c.O[0];
  const int ra = roll_amount(amt, c.WMAX + 1, CAP);
  __syncwarp();
  for (int i = lane; i < CAP; i += 32) {
    c.XO[i] = c.O[i];
    c.XL[i] = c.L[i];
  }
  __syncwarp();
  for (int j = lane; j < CAP; j += 32) {
    int no = c.XO[j], nl = c.XL[j];
    if (j >= ins_at) {
      const int s = roll_src(j, ra, CAP);
      no = c.XO[s];
      nl = c.XL[s];
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
    c.O[j] = no;
    c.L[j] = nl;
  }
  __syncwarp();
  const int succ_p0 = rows > 0 ? first_o : 0;
  const int succ_after = i_r + 1 < rows ? nxt : 0;
  const int succ = p == 0 ? succ_p0 : (is_split ? o_r + off : succ_after);
  const int right = succ == 0 ? kRoot : iabs(succ) - 1;
  c.rows = rows + amt;
  const int ls = imax(lrun, 1), OCAP = c.oll.OCAP;
  for (int q = lane; q < il; q += 32) {
    const int o = st + q;
    if (o < 0 || o >= OCAP) continue;
    if (q % ls == 0) c.oll.put(o, left);
    c.orl.put(o, q < ls ? right : st + (q / ls - 1) * ls);
  }
  __syncwarp();
  ol_out = left;
  or_out = right;
}

// integrate_cursor: the run-level YATA scan; the raw prefix CUM (of L) is
// hoisted, as the scan mutates nothing.
__device__ int integrate_cursor(Col& c, int my_rank, int o_left,
                                int o_right) {
  const int CAP = c.CAP;
  wprefix(c.L, c.CUM, CAP);  // cumraw
  int s = 0;
  for (int i = lane_id(); i < CAP; i += 32) s += c.L[i];
  const int n = wsum(s);
  Yata y;
  y.cursor = cursor_after(c, o_left);
  y.left_cursor = y.cursor;
  y.scanning = 0;
  y.scan_start = y.cursor;
  while (y.cursor < n) {
    int cnt = 0;
    for (int i = lane_id(); i < CAP; i += 32)
      cnt += (c.CUM[i] <= y.cursor && i < c.rows);
    const int i_r = wsum(cnt);
    const int o_r = row_or0(c.O, i_r, CAP), l_r = row_or0(c.L, i_r, CAP);
    const int off = y.cursor - (row_or0(c.CUM, i_r, CAP) - l_r);
    const int so = iabs(o_r) - 1, other = so + off;
    const int other_left = c.oll.get(other), other_right = c.orl.get(other);
    const int other_rank = c.rkl.get(other);
    const int olc = cursor_after(c, other_left);
    bool stuck;
    if (yata_probe(y, my_rank, o_right, so, l_r, off, olc, other_right,
                   other_rank, stuck))
      break;
    if (stuck) {  // corrupt state: the TPU loop would never end here
      c.e2 = 1;
      break;
    }
  }
  return y.scanning ? y.scan_start : y.cursor;
}

// do_remote_insert: YATA integrate, then the raw-position splice (the split
// run may be a tombstone; merging needs a live, chained predecessor).
__device__ void do_remote_insert(Col& c, int my_rank, int o_left,
                                 int o_right, int il, int st) {
  const int CAP = c.CAP, lane = lane_id();
  flag_capacity(c, 2);
  const int cc = integrate_cursor(c, my_rank, o_left, o_right);
  const int rows = c.rows;
  int n = 0;
  for (int i = lane; i < CAP; i += 32) n += (c.CUM[i] < cc && i < rows);
  const int i_r = wsum(n);
  const int o_r = row_or0(c.O, i_r, CAP), l_r = row_or0(c.L, i_r, CAP);
  const int off = cc - (row_or0(c.CUM, i_r, CAP) - l_r);
  const bool mrg = cc > 0 && o_r > 0 && off == l_r && st + 1 == o_r + l_r &&
                   o_left == o_r + l_r - 2;
  const bool is_split = cc > 0 && off < l_r;
  const int ins_at = cc == 0 ? 0 : i_r + 1;
  const int amt = mrg ? 0 : (is_split ? 2 : 1);
  const int ra = roll_amount(amt, 2, CAP);
  __syncwarp();
  for (int i = lane; i < CAP; i += 32) {
    c.XO[i] = c.O[i];
    c.XL[i] = c.L[i];
  }
  __syncwarp();
  for (int j = lane; j < CAP; j += 32) {
    int no = c.XO[j], nl = c.XL[j];
    if (j >= ins_at) {
      const int s = roll_src(j, ra, CAP);
      no = c.XO[s];
      nl = c.XL[s];
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
    c.O[j] = no;
    c.L[j] = nl;
  }
  __syncwarp();
  c.rows = rows + amt;
}

// do_remote_delete: the one-pass order-interval tombstone; covered dead
// runs count toward the total without flipping (`double_delete.rs:6-9`).
// A delete whose splits would overflow the column flags and does nothing.
__device__ void do_remote_delete(Col& c, int t, int dlen) {
  const int CAP = c.CAP;
  __syncwarp();
  for (int i = lane_id(); i < CAP; i += 32) {
    const int bo = c.O[i], bl = c.L[i], so = iabs(bo) - 1;
    const int cs = imin(imax(t - so, 0), bl);
    const int ce = imin(imax(t + dlen - so, 0), bl);
    c.CS[i] = bo != 0 ? cs : 0;
    c.CE[i] = bo != 0 ? ce : 0;
  }
  __syncwarp();
  const Cover probe = scan_cover(c, true, false);
  if (probe.tot < dlen) c.e1 = 1;
  if (probe.np > 0 && c.rows + 2 > CAP) {
    c.e0 = 1;
    return;
  }
  const Cover cv = scan_cover(c, true, true);
  int a2 = 0, a1 = 0;
  if (cv.np >= 1) a2 = apply_partial(c, cv.i2);
  if (cv.np == 2) a1 = apply_partial(c, cv.i1);
  c.rows += a1 + a2;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock) lanes_mixed_kernel(
    const int* __restrict__ kind, const int* __restrict__ pos,
    const int* __restrict__ dlen, const int* __restrict__ dtgt,
    const int* __restrict__ olop, const int* __restrict__ orop,
    const int* __restrict__ rank, const int* __restrict__ ilen,
    const int* __restrict__ start, const int* __restrict__ wcol,
    const int* __restrict__ rows0, const int* __restrict__ rkl,
    int* __restrict__ ol, int* __restrict__ orr, int* __restrict__ rows_out,
    int* __restrict__ oll, int* __restrict__ orl, int* __restrict__ err,
    int* __restrict__ scratch, int S, int B, int CAP, int OCAP, int WMAX) {
  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warps only: no collective is split
  const long long plane = (long long)B * CAP;
  int* base = scratch + (long long)b * CAP;
  Col c;
  c.O = base;
  c.L = base + plane;
  c.XO = base + 2 * plane;
  c.XL = base + 3 * plane;
  c.LV = base + 4 * plane;
  c.CUM = base + 5 * plane;
  c.CS = base + 6 * plane;
  c.CE = base + 7 * plane;
  c.oll = Tab{oll + b, B, OCAP};
  c.orl = Tab{orl + b, B, OCAP};
  c.rkl = Tab{const_cast<int*>(rkl) + b, B, OCAP};
  c.CAP = CAP;
  c.WMAX = WMAX;
  c.rows = rows0[b];
  c.e0 = c.e1 = c.e2 = 0;

  for (int k = 0; k < S; ++k) {
    const long long g = (long long)k * B + b;
    const int kd = kind[g], p = pos[g], dl = dlen[g], il = ilen[g];
    const int st = start[g], w = imax(wcol[g], 1);
    int ol_v = 0, or_v = 0;
    if (kd == kLocal && dl > 0) do_local_delete(c, p, dl);
    if (kd == kLocal && il > 0) do_local_insert(c, p, il, st, w, ol_v, or_v);
    if (kd == kRemoteIns && il > 0) {
      ol_v = olop[g];
      or_v = orop[g];
      do_remote_insert(c, rank[g], ol_v, or_v, il, st);
    }
    if (kd == kRemoteDel && dl > 0) do_remote_delete(c, dtgt[g], dl);
    if (lane == 0) {
      ol[g] = ol_v;
      orr[g] = or_v;
    }
  }
  if (lane == 0) {
    rows_out[b] = c.rows;
    const int e[8] = {c.e0, c.e1, c.e2, 0, 0, 0, 0, 0};
    for (int r = 0; r < 8; ++r) err[(long long)r * B + b] = e[r];
  }
}

}  // namespace

extern "C" int rle_lanes_mixed_launch(
    const int* kind, const int* pos, const int* dlen, const int* dtgt,
    const int* olop, const int* orop, const int* rank, const int* ilen,
    const int* start, const int* wcol, const int* ord0, const int* len0,
    const int* rows0, const int* oll0, const int* orl0, const int* olld,
    const int* orld, const int* rkl, int* ol, int* orr, int* ordp,
    int* lenp, int* rows, int* oll, int* orl, int* err, int* scratch, int S,
    int B, int CAP, int OCAP, int WMAX, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long plane = (long long)B * CAP;
  lanes::launch_transpose(ord0, scratch, CAP, B, st);
  lanes::launch_transpose(len0, scratch + plane, CAP, B, st);
  lanes::launch_merge(olld, oll0, orld, orl0, oll, orl, (long long)OCAP * B,
                      st);
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lanes_mixed_kernel<<<blocks, 32 * kWarpsPerBlock, 0, st>>>(
      kind, pos, dlen, dtgt, olop, orop, rank, ilen, start, wcol, rows0, rkl,
      ol, orr, rows, oll, orl, err, scratch, S, B, CAP, OCAP, WMAX);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lanes::launch_transpose(scratch, ordp, B, CAP, st);
  lanes::launch_transpose(scratch + plane, lenp, B, CAP, st);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
