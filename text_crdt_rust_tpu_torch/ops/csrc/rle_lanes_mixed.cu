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
// length, packed at the front (rows in use: `rows`). Order lookups are a
// range test over the rows, positions come from prefix sums, splices shift
// the rows past the edit as a circular roll does (pltpu.roll: a column
// that overflows its capacity wraps, and the capacity flag says so). By-
// order tables oll/orl are carried across launches (the prefill delta
// merges in at step 0), rkl is read-only. Remote inserts integrate by the
// run-level YATA walk; remote deletes are one interval pass that flips
// full covers and splits the at most two partial ends. err row 0:
// capacity; row 1: a bad delete; row 2: an order miss.
//
// Mapping. One warp per document, `warps` documents per thread block. The
// TPU kernel's jnp.any gates over a tile of documents only skip work whose
// effect on a document is masked off, so each document run alone gives the
// same bits (the CPU tests hold a B-lane replay against B one-lane
// replays); its SHARED_CUM hoist is a cost gate that changes no result and
// is not needed here. The public [CAP, B] planes are transposed into
// lane-major planes around the replay; each warp keeps the first sh rows
// of its document's column in shared memory for the whole launch
// (lanes_column.cuh: no per-row temporaries, passes over the column's
// extent, splices in place); a column whose extent passes sh works in the
// lane-major planes, with the same passes. The YATA walk moves
// forward from one probe's run to the next instead of counting the column
// again, and finds each probe's origin-left row by a ballot search that
// stops at the first hit. By-order tables stay [OCAP, B] in device memory,
// read by direct index, clamped into [0, OCAP) as t_read clamps.
//
// What bounds it. The serial chain of steps per document: passes over the
// document's extent in shared memory and, per YATA probe, the origin
// tables' reads from device memory and the search for the probe's left
// origin.

#include <cuda_runtime.h>

#include "lanes_column.cuh"

namespace {

using namespace lanecol;

constexpr int kMaxWarps = 8;
// extent at the start and at the end, remote inserts, YATA probes, the most
// probes of one insert, 1 if the column ended in shared memory
constexpr int kStats = 6;

struct Tables {
  Tab oll, orl, rkl;
};

// Sum of every row's length over [0, hi): the document's raw length.
__device__ __forceinline__ int raw_total(const Col& c) {
  int s = 0;
  for (int i = lane_id(); i < c.hi; i += 32) s += c.L[i];
  return wsum(s);
}

// Where an order lies: the RAW position after it (cursor_after), the row
// holding it and the raw length of the rows before that row.
struct Hit {
  int cursor, row, pre;
};

// cursor_after (find_run_of_order + raw_pos_of_order): a ballot search over
// [0, hi), 128 rows a round, for the first row whose run holds order o,
// summing the lengths of the rows before it on the way. err[2] when o is
// unknown or no run holds it (then the row is 0).
__device__ __forceinline__ Hit cursor_after(Col& c, int o) {
  if (o == kUnknown) c.e2 = 1;
  if (o == kRoot) return Hit{0, 0, 0};
  const int oo = imax(o, 0), lane = lane_id(), hi = c.hi;
  int pre = 0, row = -1;
  for (int g = 0; g < hi && row < 0; g += 128) {
    int bl[4];
    unsigned m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = g + 32 * u + lane;
      const int bo = i < hi ? c.O[i] : 0;
      bl[u] = i < hi ? c.L[i] : 0;
      const int so = iabs(bo) - 1;
      m[u] = __ballot_sync(kFull, bo != 0 && so <= oo && oo < so + bl[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (row >= 0) break;
      if (m[u]) {
        const int f = __ffs(m[u]) - 1;
        row = g + 32 * u + f;
        if (lane < f) pre += bl[u];
      } else {
        pre += bl[u];
      }
    }
  }
  pre = wsum(pre);
  if (row < 0) {
    c.e2 = 1;
    row = 0;
    pre = 0;
  }
  const int so_hit = iabs(at(c.O, row, hi)) - 1;
  return Hit{pre + (oo - so_hit) + 1, row, pre};
}

// Move the walk's row k (with pre, the raw length before it) forward to the
// first row whose raw prefix passes `cursor`, 32 rows a round.
__device__ __forceinline__ void advance(const Col& c, int& k, int& pre,
                                        int cursor) {
  const int lane = lane_id();
  for (;;) {
    const int j = k + lane;
    const int v = j < c.hi ? c.L[j] : 0;
    const int x = pre + wscan(v);
    const unsigned m = __ballot_sync(kFull, x > cursor || j >= c.hi);
    if (m) {
      const int f = __ffs(m) - 1;
      pre = __shfl_sync(kFull, x - v, f);
      k += f;
      return;
    }
    pre = __shfl_sync(kFull, x, 31);
    k += 32;
  }
}

// integrate_cursor: the run-level YATA scan. Each probe's run is the first
// row whose raw prefix passes the cursor, capped at `rows` as the TPU
// kernel's count is; the cursor only moves forward, so the walk goes on
// from the previous probe's row (from the left origin's row at the start).
__device__ __forceinline__ int integrate_cursor(Col& c, const Tables& t,
                                                int my_rank, int o_left,
                                                int o_right, int& probes) {
  const int CAP = c.CAP, rows_c = clampi(c.rows, 0, CAP);
  const int n = raw_total(c);
  const Hit h = cursor_after(c, o_left);
  Yata y;
  y.cursor = h.cursor;
  y.left_cursor = y.cursor;
  y.scanning = 0;
  y.scan_start = y.cursor;
  int k = h.row, pre = h.pre;
  int cum_rows = 0;
  bool have_cum_rows = false;
  while (y.cursor < n) {
    advance(c, k, pre, y.cursor);
    int i_r, cum;
    if (k <= rows_c) {
      i_r = k;
      cum = k < CAP ? pre + at(c.L, k, c.hi) : 0;
    } else {  // stale rows past `rows`: the raw prefix at row `rows`
      if (!have_cum_rows) {
        cum_rows = rows_c >= c.hi ? (rows_c < CAP ? n : 0)
                                  : prefix_to<false>(c, rows_c + 1);
        have_cum_rows = true;
      }
      i_r = rows_c;
      cum = cum_rows;
    }
    const int o_r = at(c.O, i_r, c.hi), l_r = at(c.L, i_r, c.hi);
    const int off = y.cursor - (cum - l_r);
    const int so = iabs(o_r) - 1, other = so + off;
    const int other_left = t.oll.get(other), other_right = t.orl.get(other);
    const int other_rank = t.rkl.get(other);
    const int olc = cursor_after(c, other_left).cursor;
    ++probes;
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
__device__ __forceinline__ void remote_insert(Col& c, const Tables& t,
                                              int my_rank, int o_left,
                                              int o_right, int il, int st,
                                              int& probes) {
  const int CAP = c.CAP, lane = lane_id();
  if (c.rows + 2 > CAP) c.e0 = 1;
  const int cc = integrate_cursor(c, t, my_rank, o_left, o_right, probes);
  const int rows = c.rows;
  const Loc lc = locate<false, true>(c, cc);
  const int i_r = lc.i_r;
  const int o_r = at(c.O, i_r, c.hi), l_r = at(c.L, i_r, c.hi);
  const int off = cc - (lc.cum - l_r);
  const bool mrg = cc > 0 && o_r > 0 && off == l_r && st + 1 == o_r + l_r &&
                   o_left == o_r + l_r - 2;
  const bool is_split = cc > 0 && off < l_r;
  const int ins_at = cc == 0 ? 0 : i_r + 1;
  const int amt = mrg ? 0 : (is_split ? 2 : 1);
  shift_down(c, ins_at, amt, roll_amount(amt, 2, CAP));
  if (lane == 0) {
    if (i_r < CAP && is_split) c.L[i_r] = off;
    if (i_r < CAP && mrg) c.L[i_r] = l_r + il;
    if (!mrg && ins_at < CAP) {
      c.O[ins_at] = st + 1;
      c.L[ins_at] = il;
    }
    if (is_split && ins_at + 1 < CAP) {
      c.O[ins_at + 1] = o_r > 0 ? o_r + off : o_r - off;
      c.L[ins_at + 1] = l_r - off;
    }
  }
  __syncwarp();
  if ((is_split || mrg) && i_r < CAP) c.hi = imax(c.hi, i_r + 1);
  c.rows = rows + amt;
}

// do_remote_delete: the one-pass order-interval tombstone; covered dead
// runs count toward the total without flipping (`double_delete.rs:6-9`).
// A delete whose splits would overflow the column flags and does nothing,
// so its flips wait for the pass's verdict only when the column is that
// full.
__device__ __forceinline__ void remote_delete(Col& c, int t, int dlen) {
  const int CAP = c.CAP, lane = lane_id(), hi = c.hi;
  const bool roomy = c.rows + 2 <= CAP;
  int tot = 0;
  Partial part;
  part.init(CAP);
  __syncwarp();
  for (int i = lane; i < hi; i += 32) {
    const int bo = c.O[i], bl = c.L[i], so = iabs(bo) - 1;
    const int cs = bo != 0 ? imin(imax(t - so, 0), bl) : 0;
    const int ce = bo != 0 ? imin(imax(t + dlen - so, 0), bl) : 0;
    const int cov = ce - cs;
    tot += cov;
    if (bo > 0 && cov > 0) {
      if (cov != bl)
        part.add(i, cs, ce);
      else if (roomy)
        c.O[i] = -bo;
    }
  }
  tot = wsum(tot);
  part.join();
  __syncwarp();
  if (tot < dlen) c.e1 = 1;
  if (!roomy) {
    if (part.n > 0) {
      c.e0 = 1;
      return;
    }
    for (int i = lane; i < hi; i += 32) {
      const int bo = c.O[i], bl = c.L[i], so = iabs(bo) - 1;
      const int cs = imin(imax(t - so, 0), bl);
      const int ce = imin(imax(t + dlen - so, 0), bl);
      if (bo > 0 && ce - cs > 0 && ce - cs == bl) c.O[i] = -bo;
    }
    __syncwarp();
  }
  c.rows += part.apply(c);
}

// The op columns of one document, its origins and its counters.
struct Stream {
  const int *kind, *pos, *dlen, *dtgt, *olop, *orop, *rank, *ilen, *start,
      *wcol;
  int *ol, *orr;
  Tables t;
  int S, B, b, OCAP;
  int inserts, probes, most;
};

// Steps [k, S) of one document. With SMEM the column is the warp's rows
// of shared memory (so that its reads and writes are shared-memory ones),
// and the replay stops before a step whose writes could pass them,
// returning that step; else the column is in device memory. Returns S
// when every step is done.
template <bool SMEM>
__device__ int replay(Col& c, Stream& s, int k) {
  extern __shared__ int smem[];
  if (SMEM) {
    c.O = smem + 2 * (threadIdx.x >> 5) * c.lim;
    c.L = c.O + c.lim;
  }
  const int lane = lane_id();
  int stop = s.S;
  for (int k0 = k & ~31; k0 < stop; k0 += 32) {
    const int kk = k0 + lane;
    int rk = 0, rp = 0, rd = 0, rt = 0, rl = 0, rr = 0, rn = 0, ri = 0,
        rs = 0, rw = 0;
    if (kk < s.S) {
      const long long g = (long long)kk * s.B + s.b;
      rk = s.kind[g];
      rp = s.pos[g];
      rd = s.dlen[g];
      rt = s.dtgt[g];
      rl = s.olop[g];
      rr = s.orop[g];
      rn = s.rank[g];
      ri = s.ilen[g];
      rs = s.start[g];
      rw = s.wcol[g];
    }
    int my_ol = 0, my_or = 0;
    const int nk = imin(32, s.S - k0);
    for (int u = imax(k - k0, 0); u < nk; ++u) {
      const int kd = bcast(rk, u), dl = bcast(rd, u), il = bcast(ri, u);
      if (dl <= 0 && il <= 0) continue;  // a pad row or an idle document
      const int w = imax(bcast(rw, u), 1);  // pad rows carry 0
      if (SMEM && step_room(c, w) > c.lim) {
        stop = k0 + u;
        break;
      }
      int ol_v = 0, or_v = 0;
      if (kd == kLocal && dl > 0) local_delete(c, bcast(rp, u), dl);
      if (kd == kLocal && il > 0) {
        const int p = bcast(rp, u), st = bcast(rs, u);
        const LocalIns r = local_insert(c, p, il, st, w);
        const int ls = imax(r.lrun, 1);
        for (int q = lane; q < il; q += 32) {
          const int o = st + q;
          if (o < 0 || o >= s.OCAP) continue;
          if (q % ls == 0) s.t.oll.put(o, r.left);
          s.t.orl.put(o, q < ls ? r.right : st + (q / ls - 1) * ls);
        }
        __syncwarp();
        ol_v = r.left;
        or_v = r.right;
      }
      if (kd == kRemoteIns && il > 0) {
        ol_v = bcast(rl, u);
        or_v = bcast(rr, u);
        const int before = s.probes;
        remote_insert(c, s.t, bcast(rn, u), ol_v, or_v, il, bcast(rs, u),
                      s.probes);
        ++s.inserts;
        s.most = imax(s.most, s.probes - before);
      }
      if (kd == kRemoteDel && dl > 0) remote_delete(c, bcast(rt, u), dl);
      if (lane == u) {
        my_ol = ol_v;
        my_or = or_v;
      }
    }
    if (kk >= k && kk < stop) {
      s.ol[(long long)kk * s.B + s.b] = my_ol;
      s.orr[(long long)kk * s.B + s.b] = my_or;
    }
  }
  return stop;
}

__global__ void __launch_bounds__(32 * kMaxWarps, 2) lanes_mixed_kernel(
    const int* __restrict__ kind, const int* __restrict__ pos,
    const int* __restrict__ dlen, const int* __restrict__ dtgt,
    const int* __restrict__ olop, const int* __restrict__ orop,
    const int* __restrict__ rank, const int* __restrict__ ilen,
    const int* __restrict__ start, const int* __restrict__ wcol,
    const int* __restrict__ rows0, const int* __restrict__ rkl,
    int* __restrict__ ol, int* __restrict__ orr, int* __restrict__ rows_out,
    int* __restrict__ oll, int* __restrict__ orl, int* __restrict__ err,
    int* __restrict__ planes, long long* __restrict__ stats, int S, int B,
    int CAP, int OCAP, int WMAX, int sh) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // whole warps only: no collective is split
  int* gO = planes + (long long)b * CAP;
  Col c;
  c.CAP = CAP;
  c.WMAX = WMAX;
  c.rows = rows0[b];
  c.e0 = c.e1 = c.e2 = 0;
  const bool on_chip =
      open_column(c, gO, gO + (long long)B * CAP, smem + 2 * warp * sh, sh);
  const int hi0 = c.hi;
  Stream s{kind,  pos,   dlen, dtgt, olop, orop, rank, ilen, start, wcol,
           ol,    orr,   Tables{Tab{oll + b, B, OCAP}, Tab{orl + b, B, OCAP},
                                Tab{const_cast<int*>(rkl) + b, B, OCAP}},
           S,     B,     b,    OCAP, 0,    0,    0};
  int k = 0;
  if (on_chip) {
    k = replay<true>(c, s, 0);
    if (k < S) move_to_device(c);
  }
  if (k < S) replay<false>(c, s, k);
  close_column(c);
  if (lane == 0) {
    rows_out[b] = c.rows;
    const int e[8] = {c.e0, c.e1, c.e2, 0, 0, 0, 0, 0};
    for (int r = 0; r < 8; ++r) err[(long long)r * B + b] = e[r];
    if (stats) {
      long long* st = stats + (long long)b * kStats;
      st[0] = hi0;
      st[1] = c.hi;
      st[2] = s.inserts;
      st[3] = s.probes;
      st[4] = s.most;
      st[5] = c.O != c.gO;
    }
  }
}

}  // namespace

// `sh` is the rows of each column kept in shared memory (0: the columns
// stay in the lane-major planes); a thread block takes 8 * sh bytes a warp.
// `stats` may be null.
extern "C" int rle_lanes_mixed_launch(
    const int* kind, const int* pos, const int* dlen, const int* dtgt,
    const int* olop, const int* orop, const int* rank, const int* ilen,
    const int* start, const int* wcol, const int* ord0, const int* len0,
    const int* rows0, const int* oll0, const int* orl0, const int* olld,
    const int* orld, const int* rkl, int* ol, int* orr, int* ordp,
    int* lenp, int* rows, int* oll, int* orl, int* err, int* planes,
    long long* stats, int S, int B, int CAP, int OCAP, int WMAX, int warps,
    int sh, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (warps < 1 || warps > kMaxWarps || sh < 0 || sh > CAP)
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)B * CAP;
  const int smem = 8 * sh * warps;
  lanes::launch_transpose(ord0, planes, CAP, B, st);
  lanes::launch_transpose(len0, planes + plane, CAP, B, st);
  lanes::launch_merge(olld, oll0, orld, orl0, oll, orl, (long long)OCAP * B,
                      st);
  cudaError_t e = cudaFuncSetAttribute(
      lanes_mixed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  lanes_mixed_kernel<<<(B + warps - 1) / warps, 32 * warps, smem, st>>>(
      kind, pos, dlen, dtgt, olop, orop, rank, ilen, start, wcol, rows0, rkl,
      ol, orr, rows, oll, orl, err, planes, stats, S, B, CAP, OCAP, WMAX, sh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lanes::launch_transpose(planes, ordp, B, CAP, st);
  lanes::launch_transpose(planes + plane, lenp, B, CAP, st);
  return (int)cudaGetLastError();
}

// Thread blocks of `warps` warps with `sh` rows a column in shared memory
// that one SM holds at once (0 on error).
extern "C" int rle_lanes_mixed_blocks_per_sm(int warps, int sh) {
  const int smem = 8 * sh * warps;
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      lanes_mixed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, lanes_mixed_kernel, 32 * warps, smem);
  return e == cudaSuccess ? n : 0;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
