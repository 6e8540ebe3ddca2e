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
// next slot), gathers one block and splices <= w + 1 rows into it. A
// delete walks block to block: each iteration descends again, may split,
// flips the full covers of one block and splits its at most two partly
// covered runs, until the delete drains or 2 * NBT + 1 iterations ran (a
// delete past the end of the document). A split refused at nlog >= NB
// raises err[0], and the op then splices into the full block, whose rows
// wrap (a circular roll, as pltpu.roll does). err row 1: a delete past
// the end.
//
// Mapping. One warp per document, four documents per thread block. The
// TPU kernel's jnp.any gates over a tile of documents (the pl.whens, the
// re-descent conds, the tile-wide delete loop) only skip work whose effect
// on a document is masked off, so each document run alone gives the same
// bits (the CPU tests hold a B-lane replay against B one-lane replays). A
// warp's slot tables and its working K-row block live in shared memory;
// its planes live in device memory as lane-major working copies (a block
// is K contiguous ints), transposed from and to the public [CAP, B] layout
// around the replay. Row passes over one block are strided over the warp's
// 32 threads; the control scalars of a step are computed by every thread
// alike.
//
// What bounds it. The serial chain of steps per document: each step is a
// handful of dependent warp reductions over one K-row block and the NBT
// slot tables, while the bytes a replay must move take well under a
// millisecond at 3.35 TB/s. All B chains run at once, one warp each, with
// no barrier across documents.

#include <cuda_runtime.h>

#include "lanes_mixed.cuh"

namespace {

using namespace lanes;

constexpr int kWarpsPerBlock = 4;

// One document's replay state, held by its warp.
struct Doc {
  int* O;                          // ordp working plane [CAP] (lane-major)
  int* L;                          // lenp working plane [CAP]
  int *blk, *rws, *liv, *cliv, *tmp;  // shared [NBT]
  int *wo, *wl, *xo, *xl, *s1, *s2, *s3;  // shared [K]
  int K, NB, NBT, WMAX;
  int nlog;
  int e0, e1;  // err rows 0, 1
};

__device__ __forceinline__ int trow(const int* t, int l, int n) {
  return row_or0(t, l, n);
}

// gather_block: block b of the planes into (wo, wl); ids outside [0, NB)
// read block 0. The leading __syncwarp keeps the copy from overwriting a
// block that another thread of the warp is still reading.
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
  __syncwarp();
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

// slot_of_live_rank: smallest logical slot whose live prefix reaches
// rank1 (slots at or past nlog masked), capped at nlog - 1.
__device__ int slot_of_live_rank(const Doc& d, int rank1) {
  int c = 0;
  for (int t = lane_id(); t < d.NBT; t += 32)
    c += (t < d.nlog && d.cliv[t] < rank1);
  return imin(wsum(c), d.nlog - 1);
}

__device__ __forceinline__ int live_before(const Doc& d, int l) {
  return trow(d.cliv, l, d.NBT) - trow(d.liv, l, d.NBT);
}

// Add `v` to the live prefix's rows t >= l.
__device__ void add_from(const Doc& d, int l, int v) {
  __syncwarp();
  for (int i = lane_id(); i < d.NBT; i += 32)
    if (i >= l) d.cliv[i] += v;
  __syncwarp();
}

// split: the top half of slot l's rows moves to the fresh physical block
// nlog at logical slot l + 1. At table capacity (nlog >= NB) it raises
// err[0] and does nothing.
__device__ void split(Doc& d, int l) {
  if (d.nlog >= d.NB) {
    d.e0 = 1;
    return;
  }
  const int K = d.K, NBT = d.NBT, lane = lane_id();
  const int b = trow(d.blk, l, NBT), r = trow(d.rws, l, NBT);
  const int keep = floordiv(r, 2), mv = r - keep, nbv = d.nlog;
  gather(d, b);
  int lh = 0;
  for (int j = lane; j < K; j += 32)
    lh += (j >= keep && j < r && d.wo[j] > 0) ? d.wl[j] : 0;
  const int liv_hi = wsum(lh);
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
  int* tabs[4] = {d.blk, d.rws, d.liv, d.cliv};
  for (int q = 0; q < 4; ++q) {
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

// do_delete: tombstone dl live chars after live rank p, block by block.
__device__ void do_delete(Doc& d, int p, int dl) {
  const int K = d.K, lane = lane_id();
  int rem = dl;
  for (int iters = 0; rem > 0 && iters <= 2 * d.NBT; ++iters) {
    int l = slot_of_live_rank(d, p + 1);
    if (trow(d.rws, l, d.NBT) + 2 > K) {
      split(d, l);
      l = slot_of_live_rank(d, p + 1);
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
      if (cov > 0 && !full) {
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
    add_from(d, l, -tot);
    rem -= tot;
  }
  if (rem > 0) d.e1 = 1;
}

// The fused W-row insert splice of the working block (fused_splice_rows
// with one active lane). Returns amt; sets is_split.
__device__ int fused_splice(Doc& d, int p, int i_r, int o_r, int l_r,
                            int off, int il, int st, int w, bool& is_split) {
  const int K = d.K;
  const int lrun = floordiv(il, imax(w, 1));
  const bool mrg = w == 1 && p > 0 && off == l_r && st + 1 == o_r + l_r;
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

// do_insert: live-rank insert; returns the op's origins.
__device__ void do_insert(Doc& d, int p, int il, int st, int w, int& ol_out,
                          int& or_out) {
  const int K = d.K, NBT = d.NBT, lane = lane_id();
  int l = p == 0 ? 0 : slot_of_live_rank(d, p);
  if (trow(d.rws, l, NBT) + w + 1 > K) {
    split(d, l);
    l = p == 0 ? 0 : slot_of_live_rank(d, p);
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
  bool is_split;
  const int amt = fused_splice(d, p, i_r, o_r, l_r, off, il, st, w,
                               is_split);
  const int succ_after =
      i_r + 1 < r0 ? nxt_in_blk : (l + 1 < d.nlog ? nxt_slot_o : 0);
  const int succ = p == 0 ? succ_p0 : (is_split ? o_r + off : succ_after);
  scatter(d, b);
  if (lane == 0 && l >= 0 && l < NBT) {
    d.rws[l] += amt;
    d.liv[l] += il;
  }
  __syncwarp();
  add_from(d, l, il);
  ol_out = left;
  or_out = succ == 0 ? kRoot : iabs(succ) - 1;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock) lanes_blocked_kernel(
    const int* __restrict__ pos, const int* __restrict__ dlen,
    const int* __restrict__ ilen, const int* __restrict__ start,
    const int* __restrict__ wcol, const int* __restrict__ nlog0,
    const int* __restrict__ blk0, const int* __restrict__ rws0,
    const int* __restrict__ liv0, int* __restrict__ ol,
    int* __restrict__ orr, int* __restrict__ nlog_out,
    int* __restrict__ blk_out, int* __restrict__ rws_out,
    int* __restrict__ liv_out, int* __restrict__ err, int* __restrict__ wsO,
    int* __restrict__ wsL, int S, int B, int CAP, int K, int NBT, int WMAX) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warps only: no collective is split
  int* my = smem + warp * (5 * NBT + 7 * K);
  Doc d;
  d.O = wsO + (long long)b * CAP;
  d.L = wsL + (long long)b * CAP;
  d.blk = my;
  d.rws = my + NBT;
  d.liv = my + 2 * NBT;
  d.cliv = my + 3 * NBT;
  d.tmp = my + 4 * NBT;
  int* kb = my + 5 * NBT;
  d.wo = kb;
  d.wl = kb + K;
  d.xo = kb + 2 * K;
  d.xl = kb + 3 * K;
  d.s1 = kb + 4 * K;
  d.s2 = kb + 5 * K;
  d.s3 = kb + 6 * K;
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

  for (int k = 0; k < S; ++k) {
    const long long g = (long long)k * B + b;
    const int p = pos[g], dl = dlen[g], il = ilen[g], st = start[g];
    const int w = imax(wcol[g], 1);  // pad rows carry 0
    int ol_v = 0, or_v = 0;
    if (dl > 0) do_delete(d, p, dl);
    if (il > 0) do_insert(d, p, il, st, w, ol_v, or_v);
    if (lane == 0) {
      ol[g] = ol_v;
      orr[g] = or_v;
    }
  }

  __syncwarp();
  for (int i = lane; i < NBT; i += 32) {
    const long long g = (long long)i * B + b;
    blk_out[g] = d.blk[i];
    rws_out[g] = d.rws[i];
    liv_out[g] = d.liv[i];
  }
  if (lane == 0) {
    nlog_out[b] = d.nlog;
    const int e[8] = {d.e0, d.e1, 0, 0, 0, 0, 0, 0};
    for (int r = 0; r < 8; ++r) err[(long long)r * B + b] = e[r];
  }
}

}  // namespace

extern "C" int rle_lanes_blocked_launch(
    const int* pos, const int* dlen, const int* ilen, const int* start,
    const int* wcol, const int* ord0, const int* len0, const int* nlog0,
    const int* blk0, const int* rws0, const int* liv0, int* ol, int* orr,
    int* ordp, int* lenp, int* nlog, int* blk, int* rws, int* liv, int* err,
    int* scratch, int S, int B, int CAP, int K, int NBT, int WMAX,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int* wsO = scratch;
  int* wsL = scratch + (long long)B * CAP;
  lanes::launch_transpose(ord0, wsO, CAP, B, st);
  lanes::launch_transpose(len0, wsL, CAP, B, st);
  const size_t smem =
      (size_t)kWarpsPerBlock * (5 * NBT + 7 * K) * sizeof(int);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(lanes_blocked_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lanes_blocked_kernel<<<blocks, 32 * kWarpsPerBlock, smem, st>>>(
      pos, dlen, ilen, start, wcol, nlog0, blk0, rws0, liv0, ol, orr, nlog,
      blk, rws, liv, err, wsO, wsL, S, B, CAP, K, NBT, WMAX);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lanes::launch_transpose(wsO, ordp, B, CAP, st);
  lanes::launch_transpose(wsL, lenp, B, CAP, st);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
