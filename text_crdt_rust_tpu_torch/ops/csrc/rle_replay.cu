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
// counts (rws), live-char counts (liv) and their inclusive prefix
// (cumliv). A delete flips the runs it covers and splits at most two
// boundary runs per block, walking blocks; an insert splices w run rows
// plus at most one split tail; a full block splits into a fresh physical
// block. Each insert emits origin_left / origin_right. err[0] is raised
// when a split finds the table full (the split is skipped and the insert
// still proceeds), err[1] when a delete runs past the end.
//
// Mapping. One thread block per (lane, group), one thread per block row
// (K rows, rounded up to whole warps). The sequential chunk axis of the
// TPU grid becomes a loop over all steps inside the thread block. The
// block tables live in shared memory; the edited block is read into
// registers (one row per thread) and exchanged through shared memory for
// the row shifts; in-block cumsums are warp-shuffle scans joined through
// shared memory. The planes live in device memory, lane-major
// ([G, B, CAP] working copies, so one thread block's rows are contiguous),
// and are transposed once into the public [G*CAP, B] layout at the end.
// Every lane replays the same stream, so the TPU kernel's lane-max control
// scalars equal this thread block's own.
//
// What bounds it. Not bytes: one replay moves ~120 MB at the north-star
// shape (B = 512, CAP = 20,992, S = 8,192 padded steps), ~36 us at
// 3.35 TB/s. The floor is the serial chain of dependent steps (7,352 at
// the north-star shape): each step is a few dependent block-wide
// reductions and device-memory round trips of one K-row block. The design
// keeps every step inside one thread block (no launches, no grid-wide
// synchronisation) and runs all B x G chains at once; it recomputes the
// shared control state once per lane, which a later redesign can compute
// once per group.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kRoot = 0xffffffffu;  // ROOT_ORDER

struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct MinOp {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Block-wide reduction; every thread calls it and gets the result.
template <class Op>
__device__ int block_reduce(int v, int* red, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) red[wid] = v;
  __syncthreads();
  int r = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) r = op(r, red[i]);
  return r;
}

// Block-wide inclusive prefix sum in thread order.
__device__ int block_scan(int v, int* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  __syncthreads();
  if (lane == 31) red[wid] = v;
  __syncthreads();
  int pre = 0;
  for (int i = 0; i < wid; ++i) pre += red[i];
  return v + pre;
}

__device__ __forceinline__ int bit_length(int x) { return 32 - __clz(x); }

// Net roll of the TPU kernel's one-static-roll-per-bit shift: only the low
// bit_length(max_amount) bits of amount count, and rolls wrap modulo n.
__device__ __forceinline__ int roll_amount(int amount, int max_amount, int n) {
  const int bits = bit_length(max_amount > 1 ? max_amount : 1);
  return (amount & ((1 << bits) - 1)) % n;
}

// Row j of x rolled toward higher rows by a (circular): x[(j - a) mod n].
__device__ __forceinline__ int roll_src(int j, int a, int n) {
  const int s = (j - a) % n;
  return s < 0 ? s + n : s;
}

struct Replay {
  int* O;  // this lane's working ordp plane [CAP]
  int* L;  // this lane's working lenp plane [CAP]
  int* blkord;  // shared [NBL]; rws, liv, cumliv follow at NBL strides
  int* rws;
  int* liv;
  int* cumliv;
  int* s_bo;  // shared [K] row exchange
  int* s_bl;
  int* s_cs;
  int* s_ce;
  int* red;  // shared [32] reduction scratch
  int* err;  // [8, B]
  int B, lane, K, NB, NBL, WMAX, t, T;
  int nlog;  // blocks in use; identical in every thread

  // Value at index i of a shared table / row array; outside reads 0, as the
  // TPU kernel's masked sums do.
  __device__ int slot(const int* tbl, int l) const {
    return (l >= 0 && l < NBL) ? tbl[l] : 0;
  }
  __device__ int row(const int* arr, int r) const {
    return (r >= 0 && r < K) ? arr[r] : 0;
  }

  __device__ int slot_of_live_rank(int rank1) {
    int cnt = 0;
    for (int j = t; j < NBL; j += T) cnt += (cumliv[j] < rank1 && j < nlog);
    const int n = block_reduce(cnt, red, SumOp());
    return n < nlog - 1 ? n : nlog - 1;
  }

  // Leaf split of logical slot l into a fresh physical block at slot l+1.
  __device__ void split(int l) {
    if (nlog >= NB) {
      if (t == 0) err[lane] = 1;  // err row 0
      return;
    }
    const int b = slot(blkord, l), r = slot(rws, l);
    const int keep = r / 2, mv = r - keep, nb = nlog;
    int bo = 0, bl = 0;
    if (t < K) {
      bo = O[b * K + t];
      bl = L[b * K + t];
      s_bo[t] = bo;
      s_bl[t] = bl;
    }
    const int liv_hi = block_reduce(
        (t < K && t >= keep && t < r && bo > 0) ? bl : 0, red, SumOp());
    const int liv_lo = slot(liv, l) - liv_hi;
    const int up = roll_amount(keep, K, K);
    if (t < K) {
      const int src = (t + up) % K;
      const int uo = s_bo[src], ul = s_bl[src];
      O[nb * K + t] = t < mv ? uo : 0;
      L[nb * K + t] = t < mv ? ul : 0;
      O[b * K + t] = t < keep ? bo : 0;
      L[b * K + t] = t < keep ? bl : 0;
    }
    __syncthreads();  // every thread has read the tables
    if (t < 4) {  // one thread per table: slots > l take their predecessor
      int* tb = blkord + t * NBL;
      for (int j = NBL - 1; j > l; --j) tb[j] = tb[j - 1];
    }
    __syncthreads();
    if (t == 0) {
      rws[l] = keep;
      liv[l] = liv_lo;
      cumliv[l] -= liv_hi;
      blkord[l + 1] = nb;
      rws[l + 1] = mv;
      liv[l + 1] = liv_hi;
    }
    nlog += 1;
    __syncthreads();
  }

  // Loads block b into (bo, bl), one row per thread.
  __device__ void load(int b, int& bo, int& bl) const {
    bo = 0;
    bl = 0;
    if (t < K) {
      bo = O[b * K + t];
      bl = L[b * K + t];
    }
  }

  __device__ void do_insert(int p, int il, int st, int w, int* ol_k,
                            int* or_k) {
    int l = p == 0 ? 0 : slot_of_live_rank(p);
    int r0 = slot(rws, l);
    if (r0 + w + 1 > K) split(l);
    l = p == 0 ? 0 : slot_of_live_rank(p);
    r0 = slot(rws, l);
    const int b = slot(blkord, l);
    const int local = p - (slot(cumliv, l) - slot(liv, l));
    int bo, bl;
    load(b, bo, bl);

    // Locate the run holding live char #local.
    const int lv = bo > 0 ? bl : 0;
    const int cum = block_scan(lv, red);
    if (t < K) {
      s_bo[t] = bo;
      s_bl[t] = bl;
      s_cs[t] = cum;
      s_ce[t] = lv;
    }
    const int i_r =
        block_reduce((t < K && cum < local && t < r0) ? 1 : 0, red, SumOp());
    const int o_r = row(s_bo, i_r), l_r = row(s_bl, i_r);
    const int off = local - (row(s_cs, i_r) - row(s_ce, i_r));

    // Fused W-row splice.
    const int lrun = il / (w > 1 ? w : 1);
    const bool mrg =
        w == 1 && p > 0 && off == l_r && st + 1 == o_r + l_r;
    const bool is_split = p > 0 && off < l_r;
    const int ins_at = p == 0 ? 0 : i_r + 1;
    const int amt = mrg ? 0 : w + (is_split ? 1 : 0);
    const int a = roll_amount(amt, WMAX + 1, K);
    int no = bo, nl = bl;
    if (t < K) {
      const int src = roll_src(t, a, K);
      no = t < ins_at ? bo : s_bo[src];
      nl = t < ins_at ? bl : s_bl[src];
      if (is_split && t == i_r) nl = off;
      if (!mrg && t >= ins_at && t < ins_at + w) {
        no = st + il - (t - ins_at + 1) * lrun + 1;
        nl = lrun;
      }
      if (is_split && t == ins_at + w) {
        no = o_r + off;
        nl = l_r - off;
      }
      if (mrg && t == i_r) nl = l_r + il;
    }

    // Origins from the PRE-splice state: the run head's left neighbour
    // and the raw successor (tombstones not skipped).
    if (t == 0) {
      const unsigned left =
          p == 0 ? kRoot : (unsigned)(o_r - 1) + (unsigned)(off - 1);
      const int nxt_in_blk = row(s_bo, i_r + 1);
      const int b2 = slot(blkord, l + 1 < NBL - 1 ? l + 1 : NBL - 1);
      const int nxt_slot_o = O[b2 * K];
      const int succ_signed =
          i_r + 1 < r0 ? nxt_in_blk : (l + 1 < nlog ? nxt_slot_o : 0);
      const int succ_p0 = r0 > 0 ? s_bo[0] : 0;
      const int succ =
          p == 0 ? succ_p0 : (is_split ? o_r + off : succ_signed);
      const unsigned right =
          succ == 0 ? kRoot : (unsigned)((succ < 0 ? -succ : succ) - 1);
      *ol_k = (int)left;
      *or_k = (int)right;
    }
    if (t < K) {
      O[b * K + t] = no;
      L[b * K + t] = nl;
    }
    if (t == 0) {
      rws[l] += amt;
      liv[l] += il;
    }
    for (int j = l + t; j < NBL; j += T) cumliv[j] += il;
    __syncthreads();
  }

  // One boundary split of the delete: run i_p becomes [head?] [tombstone
  // mid] [tail?]. Returns the rows added.
  __device__ int apply_partial(bool active, int i_p, int& bo, int& bl) {
    __syncthreads();  // earlier readers of the row exchange are done
    if (t < K) {
      s_bo[t] = bo;
      s_bl[t] = bl;
    }
    __syncthreads();
    if (!active) return 0;
    const int o = row(s_bo, i_p), ln = row(s_bl, i_p);
    const int cs_i = row(s_cs, i_p), ce_i = row(s_ce, i_p);
    const int cov_i = ce_i - cs_i;
    const bool has_head = cs_i > 0, has_tail = ce_i < ln;
    const int amt = (has_head ? 1 : 0) + (has_tail ? 1 : 0);
    const int a = roll_amount(amt, 2, K);
    if (t < K) {
      const int src = roll_src(t, a, K);
      int no = t <= i_p ? bo : s_bo[src];
      int nl = t <= i_p ? bl : s_bl[src];
      if (t == i_p) {
        no = has_head ? o : -(o + cs_i);
        nl = has_head ? cs_i : cov_i;
      }
      if (t == i_p + 1 && amt >= 1) {
        no = has_head ? -(o + cs_i) : o + ce_i;
        nl = has_head ? cov_i : ln - ce_i;
      }
      if (t == i_p + 2 && amt == 2) {
        no = o + ce_i;
        nl = ln - ce_i;
      }
      bo = no;
      bl = nl;
    }
    return amt;
  }

  __device__ void do_delete(int p, int d) {
    int rem = d, iters = 0;
    // Each iteration clears one block's covered span; > 2*NBL iterations
    // means the delete ran off the document.
    while (rem > 0 && iters <= 2 * NBL) {
      int l = slot_of_live_rank(p + 1);
      if (slot(rws, l) + 2 > K) split(l);
      l = slot_of_live_rank(p + 1);
      const int b = slot(blkord, l);
      const int base = slot(cumliv, l) - slot(liv, l);
      int bo, bl;
      load(b, bo, bl);

      const int lv = bo > 0 ? bl : 0;
      const int cum = block_scan(lv, red);
      const int before = base + cum - lv;
      int cs = p - before, ce = p + rem - before;
      cs = cs < 0 ? 0 : (cs > lv ? lv : cs);
      ce = ce < 0 ? 0 : (ce > lv ? lv : ce);
      const int cov = ce - cs;
      const int tot = block_reduce(cov, red, SumOp());
      const bool full = cov > 0 && cov == bl;
      const bool part = cov > 0 && !full;
      const int npart = block_reduce(part ? 1 : 0, red, SumOp());
      const int i1 = block_reduce(part ? t : K, red, MinOp());
      const int i2 = block_reduce(part ? t : -1, red, MaxOp());
      if (full) bo = -bo;
      if (t < K) {
        s_cs[t] = cs;
        s_ce[t] = ce;
      }
      // Higher-index boundary first so i1's row index stays valid.
      int added = apply_partial(npart >= 1, i2, bo, bl);
      added += apply_partial(npart == 2, i1, bo, bl);
      if (t < K) {
        O[b * K + t] = bo;
        L[b * K + t] = bl;
      }
      if (t == 0) {
        rws[l] += added;
        liv[l] -= tot;
      }
      for (int j = l + t; j < NBL; j += T) cumliv[j] -= tot;
      __syncthreads();
      rem -= tot;
      ++iters;
    }
    if (rem > 0 && t == 0) err[B + lane] = 1;  // err row 1
  }
};

__global__ void rle_replay_kernel(
    const int* __restrict__ pos, const int* __restrict__ dlen,
    const int* __restrict__ ilen, const int* __restrict__ start,
    const int* __restrict__ wcol,  // [G*S] op columns
    int* ol, int* orr,             // [G, S, B] u32 bits
    int* ordp, int* lenp,          // [G*CAP, B]
    int* blk_out, int* rows_out,   // [G, NBL, B]
    int* meta_out,                 // [G, 8, B]
    int* err,                      // [8, B], zeroed by the caller
    int* work_o, int* work_l,      // [G, B, CAP] lane-major working planes
    int S, int B, int CAP, int K, int NB, int NBL, int WMAX) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x, g = blockIdx.y;
  Replay R;
  R.t = threadIdx.x;
  R.T = blockDim.x;
  R.B = B;
  R.lane = lane;
  R.K = K;
  R.NB = NB;
  R.NBL = NBL;
  R.WMAX = WMAX;
  R.O = work_o + ((size_t)g * B + lane) * CAP;
  R.L = work_l + ((size_t)g * B + lane) * CAP;
  R.blkord = smem;
  R.rws = R.blkord + NBL;
  R.liv = R.rws + NBL;
  R.cumliv = R.liv + NBL;
  R.s_bo = R.cumliv + NBL;
  R.s_bl = R.s_bo + K;
  R.s_cs = R.s_bl + K;
  R.s_ce = R.s_cs + K;
  R.red = R.s_ce + K;
  R.err = err;
  R.nlog = 1;  // fresh group: empty document, one empty block in slot 0
  const int t = R.t, T = R.T;

  for (int j = t; j < CAP; j += T) {
    R.O[j] = 0;
    R.L[j] = 0;
  }
  for (int j = t; j < 4 * NBL; j += T) R.blkord[j] = 0;
  __syncthreads();

  const size_t base = (size_t)g * S;
  for (int k = 0; k < S; ++k) {
    const int p = pos[base + k], d = dlen[base + k], il = ilen[base + k];
    const int st = start[base + k];
    const int w = wcol[base + k] > 1 ? wcol[base + k] : 1;  // pads carry 0
    if (d > 0) R.do_delete(p, d);
    if (il > 0) {
      const size_t o = (base + k) * B + lane;
      R.do_insert(p, il, st, w, ol + o, orr + o);
    }
  }
  __syncthreads();  // every thread's plane and table writes are visible

  for (int j = t; j < NBL; j += T) {
    const size_t o = ((size_t)g * NBL + j) * B + lane;
    blk_out[o] = R.blkord[j];
    rows_out[o] = R.rws[j];
  }
  for (int j = t; j < 8; j += T)
    meta_out[((size_t)g * 8 + j) * B + lane] = j == 0 ? R.nlog : 0;
  for (int j = t; j < CAP; j += T) {
    const size_t o = ((size_t)g * CAP + j) * B + lane;
    ordp[o] = R.O[j];
    lenp[o] = R.L[j];
  }
}

}  // namespace

extern "C" int rle_replay_launch(
    const int* pos, const int* dlen, const int* ilen, const int* start,
    const int* wcol, int* ol, int* orr, int* ordp, int* lenp, int* blk_out,
    int* rows_out, int* meta_out, int* err, int* work_o, int* work_l, int G,
    int S, int B, int CAP, int K, int NB, int NBL, int WMAX, void* stream) {
  const int threads = (K + 31) / 32 * 32;
  const size_t smem = (size_t)(4 * NBL + 4 * K + 32) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rle_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rle_replay_kernel<<<dim3(B, G), threads, smem, (cudaStream_t)stream>>>(
      pos, dlen, ilen, start, wcol, ol, orr, ordp, lenp, blk_out, rows_out,
      meta_out, err, work_o, work_l, S, B, CAP, K, NB, NBL, WMAX);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
