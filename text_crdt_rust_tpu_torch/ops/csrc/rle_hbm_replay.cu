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
// Mapping. One thread block per (lane, group) of ceil(K/4) threads rounded
// to whole warps (32-512), each holding up to 4 consecutive rows of the
// K-row block (K <= 2,048). The
// sequential chunk axis of the TPU grid becomes a loop over all steps in
// the thread block. As on the TPU, one block is cached: the window lives
// in shared memory (write-back: the evicted block is written to the
// planes, the wanted one read), beside the slot tables and supliv. A split
// writes the fresh block's rows straight to the planes. The next-slot peek
// for a boundary insert's origin reads the planes: distinct logical slots
// hold distinct physical blocks, so the peeked block is never the cached
// one and its rows in the planes are current. The planes are the public
// [G*CAP, B] arrays themselves (no working copy): at kevin's 5M prepends
// they hold 10.75 GB. In-block prefix sums are thread-local prefixes
// joined by a block scan; the descent runs in warp 0 and is broadcast.
// Every lane replays the same stream, so the TPU kernel's lane-max control
// scalars equal this thread block's own.
//
// What bounds it. Not bytes: kevin writes its used blocks once, ~10 GB,
// ~3 ms at 3.35 TB/s. The floor is the serial chain of dependent steps
// (78,125 fused steps at kevin): each step is a few block-wide scans and
// reductions over one K-row window in shared memory, one splice, and, at
// a split, a shift of the slot tables and a supliv rebuild. The design
// keeps all of a step inside one thread block (no launches, no grid-wide
// synchronisation), keeps the window in shared memory so that kevin's
// prepends, which always land in slot 0's physical block, never touch the
// planes but to split, and runs all B x G chains at once.

#include <cuda_runtime.h>

#include "block_ops.cuh"

namespace {

using namespace block_ops;

constexpr unsigned kRoot = 0xffffffffu;  // ROOT_ORDER
constexpr int kSup = 64;                 // slots per super-segment
constexpr int kMaxR = 4;                 // rows a thread holds
constexpr int kMaxThreads = 512;

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Exclusive prefix sum over the 32 lanes of a warp.
__device__ __forceinline__ int warp_excl_scan(int v) {
  const int lane = threadIdx.x & 31;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += n;
  }
  return x - v;
}

struct Hbm {
  int* ordp;  // this group's planes [CAP, B], row stride B
  int* lenp;
  int* wo;  // shared [K] window: ordp / lenp rows of the cached block
  int* wl;
  int* sa;  // shared [K] scratch: inclusive live cumsum, or delete cs
  int* sb;  // shared [K] scratch: live length, or delete ce
  int* blkord;  // shared [NBL]
  int* rws;
  int* liv;
  int* supliv;  // shared [NSUPp]
  int* red;     // shared [32] reduction scratch
  int* ctl;     // shared [8] broadcast scratch
  int* err;     // [8, B]
  int B, lane, K, NB, NBL, NSUP, WMAX, t, T, R;
  int nlog;    // blocks in use; identical in every thread
  int cached;  // physical block held by the window

  __device__ size_t at(int b, int r) const {
    return ((size_t)b * K + r) * B + lane;
  }
  // Row r of a shared row array; outside the block reads 0, as the TPU
  // kernel's masked sums do.
  __device__ int row(const int* arr, int r) const {
    return (r >= 0 && r < K) ? arr[r] : 0;
  }

  // Warp 0 computes v (its lanes only), every thread gets it.
  __device__ int broadcast(int v) {
    __syncthreads();  // earlier readers of ctl are done
    if (t == 0) ctl[0] = v;
    __syncthreads();
    return ctl[0];
  }

  // Sum of supliv[0, s) over warp 0's lanes (each lane a contiguous run).
  __device__ int sup_before(int s) const {
    const int ln = t & 31, C = (NSUP + 31) / 32;
    int v = 0;
    for (int i = ln * C; i < ln * C + C && i < s && i < NSUP; ++i)
      v += supliv[i];
    return warp_sum(v);
  }

  // Sum of liv[s*kSup, l) over warp 0 (two slots a lane).
  __device__ int seg_before(int s, int l) const {
    const int i0 = s * kSup + 2 * (t & 31);
    const int v = (i0 < l ? liv[i0] : 0) + (i0 + 1 < l ? liv[i0 + 1] : 0);
    return warp_sum(v);
  }

  __device__ int live_before_slot(int l) {
    int v = 0;
    if (t < 32) {
      const int s = l / kSup;
      v = sup_before(s) + seg_before(s, l);
    }
    return broadcast(v);
  }

  // Two-level descent: the smallest super-segment whose inclusive prefix
  // reaches rank1 (clamped to NSUP-1), then the slots of that segment whose
  // inclusive prefix stays below what remains (clamped to nlog-1).
  __device__ int slot_of_live_rank(int rank1) {
    int v = 0;
    if (t < 32) {
      const int ln = t & 31, C = (NSUP + 31) / 32;
      const int lo = ln * C, hi = min(lo + C, NSUP);
      int part = 0;
      for (int i = lo; i < hi; ++i) part += supliv[i];
      int run = warp_excl_scan(part), cnt = 0;
      for (int i = lo; i < hi; ++i) {
        run += supliv[i];
        cnt += run < rank1;
      }
      const int s = min(warp_sum(cnt), NSUP - 1);
      const int base = sup_before(s);
      const int i0 = s * kSup + 2 * ln;
      const int a0 = liv[i0], a1 = liv[i0 + 1];
      const int c0 = warp_excl_scan(a0 + a1) + a0;
      const int rest = rank1 - base;
      const int within = warp_sum((c0 < rest) + (c0 + a1 < rest));
      v = min(s * kSup + within, nlog - 1);
    }
    return broadcast(v);
  }

  // Caches physical block b in the window. Callers have synchronised since
  // the window was last read.
  __device__ void ensure(int b) {
    if (b == cached) return;
    for (int r = t; r < K; r += T) {
      ordp[at(cached, r)] = wo[r];
      lenp[at(cached, r)] = wl[r];
      wo[r] = ordp[at(b, r)];
      wl[r] = lenp[at(b, r)];
    }
    cached = b;
    __syncthreads();
  }

  // Rebuilds supliv[0, NSUP) from liv, one warp a segment.
  __device__ void resup() {
    __syncthreads();  // liv is final; earlier readers of supliv are done
    const int ln = t & 31;
    for (int s = t >> 5; s < NSUP; s += T >> 5) {
      const int v = warp_sum(liv[s * kSup + ln] + liv[s * kSup + 32 + ln]);
      if (ln == 0) supliv[s] = v;
    }
    __syncthreads();
  }

  // Leaf split of logical slot l into a fresh physical block at slot l+1.
  __device__ void split(int l) {
    if (nlog >= NB) {
      if (t == 0) err[lane] = 1;  // err row 0
      return;
    }
    const int b = blkord[l];
    ensure(b);
    const int r = rws[l];
    const int keep = r / 2, mv = r - keep, nb = nlog;
    int hi_part = 0;
    for (int k = t; k < K; k += T)
      if (k >= keep && k < r && wo[k] > 0) hi_part += wl[k];
    const int liv_hi = block_reduce(hi_part, red, SumOp());
    const int liv_lo = liv[l] - liv_hi;
    const int up = roll_amount(keep, K, K);
    for (int k = t; k < K; k += T) {
      const int src = (k + up) % K;
      ordp[at(nb, k)] = k < mv ? wo[src] : 0;
      lenp[at(nb, k)] = k < mv ? wl[src] : 0;
    }
    __syncthreads();  // the window's top half is read
    for (int k = t; k < K; k += T) {
      if (k >= keep) {
        wo[k] = 0;
        wl[k] = 0;
      }
    }
    // Slots > l take their predecessor's entry (the TPU kernel's circular
    // roll by one, masked to rows > l: the last entry drops off). Top down,
    // T entries a round.
    for (int top = NBL - 1; top > l; top -= T) {
      const int j = top - t;
      int vb = 0, vr = 0, vl = 0;
      if (j > l) {
        vb = blkord[j - 1];
        vr = rws[j - 1];
        vl = liv[j - 1];
      }
      __syncthreads();
      if (j > l) {
        blkord[j] = vb;
        rws[j] = vr;
        liv[j] = vl;
      }
      __syncthreads();
    }
    if (t == 0) {
      rws[l] = keep;
      liv[l] = liv_lo;
      blkord[l + 1] = nb;
      rws[l + 1] = mv;
      liv[l + 1] = liv_hi;
    }
    nlog += 1;
    resup();
  }

  // Inclusive prefix over the K window rows of v[j] (row t*R + j), each
  // thread's rows contiguous. Rows >= K must carry 0.
  __device__ void block_prefix(const int (&v)[kMaxR], int (&cum)[kMaxR]) {
    int tot = 0;
    #pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      tot += j < R ? v[j] : 0;
      cum[j] = tot;
    }
    const int excl = block_scan(tot, red) - tot;
    #pragma unroll
    for (int j = 0; j < kMaxR; ++j) cum[j] += excl;
  }

  __device__ void do_insert(int p, int il, int st, int w, int* ol_k,
                            int* or_k) {
    int l = p == 0 ? 0 : slot_of_live_rank(p);
    int r0 = rws[l];
    if (r0 + w + 1 > K) split(l);
    l = p == 0 ? 0 : slot_of_live_rank(p);
    r0 = rws[l];
    ensure(blkord[l]);
    const int local = p - live_before_slot(l);

    // Locate the run holding live char #local.
    int lv[kMaxR], cum[kMaxR];
    #pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      const int k = t * R + j;
      lv[j] = (j < R && k < K && wo[k] > 0) ? wl[k] : 0;
    }
    block_prefix(lv, cum);
    int cnt = 0;
    #pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      const int k = t * R + j;
      if (j < R && k < K) {
        sa[k] = cum[j];
        sb[k] = lv[j];
        cnt += cum[j] < local && k < r0;
      }
    }
    const int i_r = block_reduce(cnt, red, SumOp());  // also publishes sa/sb
    const int o_r = row(wo, i_r), l_r = row(wl, i_r);
    const int off = local - (row(sa, i_r) - row(sb, i_r));
    const bool is_split = p > 0 && off < l_r;

    // Origins from the PRE-splice state: the run head's left neighbour and
    // the raw successor (tombstones not skipped); past the block's last
    // run, the next slot's first row, read from the planes.
    if (t == 0 && ol_k != nullptr) {
      const unsigned left =
          p == 0 ? kRoot : (unsigned)(o_r - 1) + (unsigned)(off - 1);
      const bool need_peek =
          p > 0 && !is_split && i_r + 1 >= r0 && l + 1 < nlog;
      int succ_next = 0;
      if (need_peek) succ_next = ordp[at(blkord[min(l + 1, NBL - 1)], 0)];
      const int succ_p0 = r0 > 0 ? wo[0] : 0;
      const int succ =
          p == 0 ? succ_p0
                 : (is_split ? o_r + off
                             : (i_r + 1 < r0 ? row(wo, i_r + 1) : succ_next));
      const unsigned right =
          succ == 0 ? kRoot : (unsigned)((succ < 0 ? -succ : succ) - 1);
      *ol_k = (int)left;
      *or_k = (int)right;
    }

    // Fused W-row splice.
    const int lrun = il / (w > 1 ? w : 1);
    const bool mrg = w == 1 && p > 0 && off == l_r && st + 1 == o_r + l_r;
    const int ins_at = p == 0 ? 0 : i_r + 1;
    const int amt = mrg ? 0 : w + (is_split ? 1 : 0);
    const int a = roll_amount(amt, WMAX + 1, K);
    int no[kMaxR], nl[kMaxR];
    #pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      const int k = t * R + j;
      if (j >= R || k >= K) continue;
      const int src = roll_src(k, a, K);
      no[j] = k < ins_at ? wo[k] : wo[src];
      nl[j] = k < ins_at ? wl[k] : wl[src];
      if (is_split && k == i_r) nl[j] = off;
      if (!mrg && k >= ins_at && k < ins_at + w) {
        no[j] = st + il - (k - ins_at + 1) * lrun + 1;
        nl[j] = lrun;
      }
      if (is_split && k == ins_at + w) {
        no[j] = o_r + off;
        nl[j] = l_r - off;
      }
      if (mrg && k == i_r) nl[j] = l_r + il;
    }
    __syncthreads();  // every read of the window is done
    #pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      const int k = t * R + j;
      if (j >= R || k >= K) continue;
      wo[k] = no[j];
      wl[k] = nl[j];
    }
    if (t == 0) {
      rws[l] += amt;
      liv[l] += il;
      supliv[l / kSup] += il;
    }
    __syncthreads();
  }

  // One boundary split of the delete: run i_p becomes [head?] [tombstone
  // mid] [tail?]. Returns the rows added.
  __device__ int apply_partial(bool active, int i_p) {
    if (!active) return 0;
    const int o = wo[i_p], ln = wl[i_p];
    const int cs_i = sa[i_p], ce_i = sb[i_p];
    const int cov_i = ce_i - cs_i;
    const bool has_head = cs_i > 0, has_tail = ce_i < ln;
    const int amt = (has_head ? 1 : 0) + (has_tail ? 1 : 0);
    const int a = roll_amount(amt, 2, K);
    int no[kMaxR], nl[kMaxR];
    #pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      const int k = t * R + j;
      if (j >= R || k >= K) continue;
      const int src = roll_src(k, a, K);
      no[j] = k <= i_p ? wo[k] : wo[src];
      nl[j] = k <= i_p ? wl[k] : wl[src];
      if (k == i_p) {
        no[j] = has_head ? o : -(o + cs_i);
        nl[j] = has_head ? cs_i : cov_i;
      }
      if (k == i_p + 1 && amt >= 1) {
        no[j] = has_head ? -(o + cs_i) : o + ce_i;
        nl[j] = has_head ? cov_i : ln - ce_i;
      }
      if (k == i_p + 2 && amt == 2) {
        no[j] = o + ce_i;
        nl[j] = ln - ce_i;
      }
    }
    __syncthreads();  // every read of the window is done
    #pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      const int k = t * R + j;
      if (j >= R || k >= K) continue;
      wo[k] = no[j];
      wl[k] = nl[j];
    }
    __syncthreads();
    return amt;
  }

  __device__ void do_delete(int p, int d) {
    int rem = d, iters = 0;
    // Each iteration clears one block's covered span; > 2*NBL iterations
    // means the delete ran off the document.
    while (rem > 0 && iters <= 2 * NBL) {
      int l = slot_of_live_rank(p + 1);
      if (rws[l] + 2 > K) split(l);
      l = slot_of_live_rank(p + 1);
      ensure(blkord[l]);
      const int base = live_before_slot(l);

      int lv[kMaxR], cum[kMaxR];
      #pragma unroll
      for (int j = 0; j < kMaxR; ++j) {
        const int k = t * R + j;
        lv[j] = (j < R && k < K && wo[k] > 0) ? wl[k] : 0;
      }
      block_prefix(lv, cum);
      int cov_sum = 0, npart_t = 0, i1_t = K, i2_t = -1;
      #pragma unroll
      for (int j = 0; j < kMaxR; ++j) {
        const int k = t * R + j;
        if (j >= R || k >= K) continue;
        const int before = base + cum[j] - lv[j];
        int cs = p - before, ce = p + rem - before;
        cs = cs < 0 ? 0 : (cs > lv[j] ? lv[j] : cs);
        ce = ce < 0 ? 0 : (ce > lv[j] ? lv[j] : ce);
        const int cov = ce - cs;
        const bool full = cov > 0 && cov == wl[k];
        const bool part = cov > 0 && !full;
        cov_sum += cov;
        if (part) {
          npart_t += 1;
          i1_t = min(i1_t, k);
          i2_t = max(i2_t, k);
        }
        sa[k] = cs;
        sb[k] = ce;
        if (full) wo[k] = -wo[k];  // only this thread reads row k here
      }
      const int tot = block_reduce(cov_sum, red, SumOp());
      const int npart = block_reduce(npart_t, red, SumOp());
      const int i1 = block_reduce(i1_t, red, MinOp());
      const int i2 = block_reduce(i2_t, red, MaxOp());
      // Higher-index boundary first so i1's row index stays valid.
      int added = apply_partial(npart >= 1, i2);
      added += apply_partial(npart == 2, i1);
      if (t == 0) {
        rws[l] += added;
        liv[l] -= tot;
        supliv[l / kSup] -= tot;
      }
      __syncthreads();
      rem -= tot;
      ++iters;
    }
    if (rem > 0 && t == 0) err[B + lane] = 1;  // err row 1
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
    int S, int B, int CAP, int K, int NB, int NBL, int NSUP, int WMAX,
    int store) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x, g = blockIdx.y;
  const int NSUPp = NSUP > 8 ? NSUP : 8;
  Hbm H;
  H.t = threadIdx.x;
  H.T = blockDim.x;
  H.R = (K + H.T - 1) / H.T;
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
  H.red = H.supliv + NSUPp;
  H.ctl = H.red + 32;
  H.err = err;
  // Fresh group: one empty block in logical slot 0, cached zeroed.
  H.nlog = 1;
  H.cached = 0;
  const int t = H.t, T = H.T;
  for (int j = t; j < 4 * K + 3 * NBL + NSUPp; j += T) smem[j] = 0;
  __syncthreads();

  const size_t base = (size_t)g * S;
  for (int k = 0; k < S; ++k) {
    const int p = pos[base + k], d = dlen[base + k], il = ilen[base + k];
    if (d > 0) H.do_delete(p, d);
    if (il > 0) {
      const int st = start[base + k];
      const int w = wcol[base + k] > 1 ? wcol[base + k] : 1;  // pads carry 0
      const size_t o = (base + k) * B + lane;
      H.do_insert(p, il, st, w, store ? ol + o : nullptr,
                  store ? orr + o : nullptr);
    }
  }
  __syncthreads();  // every thread's window and table writes are visible

  for (int r = t; r < K; r += T) {
    H.ordp[H.at(H.cached, r)] = H.wo[r];
    H.lenp[H.at(H.cached, r)] = H.wl[r];
  }
  for (int j = t; j < NBL; j += T) {
    const size_t o = ((size_t)g * NBL + j) * B + lane;
    blk_out[o] = H.blkord[j];
    rows_out[o] = H.rws[j];
  }
  for (int j = t; j < 8; j += T)
    meta_out[((size_t)g * 8 + j) * B + lane] = j == 0 ? H.nlog : 0;
}

}  // namespace

extern "C" int rle_hbm_replay_launch(
    const int* pos, const int* dlen, const int* ilen, const int* start,
    const int* wcol, int* ol, int* orr, int* ordp, int* lenp, int* blk_out,
    int* rows_out, int* meta_out, int* err, int G, int S, int B, int CAP,
    int K, int NB, int NBL, int NSUP, int WMAX, int store, int smem,
    void* stream) {
  // smem: bytes of the kernel's shared layout, from the Python wrapper
  // (ops/rle_hbm.py::kernel_smem_bytes), which also refuses K outside
  // [8, kMaxR * kMaxThreads]. Four rows a thread, whole warps: fewer
  // threads per block let more of the B x G blocks share an SM (1,024
  // documents at K = 512).
  const int threads = ((K + kMaxR - 1) / kMaxR + 31) / 32 * 32;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rle_hbm_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  rle_hbm_replay_kernel<<<dim3(B, G), threads, smem, (cudaStream_t)stream>>>(
      pos, dlen, ilen, start, wcol, ol, orr, ordp, lenp, blk_out, rows_out,
      meta_out, err, S, B, CAP, K, NB, NBL, NSUP, WMAX, store);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
