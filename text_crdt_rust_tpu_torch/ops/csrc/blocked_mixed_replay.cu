// Per-character blocked replay of a mixed local/remote stream, the whole
// document in shared memory, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// text_crdt_rust_tpu/ops/blocked_mixed.py::_mixed_kernel and computes what
// it computes, bit for bit. The plain PyTorch version of the same function
// is text_crdt_rust_tpu_torch/ops/blocked_mixed.py::
// blocked_mixed_replay_plain; the two are held against each other on the
// card.
//
// What it computes. Replay one shared op stream into B identical documents
// on the block layout of blocked_ops.cuh, with every op kind:
// - KIND_LOCAL: the local delete and insert of blocked_ops.cuh;
// - KIND_REMOTE_INS: the YATA conflict scan over raw positions
//   (`doc.rs:183-222`) with the reference's pinned scan_start rule, then
//   the shared splice at the raw cursor;
// - KIND_REMOTE_DEL: a bitmask walk over the (<= 16) target orders; each
//   pass resolves the lowest open order to its block, flips every in-range
//   row there and retires their bits (a sum of distinct powers of two:
//   each order occurs once).
// The by-order tables (128 orders a row: oll, orl mutable, rkl read-only)
// come prefilled from the host; a splice records its run's origin left and
// origins right. err row 0: the rebalance found fill > K - lmax; row 1: a
// delete ran past the end or left targets unresolved; row 2: an order
// absent from the document. The TPU kernel's order -> block hints are
// scratch that no output reads; this kernel finds an order through the
// view below instead.
//
// Mapping. One thread block per lane, warp 0 running the step chain
// (blocked_ops.cuh). The document's CAP rows (32,768 at the config-4 storm,
// 128 KB) and the block tables live in shared memory; the two mutable
// tables (53 KB each at the storm) do not fit beside them, so each lane
// keeps its own copy in device memory (the TPU kernel holds one
// lane-replicated copy in VMEM); rkl is read by all lanes. The rebalance
// goes through a lane-private scratch in device memory.
//
// The conflict scan. Before each remote insert every warp of the thread
// block builds a view of the state in one pass over the packed rows, as
// the plain version's `raw_view` does: each block's raw offset (`pre`, the
// exclusive prefix of its rows), each raw position's row (`at`) and each
// order's raw position (`where`, kAbsent when absent), the last two as
// 16-bit entries (a document in shared memory has fewer than 65,535
// rows), in shared memory beside the document when they fit (they do at
// the storm: 225,312 of 232,448 bytes), else in lane-private device
// memory. A cursor after an order is then one read, and an item two.
// Warp 0 scans kSub x 32 raw positions at a time, a lane a position:
// each lane reads its item, its order's origins and rank and the view's
// cursor after its origin-left, and computes the serial rule's flags; ballots find the first position that
// breaks the scan, and the equal-origin positions before it update
// `scanning`/`scan_start` in order (the last tie the insert wins resets
// the scan, the first tie it loses after that pins scan_start). An
// origin-left absent from the view (only invalid streams) ends the window
// there: that position takes the serial step with the search over the
// whole state, err row 2 and the clamped cursor included.
//
// What bounds it. Not bytes (the output, the origins and the tables, a few
// tens of MB). The conflict scan over the storm's 9,651,184 positions a
// lane, a chain of dependent windows, bounds it; each window is one round
// trip to the L2-resident tables, and the per-insert view is a pass over
// the document in shared memory by every warp.

#include <cuda_runtime.h>

#include "blocked_ops.cuh"

namespace {

using namespace blocked_ops;

constexpr int kLanes = 128;  // orders per by-order table row
constexpr int kLocal = 0, kRemoteIns = 1, kRemoteDel = 2;
constexpr int kJobView = 2;
constexpr int kWarps = 8;    // warp 0 scans; all build the view, rebalance
constexpr int kSub = 4;      // 32-position sub-windows a scan window
constexpr unsigned short kAbsent = 0xffff;  // `where` of an absent order
// A position's flags under the serial rule.
constexpr int kNone = 0, kBrk = 1, kReset = 2, kSet = 3, kUnknown = 4;

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

struct Mixed : Blocked {
  int* oll;         // this lane's [OTL] tables, device memory
  int* orl;
  const int* rkl;   // [OTL], read-only, all lanes
  int* pre;         // shared [NB + 1]: the view's raw offset of each block
  unsigned short* where;  // [OTL]: the view's raw position of each order
  unsigned short* at;     // [CAP]: the view's row of each raw position
  int OT, OTL, DMAX;
  int scan_steps, windows;  // warp 0's tallies

  __device__ void do_job(int j) {
    if (j == kJobView) view_pass();
    else rebalance_pass();
  }

  __device__ int tab_index(int o) const {
    const int q = floordiv(o, kLanes);
    return clampi(q, 0, OT - 1) * kLanes + (o - q * kLanes);
  }
  // tab[start, start+n) = v through the TPU kernel's two-row window.
  __device__ void write_run(int* tab, int start, int n, int v) const {
    const int r0 = floordiv(start, kLanes);
    const int r0c = clampi(r0, 0, OT - 2);
    for (int gi = start + ln; gi < start + n; gi += 32) {
      const int q = gi - r0 * kLanes;
      if (q >= 0 && q < 2 * kLanes) tab[r0c * kLanes + q] = v;
    }
  }
  // The origin tables of a spliced run (warp 0).
  __device__ void record(int st, int il, int left, int right) {
    if (ln == 0) oll[tab_index(st)] = left;
    write_run(orl, st, il, right);
    __syncwarp();
  }

  // -- the view (every warp) ---------------------------------------------

  __device__ void view_pass() {
    unsigned* w2 = reinterpret_cast<unsigned*>(where);  // OTL is even
    for (int i = t; i < OTL / 2; i += T) w2[i] = 0xffffffffu;
    if (warp == 0) {
      int run = 0;
      for (int i0 = 0; i0 < NB; i0 += 32) {
        const int i = i0 + ln;
        const int x = i < NB ? min(rws[i], K) : 0;
        const int s = warp_scan(x) + run;
        if (i < NB) pre[i] = s - x;
        run = __shfl_sync(kFull, s, 31);
      }
      if (ln == 0) pre[NB] = run;
    }
    job_barrier();
    for (int b = warp; b < NB; b += T >> 5) {
      const int off = pre[b], rows = pre[b + 1] - off;
      for (int r = ln; r < rows; r += 32) {
        const int v = sig[b * K + r];
        const int o = (v < 0 ? -v : v) - 1;
        if (o >= 0 && o < OTL) where[o] = (unsigned short)(off + r);
        at[off + r] = (unsigned short)(b * K + r);
      }
    }
  }

  // The item at raw position p < pre[NB] of the view.
  __device__ int item_at(int p) const { return sig[at[p]]; }

  // -- order lookups (warp 0) --------------------------------------------

  // Smallest row index holding order o (either sign) in the whole state,
  // CAP when none does.
  __device__ int find_order(int o) const {
    for (int g0 = 0; g0 < CAP; g0 += 32) {
      const int g = g0 + ln;
      const int v = g < CAP ? sig[g] : 0;
      const unsigned m = __ballot_sync(
          kFull, g < CAP && (v == o + 1 || v == -(o + 1)));
      if (m) return g0 + __ffs(m) - 1;
    }
    return CAP;
  }
  // (block, row) of order o; an absent order raises err row 2 and gives
  // block NB, row 0.
  __device__ void locate_order(int o, int* b, int* row) const {
    const int g = find_order(o);
    if (g == CAP) raise_err(2);
    *b = g / K;
    *row = g % K;
  }
  // The raw cursor after order o: 0 after ROOT, one read of the view, or
  // for an order absent from it the search of the whole state.
  __device__ int cursor_after(int o) const {
    if (o == -1) return 0;
    if (o >= 0 && o < OTL && where[o] != kAbsent) return where[o] + 1;
    int b, row;
    locate_order(o, &b, &row);
    return raw_before_block(b) + row + 1;
  }

  // -- the conflict scan (warp 0) ----------------------------------------

  // The flags under the serial rule of this lane's position in each of
  // the kSub sub-windows from `cursor` (kNone past n; kUnknown when the
  // item's origin-left is not in the view). Branch-free, each stage's
  // loads issued for every sub-window together: one round trip to the
  // tables serves the window.
  __device__ void look(int cursor, int n, int lc, int my_rank, int o_right,
                       int* f) const {
    int ti[kSub], left[kSub], right[kSub], rank[kSub], other[kSub];
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const int p = cursor + s * 32 + ln;
      const int v = sig[at[p < n ? p : 0]];
      other[s] = (v < 0 ? -v : v) - 1;
      ti[s] = tab_index(other[s]);
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      left[s] = oll[ti[s]];
      right[s] = orl[ti[s]];
      rank[s] = rkl[ti[s]];
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const bool in_view = left[s] >= 0 && left[s] < OTL;
      const int w = where[in_view ? left[s] : 0];
      const bool known = left[s] == -1 || (in_view && w != kAbsent);
      const int olc = left[s] == -1 ? 0 : w + 1;
      const bool cut = other[s] == o_right || olc < lc;
      const bool eq = !cut && olc == lc;
      const bool gt = my_rank > rank[s];
      const int flag = cut || (eq && !gt && o_right == right[s])
                           ? kBrk
                           : (!eq ? kNone : (gt ? kReset : kSet));
      f[s] = cursor + s * 32 + ln >= n ? kNone : (known ? flag : kUnknown);
    }
  }

  // The serial rule over one position (every lane at the same p): returns
  // whether the scan breaks there.
  __device__ bool serial_step(int p, int lc, int my_rank, int o_right,
                              bool* scanning, int* scan_start) const {
    const int v = item_at(p);
    const int other = (v < 0 ? -v : v) - 1;
    const int ti = tab_index(other);
    const int left = oll[ti], right = orl[ti], rank = rkl[ti];
    const int olc = cursor_after(left);
    bool brk = other == o_right || olc < lc;
    const bool eq = !brk && olc == lc;
    const bool gt = my_rank > rank;
    brk = brk || (eq && !gt && o_right == right);
    if (eq && !gt && o_right != right && !*scanning) *scan_start = p;
    if (eq) *scanning = gt ? false : (o_right == right ? *scanning : true);
    return brk;
  }

  // The ties of positions base .. base+31 before the first break, in
  // order: a won tie (reset) stops the scan, the first lost one after it
  // (set) pins scan_start.
  __device__ static void apply(unsigned reset, unsigned set, int base,
                               bool* scanning, int* scan_start) {
    if (reset) {
      const int last = 31 - __clz(reset);
      const unsigned after = last == 31 ? 0u : set & (kFull << (last + 1));
      *scanning = after != 0u;
      if (after) *scan_start = base + __ffs(after) - 1;
    } else if (set && !*scanning) {
      *scanning = true;
      *scan_start = base + __ffs(set) - 1;
    }
  }

  // The YATA conflict scan (`doc.rs:183-222`), pinned-scan_start rule,
  // over the view of n raw positions, from left cursor lc.
  __device__ int integrate_cursor(int lc, int my_rank, int o_right, int n) {
    int cursor = lc, scan_start = lc;
    bool scanning = false;
    while (cursor < n) {
      ++windows;
      int f[kSub];
      look(cursor, n, lc, my_rank, o_right, f);
      unsigned brk[kSub], stop[kSub], reset[kSub], set[kSub];
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        brk[s] = __ballot_sync(kFull, f[s] == kBrk);
        stop[s] = brk[s] | __ballot_sync(kFull, f[s] == kUnknown);
        reset[s] = __ballot_sync(kFull, f[s] == kReset);
        set[s] = __ballot_sync(kFull, f[s] == kSet);
      }
      for (int s = 0; s < kSub && cursor < n; ++s) {
        const int lim = stop[s] ? __ffs(stop[s]) - 1 : min(32, n - cursor);
        const unsigned below = lim >= 32 ? kFull : (1u << lim) - 1u;
        apply(reset[s] & below, set[s] & below, cursor, &scanning,
              &scan_start);
        scan_steps += lim;
        cursor += lim;
        if (!stop[s]) continue;
        ++scan_steps;
        if (((brk[s] >> lim) & 1u) ||
            serial_step(cursor, lc, my_rank, o_right, &scanning,
                        &scan_start))
          return scanning ? scan_start : cursor;
        ++cursor;  // the serial step passed; scan on from the next one
        break;
      }
    }
    return scanning ? scan_start : cursor;
  }

  // -- the ops (warp 0) ----------------------------------------------------

  // Smallest block holding raw position c, clamped to the last block.
  __device__ int block_of_raw(int c) const {
    int before;
    return min(count_below(rws, NB, c + 1, &before), NB - 1);
  }

  __device__ void local_insert_mixed(int p, int il, int st, int* ol_k,
                                     int* or_k) {
    const Target x = insert_target(*this, p, il);
    const int left = p == 0 ? -1 : (int)order_of(x.left);
    const int right = x.succ == 0 ? -1 : (int)order_of(x.succ);
    splice(x.b, x.c, il, st);
    record(st, il, left, right);
    if (ln == 0) {
      *ol_k = left;
      *or_k = right;
    }
  }

  __device__ void remote_insert(int my_rank, int o_left, int o_right, int il,
                                int st, int* ol_k, int* or_k) {
    run_job(*this, kJobView);
    const int lc = cursor_after(o_left);
    const int raw = integrate_cursor(lc, my_rank, o_right, pre[NB]);
    int b = block_of_raw(raw);
    if (block_rows(b) + il > K) {
      rebalance(*this);  // the raw cursor is invariant under a rebalance
      b = block_of_raw(raw);
    }
    const int c = raw - raw_before_block(b);
    splice(b, c, il, st);
    record(st, il, o_left, o_right);
    if (ln == 0) {
      *ol_k = o_left;
      *or_k = o_right;
    }
  }

  // Tombstone orders [tg, tg+dl).
  __device__ void remote_delete(int tg, int dl) {
    int mask = (1 << dl) - 1, iters = 0;
    while (mask != 0 && iters <= DMAX) {
      const int low = mask & -mask;
      int b, row;
      locate_order(tg + __ffs(low) - 1, &b, &row);
      int* rows = blk(b, true);
      const int n = bound(b);
      int flips = 0, bits = 0;
      for (int r0 = 0; r0 < n; r0 += 32) {
        const int k = r0 + ln;
        const int v = k < n ? rows[k] : 0;
        const int diff = (v < 0 ? -v : v) - 1 - tg;
        if (v != 0 && diff >= 0 && diff < dl) {
          bits += 1 << clampi(diff, 0, 30);
          if (v > 0) {
            rows[k] = -v;  // only this lane touches row k here
            ++flips;
          }
        }
      }
      const int F = warp_sum(flips);
      bits = warp_sum(bits);
      add_live(b, -F);
      __syncwarp();
      mask &= ~bits;
      ++iters;
    }
    if (mask != 0) raise_err(1);
  }
};

__global__ void __launch_bounds__(kMaxThreads, 1) blocked_mixed_replay_kernel(
    const int* __restrict__ kind, const int* __restrict__ pos,
    const int* __restrict__ dlen, const int* __restrict__ dtgt,
    const int* __restrict__ olop, const int* __restrict__ orop,
    const int* __restrict__ rank, const int* __restrict__ ilen,
    const int* __restrict__ start,                     // [S] op columns
    const int* __restrict__ oll_in, const int* __restrict__ orl_in,
    const int* __restrict__ rkl,                       // [OTL] tables
    int* ol, int* orr,     // [S, B] u32 bits, zeroed by the caller
    int* signed_out,       // [CAP, B]
    int* rows_out,         // [NBp, B]
    int* err,              // [8, B], zeroed by the caller
    int* tmp,              // [B, CAP] rebalance scratch
    int* oll, int* orl,    // [B, OTL] lane-private tables
    unsigned short* view_dev,  // [B, OTL + CAP] the view's where and at,
                               // or null when they sit in shared memory
    int* stats,            // [2, B] scan steps and windows, or null
    int S, int B, int CAP, int K, int NB, int NBp, int LMAX, int DMAX,
    int OTL) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x;
  Mixed X;
  X.init(threadIdx.x);
  X.B = B;
  X.lane = lane;
  X.K = K;
  X.NB = NB;
  X.NBp = NBp;
  X.NSUP = 0;
  X.LMAX = LMAX;
  X.CAP = CAP;
  X.two_level = false;
  X.cached = false;
  X.sig = smem;
  X.pre = place_tables(X, smem + CAP, 0);
  X.where = view_dev != nullptr
                ? view_dev + (size_t)lane * (OTL + CAP)
                : reinterpret_cast<unsigned short*>(X.pre + NB + 1);
  X.at = X.where + OTL;
  X.tmp = tmp + (size_t)lane * CAP;
  X.err = err;
  X.oll = oll + (size_t)lane * OTL;
  X.orl = orl + (size_t)lane * OTL;
  X.rkl = rkl;
  X.OT = OTL / kLanes;
  X.OTL = OTL;
  X.DMAX = DMAX;
  X.scan_steps = 0;
  X.windows = 0;
  zero(smem, CAP + table_ints(NBp, 0));
  for (int i = X.t; i < OTL; i += X.T) {
    X.oll[i] = oll_in[i];
    X.orl[i] = orl_in[i];
  }
  __syncthreads();

  if (X.warp == 0) {
    Columns<9> cols{{kind, pos, dlen, dtgt, olop, orop, rank, ilen, start}};
    for (int k0 = 0; k0 < S; k0 += 32) {
      cols.load(k0, S, 0);
      const int n = min(32, S - k0);
      for (int j = 0; j < n; ++j) {
        const int kd = cols.get(0, j), p = cols.get(1, j);
        const int d = cols.get(2, j), il = cols.get(7, j);
        const size_t o = (size_t)(k0 + j) * B + lane;
        if (kd == kLocal && d > 0) X.local_delete(p, d);
        if (kd == kLocal && il > 0)
          X.local_insert_mixed(p, il, cols.get(8, j), ol + o, orr + o);
        if (kd == kRemoteIns && il > 0)
          X.remote_insert(cols.get(6, j), cols.get(4, j), cols.get(5, j), il,
                          cols.get(8, j), ol + o, orr + o);
        if (kd == kRemoteDel) X.remote_delete(cols.get(3, j), d);
      }
    }
    if (stats != nullptr && X.ln == 0) {
      stats[lane] = X.scan_steps;
      stats[B + lane] = X.windows;
    }
    X.end_jobs();
  } else {
    X.serve(X);
  }
  __syncthreads();
  for (int r = X.t; r < CAP; r += X.T)
    signed_out[(size_t)r * B + lane] = X.sig[r];
  for (int j = X.t; j < NBp; j += X.T) rows_out[(size_t)j * B + lane] = X.rws[j];
}

}  // namespace

extern "C" int blocked_mixed_replay_launch(
    const int* kind, const int* pos, const int* dlen, const int* dtgt,
    const int* olop, const int* orop, const int* rank, const int* ilen,
    const int* start, const int* oll_in, const int* orl_in, const int* rkl,
    int* ol, int* orr, int* signed_out, int* rows_out, int* err, int* tmp,
    int* oll, int* orl, unsigned short* view_dev, int* stats, int S, int B,
    int CAP, int K, int NB, int NBp, int LMAX, int DMAX, int OTL, int smem,
    void* stream) {
  // smem: bytes of the kernel's shared layout, from the Python wrapper
  // (ops/blocked_mixed.py::kernel_smem_bytes), which also refuses K below
  // 8 and a document past the shared-memory limit, and
  // passes view_dev when the view's tables do not fit beside the
  // document.
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blocked_mixed_replay_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  blocked_mixed_replay_kernel<<<B, kWarps * 32, smem, (cudaStream_t)stream>>>(
      kind, pos, dlen, dtgt, olop, orop, rank, ilen, start, oll_in, orl_in,
      rkl, ol, orr, signed_out, rows_out, err, tmp, oll, orl, view_dev,
      stats, S, B, CAP, K, NB, NBp, LMAX, DMAX, OTL);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
