// The flat engine's step chain for Hopper (sm_90a): a [T, S, B] op stack
// applied to B lanes' flat documents in one launch.
//
// Replaces the XLA program text_crdt_rust_tpu/ops/flat.py builds for
// apply_ops / apply_ops_batch / apply_train (a lax.scan of the vmapped
// `step`, :148-257, with its data-dependent lax.while_loop, the YATA scan
// `_integrate_cursor`, :103-145): no pallas_call, but one device program
// per tick or tick train, whose loop PyTorch could only run with a host
// round trip per iteration. It computes what that program computes, bit
// for bit. The plain PyTorch version of the same function is
// text_crdt_rust_tpu_torch/ops/flat.py::flat_replay_plain; the two are held
// against each other on the card.
//
// What it computes. For t < T, s < S, when active[t][s] (the host's mask of
// steps that are active on any lane; all ones outside tick trains), one
// step of op (t, s, b) on lane b: a local delete tombstones the live-rank
// window (pos, pos + del_len], a remote delete the order range
// [del_target, del_target + del_len) (a wrapping u32 compare); the insert
// cursor is the row after the pos-th live item (local) or the YATA scan's
// row (remote insert); rows at or past the cursor shift right by ins_len
// (the TPU program's circular roll by ins_len's low bits) and the new run
// takes orders ins_order_start.. ; a local insert writes its two origins
// into the lmax-wide by-order log window at clip(ins_order_start, 0,
// OCAP - lmax). After every tick, flags[b] |= n > CAP or next_order >
// OCAP - lmax (u32).
//
// Mapping. One warp per lane, four lanes (warps) a thread block, fewer
// only where four lanes' columns do not fit its shared memory (the
// wrapper's choice, by shape). The warps of a block share nothing: every
// synchronisation is inside the warp (ballots, __syncwarp), and no block
// barrier is ever taken.
// - The lane's signed column lives in shared memory for the launch, one
//   copy, padded to 128 rows. Every pass covers rows [0, E): E is the
//   lane's nonzero extent, found at launch and after each splice
//   min(CAP, max(E, cursor) + ins_len). Rows past E are zero, so a pass
//   over them changes nothing and the TPU program's whole-column answers
//   follow from [0, E) (`oli` adds the zero rows past E in one term).
// - The live-prefix count, the delete mask and `oli` are one pass of
//   32-row chunks, four loaded together: the prefix is a ballot and a
//   popcount. A local op's pass stops after the group whose count passes
//   pos + del_len (no later row is deleted or lies below pos).
// - The splice moves rows [cursor, E) right by ins_len in place, top
//   first, one __syncwarp a group of four chunks: it never reads below
//   the cursor, because eff = ins_len & roll_mask <= ins_len. An ins_len
//   that wraps (negative as int32, or cursor + ins_len past 2^31) takes
//   the TPU program's full circular roll through the lane's row in device
//   memory.
// - Op staging: the steps come in tiles of 32 step indices, two tiles in
//   shared memory: while the warp runs tile k's active steps, cp.async
//   copies tile k + 1's op words (each lane one step's ten words); the
//   [T, S] mask is read two tiles ahead. A step never waits on device
//   memory for its own op.
// - The by-order logs stay in device memory (L2-resident at the serve
//   shapes): a YATA iteration reads three words of them, a local insert
//   writes its window there.
// - order -> row: a first-hit search, four 32-row chunks an iteration,
//   with ballots, that stops at the first chunk holding a hit: the first
//   nonzero row whose order matches, else row 0 (argmax of an all-false
//   mask). A YATA iteration whose row is the insert's right origin breaks
//   before any lookup.
// The STATS build counts each lane's work and clock64 cycles by phase.
//
// What bounds it. Bytes are small (the column in and out once per launch,
// the op stack once, three log words a YATA iteration); the floor is each
// lane's serial chain of steps, each a few passes of warp instructions
// over the rows in use. A step that neither deletes nor inserts only moves next_order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kRoot = 0xFFFFFFFFu;
constexpr int kTile = 32;                 // step indices a tile
constexpr int kWords = 10;                // op words a step
constexpr int kTileInts = kWords * kTile; // a tile's words, [word][step]
constexpr int kOpInts = 2 * kTileInts;    // ops/flat.py::_TILE_INTS
constexpr int kStats = 16;                // ops/flat.py::FLAT_STATS
constexpr int kUnroll = 4;                // 32-row chunks a pass iteration
constexpr int kGroup = 32 * kUnroll;      // rows a pass iteration; the
                                          // column pads to a multiple

// Op columns, in ops/flat.py::OP_COLUMNS order.
enum {
  C_KIND, C_POS, C_DLEN, C_DTGT, C_OL, C_OR, C_ILEN, C_IOS, C_ADV, C_RANK
};
constexpr uint32_t kKindLocal = 0, kKindRemoteIns = 1, kKindRemoteDel = 2;

// Counters of the STATS build, in ops/flat.py::FLAT_STAT_NAMES order.
enum {
  S_WORK, S_RINS, S_YATA, S_LOOKUPS, S_CHUNKS, S_EXTENT, S_PASS_ROWS,
  S_SPLICE_ROWS, S_CY_STAGE, S_CY_PASS, S_CY_YATA, S_CY_SPLICE, S_CY_LOG,
  S_CY_LOAD, S_CY_WRITE, S_CY_ALL
};

__device__ __forceinline__ uint32_t abs_u(int s) {
  return s < 0 ? 0u - (uint32_t)s : (uint32_t)s;
}

// Row content -> order (u32; garbage on empty rows).
__device__ __forceinline__ uint32_t order_of(int s) { return abs_u(s) - 1u; }

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One lane's state: all of it warp-uniform but `ln`.
struct Lane {
  int* sig;               // shared: the signed column, rows past E zero
  uint32_t* g_ol;         // device: this lane's logs
  uint32_t* g_or;
  const uint32_t* g_rank;
  int cap, ocap, E, ln;
  long long st[kStats];   // the STATS build's counters
};

// Copies `count` words of the column into shared memory (cp.async;
// 16-byte copies where both rows allow them).
__device__ __forceinline__ void stage_row(uint32_t* dst, const uint32_t* src,
                                          int count, int ln) {
  if ((count & 3) == 0 && ((uintptr_t)src & 15) == 0) {
    for (int i = 4 * ln; i < count; i += 128) cp_async16(dst + i, src + i);
  } else {
    for (int i = ln; i < count; i += 32) cp_async4(dst + i, src + i);
  }
}

// The lane's op stack in tiles of kTile step indices, two in shared
// memory: each call stages the next tile into buffer (tile & 1), the ten
// words of each of its steps by cp.async (one step a lane), and commits
// one cp.async group. The active mask is read two tiles ahead.
struct Tiles {
  const uint32_t* ops;   // ops + b
  const int* active;
  int* buf;              // shared, 2 x kTileInts
  size_t col_stride;     // T * S * B
  int B, TS, ln, staged;
  int act1, act2;        // this lane's active words, tiles staged + 0, + 1
  unsigned mask0, mask1; // active steps of the tiles in buffers 0 and 1

  __device__ void init() {
    staged = 0;
    act1 = ln < TS ? active[ln] : 0;
    act2 = kTile + ln < TS ? active[kTile + ln] : 0;
  }

  __device__ void stage() {
    const int base = staged * kTile;
    const int act = act1;
    act1 = act2;
    const int j = base + 2 * kTile + ln;
    act2 = j < TS ? active[j] : 0;
    int* const dst = buf + (staged & 1) * kTileInts;
    if (base + ln < TS) {  // active or not: no wait on the mask's load
      const uint32_t* src = ops + (size_t)(base + ln) * B;
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        cp_async4(dst + w * kTile + ln, src + w * col_stride);
    }
    const unsigned m = __ballot_sync(kFull, act != 0);
    if (staged & 1) {
      mask1 = m;
    } else {
      mask0 = m;
    }
    cp_async_commit();
    ++staged;
  }
};

// First row holding item `order`, 0 when none does: four 32-row chunks
// an iteration, their loads and ballots independent.
template <bool STATS>
__device__ __forceinline__ int row_of(Lane& L, uint32_t order) {
  if (STATS) ++L.st[S_LOOKUPS];
  for (int c = 0; c < L.E; c += kGroup) {
    unsigned m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int sj = L.sig[c + 32 * u + L.ln];
      m[u] = __ballot_sync(kFull, sj != 0 && order_of(sj) == order);
    }
    if (STATS) L.st[S_CHUNKS] += kUnroll;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (m[u]) return c + 32 * u + __ffs(m[u]) - 1;
    }
  }
  return 0;
}

template <bool STATS>
__device__ __forceinline__ int cursor_after(Lane& L, uint32_t order) {
  return order == kRoot ? 0 : row_of<STATS>(L, order) + 1;
}

// A log word: row clip(int32(order), 0, OCAP - 1).
__device__ __forceinline__ uint32_t read_log(const uint32_t* g,
                                             uint32_t order, const Lane& L) {
  return g[clampi((int)order, 0, L.ocap - 1)];
}

// The YATA conflict scan (`doc.rs:167-234`) on the post-delete column: the
// final row of a remote insert run.
template <bool STATS>
__device__ int integrate(Lane& L, int n, uint32_t my_rank,
                         uint32_t origin_left, uint32_t origin_right) {
  const int cursor0 = cursor_after<STATS>(L, origin_left);
  int cursor = cursor0, scan_start = cursor0;
  bool scanning = false;
  while (cursor < n) {
    if (STATS) ++L.st[S_YATA];
    const uint32_t other = order_of(L.sig[clampi(cursor, 0, L.cap - 1)]);
    if (other == origin_right) break;  // a break that changes no state
    const uint32_t other_left = read_log(L.g_ol, other, L);
    const uint32_t other_right = read_log(L.g_or, other, L);
    const uint32_t other_rank = read_log(L.g_rank, other, L);
    const int olc = cursor_after<STATS>(L, other_left);
    bool brk = olc < cursor0;
    const bool eq = !brk && olc == cursor0;
    const bool gt = my_rank > other_rank;  // name tiebreak, unsigned
    const bool same_right = origin_right == other_right;
    brk = brk || (eq && !gt && same_right);
    if (eq && !gt && !same_right && !scanning) scan_start = cursor;
    if (eq) scanning = !gt && (!same_right || scanning);
    if (brk) break;
    ++cursor;
  }
  return scanning ? scan_start : cursor;
}

// The delete phase and `oli` in one pass over [0, E): cum (the live
// prefix, inclusive) from ballots; a local delete flips the live-rank
// window (pos, pos_end], a remote delete the order range; `oli` counts the
// rows whose post-delete prefix is below pos, the zero rows past E in one
// term. A local op's pass stops after the chunk whose count passes
// pos_end when pos, del_len and pos_end are nonnegative and pos_end does
// not wrap: no later row is deleted, and each has cum2 = cum - del_len >
// pos.
template <bool STATS>
__device__ int prefix_pass(Lane& L, bool is_local, bool is_rdel, int pos,
                           uint32_t dlen_u, uint32_t dtgt, bool need_oli) {
  const int dlen = (int)dlen_u;
  const int pos_end = (int)((uint32_t)pos + dlen_u);
  const bool stop = is_local && pos >= 0 && dlen >= 0 && pos_end >= pos;
  const unsigned le = 0xffffffffu >> (31 - L.ln);
  int running = 0, below = 0;
  // Four chunks an iteration, loaded together. Chunks past the stopping
  // one change nothing: their rows have cum > pos_end.
  for (int c = 0; c < L.E; c += kGroup) {
    int sv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) sv[u] = L.sig[c + 32 * u + L.ln];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = c + 32 * u + L.ln;
      const int sj = sv[u];
      const bool live = sj > 0;
      const unsigned m = __ballot_sync(kFull, live);
      const int cj = running + __popc(m & le);
      running += __popc(m);
      bool del = false;
      if (is_local) {
        del = live && cj > pos && cj <= pos_end;
      } else if (is_rdel) {
        del = sj != 0 && (order_of(sj) - dtgt) < dlen_u;
      }
      if (del) L.sig[j] = (int)(0u - abs_u(sj));
      if (need_oli) {
        int c2 = cj;
        if (is_local) {
          int x = (int)((uint32_t)cj - (uint32_t)pos);
          x = x < 0 ? 0 : x;
          x = x > dlen ? dlen : x;
          c2 = cj - x;
        }
        below += __popc(__ballot_sync(kFull, j < L.E && c2 < pos));
      }
    }
    if (STATS) L.st[S_PASS_ROWS] += kGroup;
    if (stop && running > pos_end) return below;
  }
  if (need_oli) {
    int c2 = running;
    if (is_local) {
      int x = (int)((uint32_t)running - (uint32_t)pos);
      x = x < 0 ? 0 : x;
      x = x > dlen ? dlen : x;
      c2 = running - x;
    }
    if (c2 < pos) below += L.cap - L.E;
  }
  return below;
}

// Rows >= cursor take row j - ilen (the TPU program's circular roll by
// ilen's low bits), the new run [cursor, cursor + ilen) its orders; E
// grows to cover what moved.
template <bool STATS>
__device__ void splice(Lane& L, int* g_row, int cursor, int ilen,
                       uint32_t ios, int roll_mask) {
  const int eff = ilen & roll_mask;
  const int run_end = (int)((uint32_t)cursor + (uint32_t)ilen);
  const int ln = L.ln;
  if (run_end >= cursor) {
    // In place, top group of four chunks first, all its reads before its
    // writes: row j reads j - eff >= cursor, below every row a higher
    // group wrote.
    const int hi = min(L.cap, max(L.E, cursor) + min(ilen, L.cap));
    const int lo = cursor & ~31;
    for (int c = (hi - 1) & ~31; c >= lo; c -= kGroup) {
      // Four chunks, c down to c - 96: all reads, then all writes.
      int v[kUnroll];
      bool w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = c - 32 * u + ln;
        w[u] = c - 32 * u >= lo && j >= cursor && j < hi;
        v[u] = 0;
        if (w[u]) {
          v[u] = j < run_end ? (int)(ios + (uint32_t)(j - cursor) + 1u)
                             : L.sig[j - eff];
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (w[u]) L.sig[c - 32 * u + ln] = v[u];
      }
      if (STATS) L.st[S_SPLICE_ROWS] += kGroup;
    }
    L.E = hi;
  } else {
    // ilen wraps: every row >= cursor takes row (j - eff) mod CAP, through
    // a copy of the column in the lane's row of device memory.
    for (int j = ln; j < L.cap; j += 32) g_row[j] = L.sig[j];
    __threadfence_block();
    __syncwarp();
    for (int j = cursor + ln; j < L.cap; j += 32) {
      int src = (j - eff) % L.cap;
      if (src < 0) src += L.cap;
      L.sig[j] = g_row[src];
    }
    if (STATS) L.st[S_SPLICE_ROWS] += L.cap - cursor;
    L.E = L.cap;
  }
}

template <bool STATS>
__global__ void flat_replay_kernel(
                   int* __restrict__ g_signed, uint32_t* g_ol, uint32_t* g_or,
                   const uint32_t* g_rank, int* __restrict__ g_n,
                   uint32_t* __restrict__ g_next,
                   const uint32_t* __restrict__ ops,
                   const int* __restrict__ active, int* __restrict__ flags,
                   long long* __restrict__ stats, int T, int S, int B,
                   int CAP, int OCAP, int LMAX) {
  extern __shared__ __align__(16) int smem[];
  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b >= B) return;
  const long long t_all = STATS ? clock64() : 0;
  const int capp = (CAP + kGroup - 1) / kGroup * kGroup;
  int* const opbuf = smem + (size_t)w * (kOpInts + capp);
  Lane L;
  L.sig = opbuf + kOpInts;
  L.g_ol = g_ol + (size_t)b * OCAP;
  L.g_or = g_or + (size_t)b * OCAP;
  L.g_rank = g_rank + (size_t)b * OCAP;
  L.cap = CAP;
  L.ocap = OCAP;
  L.ln = ln;
  if (STATS) {
#pragma unroll
    for (int i = 0; i < kStats; ++i) L.st[i] = 0;
  }
  // cp.async groups ahead of the steps: the column (its padding rows
  // zeroed), the first two tiles of ops.
  int* const g_row = g_signed + (size_t)b * CAP;
  stage_row((uint32_t*)L.sig, (const uint32_t*)g_row, CAP, ln);
  for (int j = CAP + ln; j < capp; j += 32) L.sig[j] = 0;
  cp_async_commit();
  int n = g_n[b];
  uint32_t next_order = g_next[b];
  Tiles tiles;
  tiles.ops = ops + b;
  tiles.active = active;
  tiles.buf = opbuf;
  tiles.col_stride = (size_t)T * S * B;
  tiles.B = B;
  tiles.TS = T * S;
  tiles.ln = ln;
  tiles.init();
  tiles.stage();
  tiles.stage();

  // The column's nonzero extent: each lane's last nonzero row, then the
  // warp's largest.
  cp_async_wait<2>();
  __syncwarp();
  int last = -1;
  for (int j = ln; j < CAP; j += 32) {
    if (L.sig[j] != 0) last = j;
  }
  L.E = __reduce_max_sync(kFull, last) + 1;
  const uint32_t order_bound = (uint32_t)(OCAP - LMAX);
  bool flag = false;
  int tick = 0;
  const int nbits = 32 - __clz(LMAX > 1 ? LMAX : 1);
  const int roll_mask = (int)((1u << nbits) - 1u);
  if (STATS) L.st[S_CY_LOAD] = clock64() - t_all;

  int tick_end = S;  // the first step index past tick `tick`
  for (int k = 0; k * kTile < T * S; ++k) {
    long long c0 = STATS ? clock64() : 0;
    // Tile k's group is done once only tile k + 1's may be in flight.
    cp_async_wait<1>();
    __syncwarp();
    const int* const tile = opbuf + (k & 1) * kTileInts;
    unsigned m = (k & 1) ? tiles.mask1 : tiles.mask0;
    if (STATS) L.st[S_CY_STAGE] += clock64() - c0;
    while (m != 0) {
      c0 = STATS ? clock64() : 0;
      const int jt = __ffs(m) - 1;
      m &= m - 1;
      const int q = k * kTile + jt;
      const uint32_t kind = (uint32_t)tile[C_KIND * kTile + jt];
      const int pos = tile[C_POS * kTile + jt];
      const uint32_t dlen_u = (uint32_t)tile[C_DLEN * kTile + jt];
      const uint32_t dtgt = (uint32_t)tile[C_DTGT * kTile + jt];
      const uint32_t w_ol = (uint32_t)tile[C_OL * kTile + jt];
      const uint32_t w_or = (uint32_t)tile[C_OR * kTile + jt];
      const int w_ilen = tile[C_ILEN * kTile + jt];
      const uint32_t ios = (uint32_t)tile[C_IOS * kTile + jt];
      const uint32_t adv = (uint32_t)tile[C_ADV * kTile + jt];
      const uint32_t w_rank = (uint32_t)tile[C_RANK * kTile + jt];
      if (q >= tick_end) {  // ticks tick..t-1 all ended in this state
        const int t = q / S;
        flag = flag || n > CAP || next_order > order_bound;
        tick = t;
        tick_end = (t + 1) * S;
      }
      const bool is_local = kind == kKindLocal;
      const bool is_rins = kind == kKindRemoteIns;
      const bool is_rdel = kind == kKindRemoteDel;
      const int ilen = is_rdel ? 0 : w_ilen;
      if (ilen == 0 && (dlen_u == 0 || !(is_local || is_rdel))) {
        // Nothing to delete or insert: only the order counter moves.
        next_order += adv;
        if (STATS) L.st[S_CY_STAGE] += clock64() - c0;
        continue;
      }
      if (STATS) {
        const long long c1 = clock64();
        L.st[S_CY_STAGE] += c1 - c0;
        c0 = c1;
        ++L.st[S_WORK];
      }

      // ---- delete phase, oli ----------------------------------------------
      const bool need_oli = !is_rins && !is_rdel && pos != 0;
      int oli = 0;
      if (is_rdel ? dlen_u != 0 : need_oli || (is_local && dlen_u != 0)) {
        oli = prefix_pass<STATS>(L, is_local, is_rdel, pos, dlen_u, dtgt,
                                 need_oli);
        __syncwarp();
      }
      if (STATS) {
        const long long c1 = clock64();
        L.st[S_CY_PASS] += c1 - c0;
        c0 = c1;
      }

      // ---- insert phase -------------------------------------------------
      int cursor = pos == 0 ? 0 : oli + 1;
      if (is_rins) {
        if (STATS) ++L.st[S_RINS];
        cursor = integrate<STATS>(L, n, w_rank, w_ol, w_or);
        if (STATS) {
          const long long c1 = clock64();
          L.st[S_CY_YATA] += c1 - c0;
          c0 = c1;
        }
      } else if (is_local && ilen > 0) {
        // The lmax-wide log window of a local insert's origins.
        const uint32_t origin_left =
            pos == 0 ? kRoot : order_of(L.sig[clampi(oli, 0, CAP - 1)]);
        const uint32_t origin_right =
            cursor < n ? order_of(L.sig[clampi(cursor, 0, CAP - 1)]) : kRoot;
        const int start = clampi((int)ios, 0, OCAP - LMAX);
        const int kmax = min(LMAX, ilen);
        for (int k = ln; k < kmax; k += 32) {
          if (k == 0) L.g_ol[start] = origin_left;
          L.g_or[start + k] = origin_right;
        }
        if (STATS) {
          const long long c1 = clock64();
          L.st[S_CY_LOG] += c1 - c0;
          c0 = c1;
        }
      }
      if (ilen != 0 && cursor < CAP) {
        splice<STATS>(L, g_row, cursor, ilen, ios, roll_mask);
        if (STATS) L.st[S_CY_SPLICE] += clock64() - c0;
      }
      n = (int)((uint32_t)n + (uint32_t)ilen);
      next_order += adv;
      __syncwarp();
    }
    c0 = STATS ? clock64() : 0;
    __syncwarp();   // every lane is done reading tile k's words
    tiles.stage();  // tile k + 2 into the buffer tile k leaves
    if (STATS) L.st[S_CY_STAGE] += clock64() - c0;
  }
  if (T > 0) flag = flag || n > CAP || next_order > order_bound;
  cp_async_wait<0>();

  const long long c0 = STATS ? clock64() : 0;
  for (int j = ln; j < L.E; j += 32) g_row[j] = L.sig[j];
  if (ln == 0) {
    g_n[b] = n;
    g_next[b] = next_order;
    flags[b] = flag ? 1 : 0;
  }
  if (STATS && ln == 0 && stats != nullptr) {
    const long long c1 = clock64();
    L.st[S_EXTENT] = L.E;
    L.st[S_CY_WRITE] = c1 - c0;
    L.st[S_CY_ALL] = c1 - t_all;
    long long* out = stats + (size_t)b * kStats;
#pragma unroll
    for (int i = 0; i < kStats; ++i) out[i] = L.st[i];
  }
}

template <bool STATS>
int launch(int* signed_, int* ol, int* orr, const int* rank, int* n,
           int* next_order, const int* ops, const int* active, int* flags,
           long long* stats, int T, int S, int B, int CAP, int OCAP,
           int LMAX, int lanes, int smem, cudaStream_t stream) {
  auto kern = flat_replay_kernel<STATS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(B + lanes - 1) / lanes, 32 * lanes, smem, stream>>>(
      signed_, (uint32_t*)ol, (uint32_t*)orr, (const uint32_t*)rank, n,
      (uint32_t*)next_order, (const uint32_t*)ops, active, flags, stats, T,
      S, B, CAP, OCAP, LMAX);
  return (int)cudaGetLastError();
}

}  // namespace

// lanes: warps (lanes) a thread block, 1, 2 or 4; smem: bytes of the
// block's shared layout; both from the Python wrapper
// (ops/flat.py::launch_geometry, which refuses a shape whose shared memory
// does not fit). stats may be null: the main build.
extern "C" int flat_replay_launch(int* signed_, int* ol, int* orr,
                                  const int* rank, int* n, int* next_order,
                                  const int* ops, const int* active,
                                  int* flags, long long* stats, int T, int S,
                                  int B, int CAP, int OCAP, int LMAX,
                                  int lanes, int smem, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (lanes != 1 && lanes != 2 && lanes != 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return stats != nullptr
             ? launch<true>(signed_, ol, orr, rank, n, next_order, ops,
                            active, flags, stats, T, S, B, CAP, OCAP, LMAX,
                            lanes, smem, st)
             : launch<false>(signed_, ol, orr, rank, n, next_order, ops,
                             active, flags, stats, T, S, B, CAP, OCAP, LMAX,
                             lanes, smem, st);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
