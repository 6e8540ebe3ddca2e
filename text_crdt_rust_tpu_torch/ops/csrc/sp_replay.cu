// S1: SpDoc's step program for Hopper (sm_90a), one rank's shard of one
// huge document sharded over the mesh's sp axis.
//
// Replaces the XLA program text_crdt_rust_tpu/parallel/sp_apply.py builds
// in make_sp_apply (:90-499; a jax.jit of a shard_map whose body is a
// lax.scan over the steps, :454-489, with a lax.while_loop YATA scan,
// :342-402, and the collectives XLA emits inside it): no pallas_call, but
// one device program a stream, whose loop PyTorch could only run as some
// 200 small operations a step and a host read an iteration. It computes
// what that program computes, bit for bit. The plain PyTorch version is
// text_crdt_rust_tpu_torch/parallel/sp_apply.py::_Shard, the same step cut
// at its collectives into segments; sp_apply.drive runs them in order. The
// two are held against each other on the card.
//
// What it computes. The state of one rank: run planes ordp/lenp [R]
// (+-(order+1), length; packed, `rows` in use), the by-order tables
// oll/orl/rkl [OTS] of orders [sidx*OTS, (sidx+1)*OTS), and op columns
// cols [9][S] (sp_apply.OP_FIELDS). Each step runs, as its kind and lengths
// ask, local delete, local insert, remote delete and remote insert (the
// YATA integrate loop, then the splice), then the table upkeep and the
// step's log entries ols/ors. Arithmetic wraps as int32 (every add goes
// through uint32); a read index is clamped as JAX reads a traced index; a
// delete that the capacity check blocks is a clean no-op. Error bits
// (sp_apply.ERR_*) collect in the state; the caller ORs them over the
// group.
//
// Two modes, one code path (the segment functions below):
// - whole stream (n_items < 0), at sp = 1: the device driver at the end of
//   this file walks the steps as sp_apply.drive does. The collectives of a
//   one-rank group are the identity, so a segment reads its own send words
//   as the collective's result, and the YATA loop's predicate never leaves
//   the card. One launch a stream.
// - items (n_items >= 0), at sp > 1: up to 4 (segment, step) pairs, the
//   shard-local work between two collectives. The state (struct `st`,
//   ST_* words) is loaded from device memory at the start and stored at
//   the end; `recv` is the last collective's result ([sp][k] for a
//   gather, [k] for a sum), the send words are the next one's input.
//
// Mapping. One thread block of kThreads (256) threads on one SM: one
// document's chain is serial, so the design shortens the step, it does
// not spread it. The planes stay in device memory (at config sp's
// whole-trace plan 2 x 38,416 x 4 B = 307 KB, past a block's 227 KB of
// shared memory; they live in the 50 MB L2). Rows past an extent E =
// max(ext, rows + 2) are zero (`ext` is the nonzero extent found at the
// start and grown by every shift), so rows [0, E) are all a step reads.
//
// - The tile index. For each 32-row tile of [0, E), in device-memory
//   scratch the wrapper allocates from R: the wrapping sum of the live
//   lengths, of the raw lengths, and the count of rows that are not sane
//   (0: every length of the tile lies in [0, 2^26), so both sums are exact
//   and below 2^31), one int array each. It is built at the first segment
//   of every launch that reads rows, in one coalesced pass (at sp > 1 the
//   host may reshard between launches), and every write keeps it: flips,
//   splits, splices and shifts rewrite the entries of the tiles they touch
//   in the same pass.
// - Totals (LD_TOTAL, LI_HEAD, RI_TOTAL) are a reduction over the index,
//   made once a launch and then kept in shared memory: every write adds
//   its change with shared atomics (a shift's: the few rows it duplicates,
//   pushes off or touches).
// - Locates. Where every tile of [0, E) is sane and the shard's total
//   (plus a local delete's carry and span end) stays below 2^31, the
//   prefixes are exact and nondecreasing, so the plain version's row-level
//   counts and clips equal a search: one block scan of the index finds the
//   tile that holds the answer, and that tile's warp finds the row. A
//   local delete's covered count is then the overlap of two intervals, its
//   two boundary rows come from one scan, and the rows between them are
//   wholly covered (flipped in one pass). Elsewhere the segment takes the
//   full pass: each tile's exact wrapping prefix from a scan of the index,
//   then every row counted and clipped as the plain version does.
// - Passes are coalesced: warp w of a wave reads one 32-row tile, loads of
//   several tiles are issued before any is used, scans are warp shuffles
//   plus the index scan. The remote delete's order clip and the YATA loop's
//   order -> row search (first hit: the first nonzero row whose run holds
//   the order, else row 0) read rows [0, E) in waves of kThreads * kHitK
//   rows, the search stopping at the first wave with a hit.
// - Shifts. Rows [q, E) move up by 1 or 2: each lane moves an aligned quad
//   of rows (int4 loads and stores; the wrapper pads the planes to whole
//   quads) and takes the two rows before it from the lane before, in waves
//   of 128-row spans from the top, each wave's reads before its writes;
//   the <= 3 rows a splice or a split writes take their values in the same
//   pass, and every tile written gets its index entry anew.
// - At sp = 1 each step's op is read a step ahead into shared memory; no
//   segment opens with a barrier (see the segments' note). Every device
//   function is inlined: a call that is not keeps the context, the op and
//   a shift's touched rows in local memory (a 208 B stack frame, ~20 % of
//   the whole trace's time on the card).
//
// What bounds it. Bytes are few (the planes in and out once, the op
// columns once); the floor is the serial chain. At config sp's shapes a
// local step is two L2 round trips of locate and one shift, whose bytes
// (its rows read and written, ~31 KB each way on average over the whole
// trace) one block of 256 threads moves at ~40 B a cycle reading then
// writing the same rows (chip_blocked_timing.py l2; a 1,024-thread block,
// more bytes in flight, reaches ~87): the shift is about half of a step.
// At sp > 1 the host's collectives between segments bound it. The STATS
// build (the same source, a template argument) counts full passes,
// locates, moves and the rows they move, and clock64 cycles by phase
// (sp_kernel.SP_STAT_NAMES); its outputs equal the main build's.

#include <cuda_runtime.h>
#include <stdint.h>

// Threads a block: 256, measured once on config sp's whole trace against
// 512 and 1,024 (PERF.md, PR 20): the fastest, and the one with no spills
// (512 spills at the 128 registers a thread it may have). The define lets
// a CPU rehearsal against a mock runtime run fewer threads a block.
#ifndef SP_THREADS
#define SP_THREADS 256
#endif

namespace {

constexpr int kThreads = SP_THREADS;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0 && kThreads >= 32 && kThreads <= 1024,
              "a block of whole warps");
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoHit = 0x7FFFFFFF;
constexpr long long kIntMax = 0x7FFFFFFF;
constexpr int kRoot = -1;         // ROOT_ORDER's u32 bits as int32
constexpr int kTabUnknown = -2;   // by-order table: entry not yet known
constexpr int kErrCapacity = 1, kErrBadDelete = 2, kErrNoOwner = 4,
              kErrOrderMiss = 8;
constexpr int kKindLocal = 0, kKindRemoteIns = 1, kKindRemoteDel = 2;
constexpr int kMaxItems = 4;
constexpr int kSaneLen = 1 << 26;  // a sane tile's lengths lie in [0, 2^26)
constexpr int kPassK = 4;   // tiles a warp loads at once in a pass
constexpr int kMoveK = 4;   // 128-row spans a warp holds in a shift's wave
constexpr int kHitK = 4;    // rows a thread reads at once in a row scan

// Op columns, in sp_apply.OP_FIELDS order.
enum { C_KIND, C_POS, C_DLEN, C_DTGT, C_OL, C_OR, C_RANK, C_ILEN, C_IOS };

// Segment codes (sp_kernel.SEG_*).
enum Seg {
  SEG_INIT = 0,
  SEG_LD_TOTAL, SEG_LD_COVER, SEG_LD_SPLIT,
  SEG_LI_HEAD, SEG_LI_SPLICE, SEG_LI_END,
  SEG_RD_COVER, SEG_RD_SPLIT,
  SEG_RI_TOTAL, SEG_RI_LEFT, SEG_RI_START, SEG_RI_RUN, SEG_RI_TABS,
  SEG_RI_OLEFT, SEG_RI_NEXT, SEG_RI_SPLICE, SEG_RI_END,
  SEG_FINISH
};

// State words (sp_kernel.ST_*): the working state kept across segments.
enum {
  ST_ROWS = 0, ST_ERR, ST_EXT, ST_MORE,
  ST_CARRY, ST_TOTAL, ST_N,
  ST_LEFTC, ST_CURSOR, ST_SCAN_START, ST_SCANNING, ST_DONE,
  ST_OWNER, ST_CAPBAD,
  ST_OR, ST_LR, ST_OFF, ST_OTHER_ORDER, ST_OTHER_RIGHT, ST_OTHER_RANK,
  ST_PEND_O, ST_PEND_NEED,
  ST_SEND = 28,
  kStateWords = 32
};

// Counters of the STATS build, in sp_kernel.SP_STAT_NAMES order: segments
// run, full passes taken, index locates, shifts and the rows they moved,
// index builds, E at the end of the launch; then clock64 cycles in the
// index build and the extent scan, totals, locates, delete covers, flips
// and splits' bookkeeping, shifts (with their index entries), the YATA
// search, the table upkeep, the rest, and in all.
enum {
  X_SEGMENTS = 0, X_FALLBACKS, X_LOCATES, X_MOVES, X_MOVED_ROWS, X_BUILDS,
  X_EXTENT,
  X_CY_INDEX, X_CY_TOTALS, X_CY_LOCATE, X_CY_DELETE, X_CY_SHIFT,
  X_CY_YATA, X_CY_TABLES, X_CY_OTHER, X_CY_ALL,
  kStats
};

struct Items {
  int n;
  int code[kMaxItems];
  int step[kMaxItems];
};

struct Ctx {
  int* ordp;
  int* lenp;
  int* oll;
  int* orl;
  int* rkl;
  const int* cols;
  int* ols;
  int* ors;
  // The tile index, four int arrays of NTp = ceil(R / 32) rounded up to 4
  // entries: the live sums, the raw sums, the counts of rows that are not
  // sane (length outside [0, 2^26); 0: the tile is sane) and the full
  // pass's prefix scratch.
  int* idx_live;
  int* idx_raw;
  int* idx_bad;
  int* idx_pre;
  long long* stats;   // kStats counters (STATS build), else null
  int R, OTS, S, sidx, nsp, tab_base;
};

struct Op {
  int kd, p, d, t, ol, orr, rk, il, st;
};

// A row found through the index: its exclusive prefix, its run and the
// order of row min(row + 1, R - 1).
struct Hit {
  int row, excl, o, l, onext;
};

struct Shared {
  unsigned long long ra[kWarps], rb[kWarps];  // reduction scratch
  int rc[kWarps], rd[kWarps], re[kWarps];
  int st[kStateWords];                        // the state, uniform
  int bc[8];                                  // a delete's two clips
  Hit hit[2];                                 // locate results
  Op op[2];                                   // steps' ops (whole mode)
  int edge[2][kWarps * kMoveK + 1][4];        // a shift's quad tails
  unsigned long long sum_live, sum_raw;       // the index's totals and
  int sum_insane, sum_ok;                     // insane rows, if sum_ok
  int idx_ok;                                 // the index is built
  int row0;                                   // ordp[0], while idx_ok
  long long x[kStats];                        // STATS counters
  long long t0;                               // STATS: last tick
};

// ---- int32 arithmetic that wraps, as the JAX package's --------------------

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int sub32(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int neg32(int a) { return (int)(0u - (uint32_t)a); }
__device__ __forceinline__ int abs32(int a) { return a < 0 ? neg32(a) : a; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// ---- warp- and block-wide reductions and scans ----------------------------
// Every thread gets the result. The leading barrier frees the scratch from
// the previous reduction.

__device__ __forceinline__ uint32_t warp_incl(uint32_t v) {
  const int lane = lane_id();
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

__device__ __forceinline__ int block_sum(uint32_t v, Shared& sm) {
  v = __reduce_add_sync(kFull, v);
  __syncthreads();
  if (lane_id() == 0) sm.rc[warp_id()] = (int)v;
  __syncthreads();
  uint32_t t = 0;
  for (int i = 0; i < kWarps; ++i) t += (uint32_t)sm.rc[i];
  return (int)t;
}

__device__ __forceinline__ int block_min(int v, Shared& sm) {
  v = __reduce_min_sync(kFull, v);
  __syncthreads();
  if (lane_id() == 0) sm.rc[warp_id()] = v;
  __syncthreads();
  int t = sm.rc[0];
  for (int i = 1; i < kWarps; ++i) t = min(t, sm.rc[i]);
  return t;
}

__device__ __forceinline__ int block_max(int v, Shared& sm) {
  v = __reduce_max_sync(kFull, v);
  __syncthreads();
  if (lane_id() == 0) sm.rc[warp_id()] = v;
  __syncthreads();
  int t = sm.rc[0];
  for (int i = 1; i < kWarps; ++i) t = max(t, sm.rc[i]);
  return t;
}

// A sum, a min and a max in one reduction.
__device__ __forceinline__ void block_3(uint32_t& s, int& mn, int& mx,
                                        Shared& sm) {
  s = __reduce_add_sync(kFull, s);
  mn = __reduce_min_sync(kFull, mn);
  mx = __reduce_max_sync(kFull, mx);
  __syncthreads();
  if (lane_id() == 0) {
    sm.rc[warp_id()] = (int)s;
    sm.rd[warp_id()] = mn;
    sm.re[warp_id()] = mx;
  }
  __syncthreads();
  s = 0;
  mn = sm.rd[0];
  mx = sm.re[0];
  for (int i = 0; i < kWarps; ++i) {
    s += (uint32_t)sm.rc[i];
    mn = min(mn, sm.rd[i]);
    mx = max(mx, sm.re[i]);
  }
}

// Exclusive scan of one value a thread (wrapping); `total` the block's sum.
__device__ __forceinline__ uint32_t block_excl_scan(uint32_t v,
                                                    uint32_t& total,
                                                    Shared& sm) {
  const int warp = warp_id();
  const uint32_t x = warp_incl(v);
  __syncthreads();
  if (lane_id() == 31) sm.rc[warp] = (int)x;
  __syncthreads();
  uint32_t base = 0, all = 0;
  for (int i = 0; i < kWarps; ++i) {
    if (i == warp) base = all;
    all += (uint32_t)sm.rc[i];
  }
  total = all;
  return base + x - v;
}

// ---- rows and the tile index ----------------------------------------------

// The rows a pass touches: [0, E), E = max(ext, rows + 2) within [1, R].
__device__ __forceinline__ int extent(int ext, int rows, int R) {
  long long e = (long long)rows + 2;
  if (e < ext) e = ext;
  if (e > R) e = R;
  return e < 1 ? 1 : (int)e;
}

__device__ __forceinline__ int tiles(int E) { return (E + 31) >> 5; }

// Tile t's entry from its 32 rows, one a lane (0 past R). Whole warp.
__device__ __forceinline__ bool insane(int l) {
  return l < 0 || l >= kSaneLen;
}

__device__ __forceinline__ void tile_entry(const Ctx& c, int t, int o, int l) {
  const uint32_t live = __reduce_add_sync(kFull, (uint32_t)(o > 0 ? l : 0));
  const uint32_t raw = __reduce_add_sync(kFull, (uint32_t)l);
  const uint32_t bad = __reduce_add_sync(kFull, insane(l) ? 1u : 0u);
  if (lane_id() == 0) {
    c.idx_live[t] = (int)live;
    c.idx_raw[t] = (int)raw;
    c.idx_bad[t] = (int)bad;
  }
}

// The clip of the live span [p, pe) against a run of live length lv whose
// first live character has position b.
__device__ __forceinline__ void live_clip(int p, int pe, int b, int lv,
                                          int& cs, int& ce) {
  cs = min(max(sub32(p, b), 0), lv);
  ce = min(max(sub32(pe, b), 0), lv);
}

// The clip of the order interval [t, t + d) against run (o, ln).
__device__ __forceinline__ void order_clip(const Op& op, int o, int ln,
                                           int& cs, int& ce) {
  const int so = sub32(abs32(o), 1);
  cs = min(max(sub32(op.t, so), 0), ln);
  ce = min(max(sub32(add32(op.t, op.d), so), 0), ln);
}

// The index's totals: wrapping sums (exact where every tile is sane).
struct Summary {
  unsigned long long live, raw;
  bool sane;
};

// A delete's partial rows: how many, the first and the last, with their
// clips (cs, ce, o, ln).
struct Cut {
  int n, i1, i2;
  int a[4], b[4];
};

// Per-lane record of the first and last partial rows of a full pass.
struct Partials {
  int n = 0, first = kNoHit, last = -1;
  int f[4] = {0, 0, 0, 0}, l[4] = {0, 0, 0, 0};

  __device__ __forceinline__ void add(int j, int cs, int ce, int o, int ln) {
    ++n;
    if (first == kNoHit) {
      first = j;
      f[0] = cs; f[1] = ce; f[2] = o; f[3] = ln;
    }
    last = j;
    l[0] = cs; l[1] = ce; l[2] = o; l[3] = ln;
  }

  // Block-wide: (count, first row or R, last row or -1) and the two rows'
  // clips.
  __device__ __forceinline__ Cut reduce(Shared& sm, int R) {
    uint32_t s = (uint32_t)n;
    int mn = first, mx = last;
    block_3(s, mn, mx, sm);
    if (first != kNoHit && first == mn)
      for (int k = 0; k < 4; ++k) sm.bc[k] = f[k];
    if (last >= 0 && last == mx)
      for (int k = 0; k < 4; ++k) sm.bc[4 + k] = l[k];
    __syncthreads();
    Cut cut;
    cut.n = (int)s;
    cut.i1 = mn == kNoHit ? R : mn;
    cut.i2 = mx;
    for (int k = 0; k < 4; ++k) {
      cut.a[k] = sm.bc[k];
      cut.b[k] = sm.bc[4 + k];
    }
    __syncthreads();
    return cut;
  }
};

// Up to three rows a splice or a split writes (after its shift), each in
// a fixed slot (row -1: none) so that the slots stay in registers.
struct Touch {
  int row[3] = {-1, -1, -1}, o[3] = {0, 0, 0}, l[3] = {0, 0, 0};
  bool wo[3] = {false, false, false};

  __device__ __forceinline__ void set(int k, int r, bool with_o, int ov,
                                      int lv) {
    row[k] = r;
    wo[k] = with_o;
    o[k] = ov;
    l[k] = lv;
  }

  // Row j's values after the touches.
  __device__ __forceinline__ bool apply(int j, int& ov, int& lv) const {
    bool hit = false;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (j == row[k]) {
        if (wo[k]) ov = o[k];
        lv = l[k];
        hit = true;
      }
    return hit;
  }
};

// A shift's change of the index totals involves few rows: the move
// duplicates the kept rows K = [q, min(q + amt, top)) and pushes the rows
// D = [max(q, top - amt), top) off the moved range, and each touch
// replaces the moved value B of its row. Their old values, slot by slot:
// K's two rows, D's two rows, each touched row's B (row -1: none).
struct Few {
  int row[7], o[7], l[7];

  __device__ __forceinline__ void load(const Ctx& c, int q, int amt, int top,
                                       const Touch& tc) {
    row[0] = amt >= 1 && q < top ? q : -1;
    row[1] = amt == 2 && q + 1 < top ? q + 1 : -1;
    row[2] = amt >= 1 && top - 1 >= q ? top - 1 : -1;
    row[3] = amt == 2 && top - 2 >= q ? top - 2 : -1;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int t = tc.row[k];
      row[4 + k] = t < 0 ? -1
                         : (amt > 0 && t >= q + amt && t < top ? t - amt : t);
    }
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      o[k] = row[k] >= 0 ? c.ordp[row[k]] : 0;
      l[k] = row[k] >= 0 ? c.lenp[row[k]] : 0;
    }
  }
};

// ---- by-order tables ------------------------------------------------------

// This shard's term of tab[o]: 0 off its order range.
__device__ __forceinline__ int tab_local(const Ctx& c, const int* tab, int o) {
  const bool mine = o >= c.tab_base && (long long)o < (long long)c.tab_base +
                                                          c.OTS;
  return mine ? tab[clampi(sub32(o, c.tab_base), 0, c.OTS - 1)] : 0;
}

__device__ __forceinline__ Op load_op(const Ctx& c, int s) {
  const int* k = c.cols + s;
  Op op;
  op.kd = k[C_KIND * c.S];
  op.p = k[C_POS * c.S];
  op.d = k[C_DLEN * c.S];
  op.t = k[C_DTGT * c.S];
  op.ol = k[C_OL * c.S];
  op.orr = k[C_OR * c.S];
  op.rk = k[C_RANK * c.S];
  op.il = k[C_ILEN * c.S];
  op.st = k[C_IOS * c.S];
  return op;
}

// The second half of the replicated raw cursor: the cursor (0 for ROOT)
// from the summed terms.
__device__ __forceinline__ int cursor_done(const int* recv, int o, bool need,
                                           int& err) {
  const bool is_root = o == kRoot;
  if (need && !is_root && recv[1] == 0) err |= kErrOrderMiss;
  return is_root ? 0 : add32(recv[0], 1);
}

// The segments and what they share; STATS compiles the counters in.
template <bool STATS>
struct K {
  static __device__ __forceinline__ void tick(Shared& sm, int what) {
    if (STATS && threadIdx.x == 0) {
      const long long t = clock64();
      sm.x[what] += t - sm.t0;
      sm.t0 = t;
    }
  }

  static __device__ __forceinline__ void count(Shared& sm, int what,
                                               long long n) {
    if (STATS && threadIdx.x == 0) sm.x[what] += n;
  }

  // ---- the index ----------------------------------------------------------

  static __device__ __forceinline__ void build(const Ctx& c, Shared& sm,
                                               int NTE) {
    tick(sm, X_CY_OTHER);
    const int lane = lane_id();
    for (int t0 = warp_id(); t0 < NTE; t0 += kWarps * kPassK) {
      int o[kPassK], l[kPassK];
#pragma unroll
      for (int k = 0; k < kPassK; ++k) {
        const int t = t0 + k * kWarps, j = t * 32 + lane;
        const bool in = t < NTE && j < c.R;
        o[k] = in ? c.ordp[j] : 0;
        l[k] = in ? c.lenp[j] : 0;
      }
#pragma unroll
      for (int k = 0; k < kPassK; ++k)
        if (t0 + k * kWarps < NTE) tile_entry(c, t0 + k * kWarps, o[k], l[k]);
      if (t0 == 0 && lane == 0) sm.row0 = o[0];
    }
    __syncthreads();
    count(sm, X_BUILDS, 1);
    tick(sm, X_CY_INDEX);
  }

  // The index over [0, E), built once a launch, at the first segment that
  // reads rows (after SEG_INIT has found the extent).
  static __device__ __forceinline__ void prep(const Ctx& c, Shared& sm,
                                              int E) {
    if (sm.idx_ok) return;
    build(c, sm, tiles(E));
    if (threadIdx.x == 0) sm.idx_ok = 1;
  }

  // The index's totals over tiles [0, NTE), kept until the next write.
  static __device__ __forceinline__ Summary summarize(const Ctx& c, Shared& sm,
                                                      int NTE) {
    Summary s;
    if (sm.sum_ok) {
      s.live = sm.sum_live;
      s.raw = sm.sum_raw;
      s.sane = sm.sum_insane == 0;
      return s;
    }
    tick(sm, X_CY_OTHER);
    unsigned long long a = 0, b = 0;
    uint32_t bad = 0;
    for (int t = threadIdx.x; t < NTE; t += kThreads) {
      a += (uint32_t)c.idx_live[t];
      b += (uint32_t)c.idx_raw[t];
      bad += (uint32_t)c.idx_bad[t];
    }
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(kFull, a, o);
      b += __shfl_xor_sync(kFull, b, o);
    }
    bad = __reduce_add_sync(kFull, bad);
    __syncthreads();
    if (lane_id() == 0) {
      sm.ra[warp_id()] = a;
      sm.rb[warp_id()] = b;
      sm.rc[warp_id()] = (int)bad;
    }
    __syncthreads();
    s.live = s.raw = 0;
    int insane = 0;
    for (int i = 0; i < kWarps; ++i) {
      s.live += sm.ra[i];
      s.raw += sm.rb[i];
      insane += sm.rc[i];
    }
    s.sane = insane == 0;
    if (threadIdx.x == 0) {
      sm.sum_live = s.live;
      sm.sum_raw = s.raw;
      sm.sum_insane = insane;
      sm.sum_ok = 1;
    }
    tick(sm, X_CY_TOTALS);
    return s;
  }

  // Each tile's exclusive wrapping prefix of the live (or raw) sums into
  // idx_pre[t], t < NTE: the full pass's row prefixes.
  static __device__ __forceinline__ void scan_index(const Ctx& c, Shared& sm,
                                                    int NTE, bool live) {
    uint32_t carry = 0;
    for (int t0 = 0; t0 < NTE; t0 += kThreads) {
      const int t = t0 + threadIdx.x;
      uint32_t v = 0;
      if (t < NTE) v = (uint32_t)(live ? c.idx_live[t] : c.idx_raw[t]);
      uint32_t tot;
      const uint32_t ex = block_excl_scan(v, tot, sm);
      if (t < NTE) c.idx_pre[t] = (int)(carry + ex);
      carry += tot;
    }
    __syncthreads();
  }

  // A pass over the rows of tiles [tlo, thi), warp w a tile at a time,
  // kPassK tiles' loads issued together. f(j, o, l, before) sees each row
  // (0 past R) with `before`, its exclusive wrapping prefix of the live
  // (mode 1) or raw (mode 2) lengths (scan_index first), and returns the
  // row's new order; a tile whose orders change gets its live sum anew.
  template <class F>
  static __device__ __forceinline__ void row_pass(const Ctx& c, Shared& sm,
                                                  int tlo, int thi, int mode,
                                                  F&& f) {
    const int lane = lane_id();
    const bool keep = sm.sum_ok;
    unsigned long long dl = 0;
    for (int t0 = tlo + warp_id(); t0 < thi; t0 += kWarps * kPassK) {
      int o[kPassK], l[kPassK], pre[kPassK];
#pragma unroll
      for (int k = 0; k < kPassK; ++k) {
        const int t = t0 + k * kWarps, j = t * 32 + lane;
        const bool in = t < thi && j < c.R;
        o[k] = in ? c.ordp[j] : 0;
        l[k] = in ? c.lenp[j] : 0;
        pre[k] = (mode && t < thi) ? c.idx_pre[t] : 0;
      }
#pragma unroll
      for (int k = 0; k < kPassK; ++k) {
        const int t = t0 + k * kWarps;
        if (t >= thi) break;
        const int j = t * 32 + lane;
        uint32_t before = 0;
        if (mode) {
          const uint32_t v =
              (uint32_t)(mode == 2 ? l[k] : (o[k] > 0 ? l[k] : 0));
          before = (uint32_t)pre[k] + warp_incl(v) - v;
        }
        const int no = f(j, o[k], l[k], (int)before);
        const bool changed = j < c.R && no != o[k];
        if (changed) c.ordp[j] = no;
        if (__any_sync(kFull, changed)) {
          const uint32_t live =
              __reduce_add_sync(kFull, (uint32_t)(no > 0 ? l[k] : 0));
          const uint32_t was =
              __reduce_add_sync(kFull, (uint32_t)(o[k] > 0 ? l[k] : 0));
          if (lane == 0) c.idx_live[t] = (int)live;
          if (j == 0 && changed) sm.row0 = no;
          dl += (unsigned long long)live - was;
        }
      }
    }
    // The kept live total follows the flips (raw sums do not change).
    if (keep && lane == 0 && dl != 0) atomicAdd(&sm.sum_live, dl);
  }

  static __device__ __forceinline__ bool reach(long long v, long long X,
                                               bool strict) {
    return strict ? v > X : v >= X;
  }

  // Warp: tile t holds the first row whose exact inclusive prefix reaches
  // X (>= X, or > X when strict); `pre` is the tile's exclusive prefix.
  static __device__ __forceinline__ void tile_hit(const Ctx& c, Shared& sm,
                                                  int t, long long pre,
                                                  bool live, int X,
                                                  bool strict, int q) {
    const int lane = lane_id(), j = t * 32 + lane;
    int o = 0, l = 0, onx = 0;
    if (j < c.R) {
      o = c.ordp[j];
      l = c.lenp[j];
    }
    if (lane == 31 && j + 1 < c.R) onx = c.ordp[j + 1];
    const uint32_t v = (uint32_t)(live ? (o > 0 ? l : 0) : l);
    const uint32_t x = warp_incl(v);
    const unsigned m = __ballot_sync(kFull, reach(pre + x, X, strict));
    const int nxt = __shfl_down_sync(kFull, o, 1);
    if (lane == __ffs(m) - 1) {
      Hit h;
      h.row = j;
      h.excl = (int)(pre + x - v);
      h.o = o;
      h.l = l;
      h.onext = j + 1 < c.R ? (lane == 31 ? onx : nxt) : o;
      sm.hit[q] = h;
    }
  }

  // The first row of [0, E) whose inclusive prefix of the live (or raw)
  // lengths reaches X[q] (>= X[q], or > X[q] when strict[q]), for nq <= 2
  // queries at once; row kNoHit where none does. Only where every tile of
  // [0, E) is sane and the shard's total is at most INT_MAX: the prefixes
  // are then exact and nondecreasing, so the tile whose end first reaches
  // X holds the answer. One block scan of the index a wave of kThreads
  // tiles, stopping once every query is reached; the warp whose lanes hold
  // that tile finds the row.
  static __device__ __forceinline__ void locate(const Ctx& c, Shared& sm,
                                                int NTE, bool live, int nq,
                                                const int* X,
                                                const bool* strict, Hit* out) {
    tick(sm, X_CY_OTHER);
    count(sm, X_LOCATES, nq);
    const int* sums = live ? c.idx_live : c.idx_raw;
    long long carry = 0;
    for (int t0 = 0; t0 < NTE; t0 += kThreads) {
      const int t = t0 + threadIdx.x;
      const uint32_t v = t < NTE ? (uint32_t)sums[t] : 0;
      uint32_t tot;
      const long long pre = carry + block_excl_scan(v, tot, sm);
      const long long end = pre + v;
      for (int q = 0; q < nq; ++q) {
        const bool cross = t < NTE && reach(end, X[q], strict[q]) &&
                           (t == 0 || !reach(pre, X[q], strict[q]));
        const unsigned m = __ballot_sync(kFull, cross);
        if (m) {
          const int src = __ffs(m) - 1;
          tile_hit(c, sm, __shfl_sync(kFull, t, src),
                   __shfl_sync(kFull, pre, src), live, X[q], strict[q], q);
        }
      }
      carry += tot;
      bool all = true;
      for (int q = 0; q < nq; ++q) all = all && reach(carry, X[q], strict[q]);
      if (all) break;
    }
    __syncthreads();
    // sm.hit is next written after the next locate's scan barriers.
    for (int q = 0; q < nq; ++q) {
      out[q] = sm.hit[q];
      if (!reach(carry, X[q], strict[q])) out[q].row = kNoHit;
    }
    tick(sm, X_CY_LOCATE);
  }

  // Row i (< R): its exclusive wrapping prefix of the live (or raw) lengths
  // from the index and its tile, its run and the next row's order.
  static __device__ __forceinline__ Hit row_at(const Ctx& c, Shared& sm, int i,
                                               bool live) {
    tick(sm, X_CY_OTHER);
    const int ti = i >> 5;
    uint32_t s = 0;
    for (int t = threadIdx.x; t < ti; t += kThreads)
      s += (uint32_t)(live ? c.idx_live[t] : c.idx_raw[t]);
    if (warp_id() == 0) {
      const int j = ti * 32 + lane_id();
      if (j < i) {
        const int o = c.ordp[j], l = c.lenp[j];
        s += (uint32_t)(live ? (o > 0 ? l : 0) : l);
      }
    }
    Hit h;
    h.row = i;
    h.o = c.ordp[i];
    h.l = c.lenp[i];
    h.onext = c.ordp[min(i + 1, c.R - 1)];
    h.excl = block_sum(s, sm);
    tick(sm, X_CY_LOCATE);
    return h;
  }

  // Row min(#{j < rows : incl_j < X (<= X when strict)}, R - 1), with
  // incl_j the inclusive wrapping prefix of the live (or raw) lengths: the
  // plain version's row-level count. `fast` (every tile sane, the total at
  // most INT_MAX): a locate; else the full pass counts every row.
  static __device__ __forceinline__ Hit find_rank(const Ctx& c, Shared& sm,
                                                  int NTE, int rows, int X,
                                                  bool live, bool strict,
                                                  bool fast) {
    const int rows_c = min(max(rows, 0), c.R);
    int cnt;
    if (fast) {
      Hit h;
      locate(c, sm, NTE, live, 1, &X, &strict, &h);
      cnt = min(rows_c, h.row == kNoHit ? c.R : h.row);
      if (min(cnt, c.R - 1) == h.row) return h;
    } else {
      count(sm, X_FALLBACKS, 1);
      tick(sm, X_CY_OTHER);
      scan_index(c, sm, NTE, live);
      uint32_t n = 0;
      row_pass(c, sm, 0, NTE, live ? 1 : 2, [&](int j, int o, int l, int b) {
        const int incl = add32(b, live ? (o > 0 ? l : 0) : l);
        if (j < rows && (strict ? incl <= X : incl < X)) ++n;
        return o;
      });
      cnt = block_sum(n, sm);
      tick(sm, X_CY_LOCATE);
    }
    return row_at(c, sm, min(cnt, c.R - 1), live);
  }

  // ---- writes -------------------------------------------------------------

  // Rows [q, E) move up by amt (0, 1 or 2); rows pushed to R and past are
  // dropped (the plane's circular roll, whose wrapped rows the splice
  // always overwrites) and rows [q, q + amt) keep their old values; then
  // the touched rows take theirs. Lane l of a warp's 128-row span holds
  // the aligned quad of rows [4u, 4u + 4), u = 32 span + l (int4 loads
  // and stores; the wrapper pads the planes to whole quads); the two rows
  // before a quad come from the lane before, or through shared memory
  // from the span below. Waves of kWarps * kMoveK spans from the top, each
  // wave's reads before its writes. Every tile of the written spans gets
  // its entry anew (eight lanes a tile); the kept totals change only by
  // the rows the move duplicates or pushes off and the touched rows.
  static __device__ __forceinline__ void write_rows(const Ctx& c, Shared& sm,
                                                    int q, int amt, int E,
                                                    const Touch& tc) {
    constexpr int W = kWarps * kMoveK;  // spans a wave
    tick(sm, X_CY_OTHER);
    const int top = amt > 0 ? min(c.R, E + amt) : 0;  // rows moved: < top
    int lo = amt > 0 ? q : c.R, hi = top;
    for (int k = 0; k < 3; ++k)
      if (tc.row[k] >= 0) {
        lo = min(lo, tc.row[k]);
        hi = max(hi, tc.row[k] + 1);
      }
    if (lo >= hi) return;  // uniform
    if (amt > 0) {
      count(sm, X_MOVES, 1);
      count(sm, X_MOVED_ROWS, max(0, top - (q + amt)));
    }
    const bool keep = sm.sum_ok;
    const int nt_all = tiles(c.R), lane = lane_id();
    const int slo = lo >> 7;
    const int4 zero = make_int4(0, 0, 0, 0);
    const int4* o4 = reinterpret_cast<const int4*>(c.ordp);
    const int4* l4 = reinterpret_cast<const int4*>(c.lenp);
    // Thread 0 reads, before any write, the old rows the kept totals'
    // change involves.
    Few few;
    if (keep && threadIdx.x == 0) few.load(c, q, amt, top, tc);
    int wave = 0;
    for (int s1 = (hi - 1) >> 7; s1 >= slo; s1 -= W, wave ^= 1) {
      const int s0 = max(slo, s1 - W + 1);  // the wave's lowest span
      // Parity buffers: a warp that runs a wave ahead writes the other.
      int(*edge)[4] = sm.edge[wave];
      int4 o[kMoveK], l[kMoveK];
#pragma unroll
      for (int k = 0; k < kMoveK; ++k) {
        const int span = s1 - warp_id() - k * kWarps, u = span * 32 + lane;
        const bool in = span >= s0 && 4 * u < c.R;
        o[k] = in ? o4[u] : zero;
        l[k] = in ? l4[u] : zero;
      }
      // Only once every load is in flight: a store of a loaded value
      // waits for its load.
#pragma unroll
      for (int k = 0; k < kMoveK; ++k) {
        const int span = s1 - warp_id() - k * kWarps;
        if (lane == 31 && span >= s0) {
          int* e = edge[s1 - span];
          e[0] = o[k].z;
          e[1] = o[k].w;
          e[2] = l[k].z;
          e[3] = l[k].w;
        }
      }
      if (threadIdx.x == 0) {
        // The two rows below the wave (the next wave's, not yet written).
        const int r = s0 * 128;
        int* e = edge[W];
        e[0] = r >= 2 ? c.ordp[r - 2] : 0;
        e[1] = r >= 1 ? c.ordp[r - 1] : 0;
        e[2] = r >= 2 ? c.lenp[r - 2] : 0;
        e[3] = r >= 1 ? c.lenp[r - 1] : 0;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kMoveK; ++k) {
        const int span = s1 - warp_id() - k * kWarps, u = span * 32 + lane;
        if (span < s0) break;
        // The previous quad's last two rows.
        int pz = __shfl_up_sync(kFull, o[k].z, 1);
        int pw = __shfl_up_sync(kFull, o[k].w, 1);
        int qz = __shfl_up_sync(kFull, l[k].z, 1);
        int qw = __shfl_up_sync(kFull, l[k].w, 1);
        if (lane == 0) {
          const int* e = edge[span > s0 ? s1 - span + 1 : W];
          pz = e[0];
          pw = e[1];
          qz = e[2];
          qw = e[3];
        }
        const int vo[4] = {o[k].x, o[k].y, o[k].z, o[k].w};
        const int vl[4] = {l[k].x, l[k].y, l[k].z, l[k].w};
        int no[4], nl[4];
        uint32_t live = 0, raw = 0, bad = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * u + e;
          const bool moved = j >= q + amt && j < top;
          // Row j - 1 and row j - 2 of the old plane.
          const int o1 = e >= 1 ? vo[e - 1] : pw, l1 = e >= 1 ? vl[e - 1] : qw;
          const int o2 = e >= 2 ? vo[e - 2] : (e == 1 ? pw : pz);
          const int l2 = e >= 2 ? vl[e - 2] : (e == 1 ? qw : qz);
          no[e] = !moved ? vo[e] : (amt == 1 ? o1 : o2);
          nl[e] = !moved ? vl[e] : (amt == 1 ? l1 : l2);
          tc.apply(j, no[e], nl[e]);
          live += (uint32_t)(no[e] > 0 ? nl[e] : 0);
          raw += (uint32_t)nl[e];
          bad += insane(nl[e]) ? 1u : 0u;
        }
        if (4 * u < c.R && 4 * u + 3 >= lo && 4 * u < hi) {
          reinterpret_cast<int4*>(c.ordp)[u] =
              make_int4(no[0], no[1], no[2], no[3]);
          reinterpret_cast<int4*>(c.lenp)[u] =
              make_int4(nl[0], nl[1], nl[2], nl[3]);
          if (u == 0) sm.row0 = no[0];
        }
        // Eight lanes a tile.
        for (int m = 1; m < 8; m <<= 1) {
          live += __shfl_xor_sync(kFull, live, m);
          raw += __shfl_xor_sync(kFull, raw, m);
          bad += __shfl_xor_sync(kFull, bad, m);
        }
        const int t = u >> 3;
        if ((lane & 7) == 0 && t < nt_all) {
          c.idx_live[t] = (int)live;
          c.idx_raw[t] = (int)raw;
          c.idx_bad[t] = (int)bad;
        }
      }
    }
    if (keep && threadIdx.x == 0) keep_totals(sm, q, amt, top, tc, few);
    __syncthreads();
    tick(sm, X_CY_SHIFT);
  }

  // Thread 0: the kept totals' change by a shift (Few's rows).
  static __device__ __forceinline__ void keep_totals(Shared& sm, int q,
                                                     int amt, int top,
                                                     const Touch& tc,
                                                     const Few& f) {
    unsigned long long dl = 0, dr = 0;
    int dbad = 0;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      if (f.row[k] < 0) continue;
      // +1: a duplicated kept row or a touch's new value; -1: a pushed-off
      // row or a touch's replaced value.
      const int sg = k < 2 ? 1 : -1;
      dl += (unsigned long long)(long long)sg *
            (uint32_t)(f.o[k] > 0 ? f.l[k] : 0);
      dr += (unsigned long long)(long long)sg * (uint32_t)f.l[k];
      dbad += sg * (insane(f.l[k]) ? 1 : 0);
      if (k >= 4) {
        const int t = k - 4;
        const int no = tc.wo[t] ? tc.o[t] : f.o[k], nl = tc.l[t];
        dl += (uint32_t)(no > 0 ? nl : 0);
        dr += (uint32_t)nl;
        dbad += insane(nl) ? 1 : 0;
      }
    }
    sm.sum_live += dl;
    sm.sum_raw += dr;
    sm.sum_insane += dbad;
  }

  // One boundary split of a delete (sp_apply._Shard.apply_partial) at row
  // ip, whose run (o, ln) the delete clips to [cs, ce). Uniform; returns
  // amt.
  static __device__ __forceinline__ int apply_partial(const Ctx& c, Shared& sm,
                                                      bool act, int ip, int cs,
                                                      int ce, int o, int ln,
                                                      int rows, int& ext) {
    if (!act) return 0;
    const bool head = cs > 0, tail = ce < ln;
    const int amt = (int)head + (int)tail;
    const int cov = sub32(ce, cs);
    const int E = extent(ext, rows, c.R);
    Touch tc;
    tc.set(0, ip, true, head ? o : neg32(add32(o, cs)), head ? cs : cov);
    if (amt >= 1 && ip + 1 < c.R)
      tc.set(1, ip + 1, true, head ? neg32(add32(o, cs)) : add32(o, ce),
             head ? cov : sub32(ln, ce));
    if (amt == 2 && ip + 2 < c.R)
      tc.set(2, ip + 2, true, add32(o, ce), sub32(ln, ce));
    write_rows(c, sm, ip + 1, amt, E, tc);
    if (amt > 0) ext = min(c.R, E + amt);
    return amt;
  }

  // The shared tail of both deletes (sp_apply._Shard.clip_and_split): the
  // later partial row first.
  static __device__ __forceinline__ void split_partials(const Ctx& c,
                                                        Shared& sm, bool act,
                                                        const Cut& k,
                                                        int& rows, int& ext) {
    const int a2 = apply_partial(c, sm, act && k.n >= 1, k.i2, k.b[0],
                                 k.b[1], k.b[2], k.b[3], rows, ext);
    const int a1 = apply_partial(c, sm, act && k.n == 2, k.i1, k.a[0],
                                 k.a[1], k.a[2], k.a[3], rows, ext);
    if (act) rows = add32(rows, a1 + a2);
  }

  // The insert splice of both inserts (sp_apply._Shard.splice). Uniform.
  static __device__ __forceinline__ void splice(const Ctx& c, Shared& sm,
                                                bool active, bool is_split,
                                                bool mrg, int i_r, int ins_at,
                                                int l_r, int off, int tail_o,
                                                int il, int st, int& rows,
                                                int& ext) {
    const int amt = (!active || mrg) ? 0 : (is_split ? 2 : 1);
    if (active) {
      const int E = extent(ext, rows, c.R);
      Touch tc;
      if (is_split) tc.set(0, i_r, false, 0, off);
      if (!mrg && ins_at < c.R) tc.set(1, ins_at, true, add32(st, 1), il);
      if (is_split && ins_at + 1 < c.R)
        tc.set(2, ins_at + 1, true, tail_o, sub32(l_r, off));
      if (mrg) tc.set(0, i_r, false, 0, add32(l_r, il));
      write_rows(c, sm, ins_at, amt, E, tc);
      if (amt > 0) ext = min(c.R, E + amt);
    }
    rows = add32(rows, amt);
  }

  // Table upkeep and step s's log entries: the insert run [st, st + il)
  // records its origin chain, right origin and rank on its range owner.
  static __device__ __forceinline__ void upkeep(const Ctx& c, Shared& sm,
                                                const Op& op, int s, bool on,
                                                int head_ol, int run_or) {
    tick(sm, X_CY_OTHER);
    if (on) {
      long long a = (long long)op.st - c.tab_base;
      long long b = (long long)op.st + op.il - c.tab_base;
      if (a < 0) a = 0;
      if (b > c.OTS) b = c.OTS;
      for (long long j = a + threadIdx.x; j < b; j += kThreads) {
        const int g = c.tab_base + (int)j;
        c.oll[j] = g == op.st ? head_ol : g - 1;
        c.orl[j] = run_or;
        c.rkl[j] = op.rk;
      }
    }
    if (threadIdx.x == 0) {
      c.ols[s] = head_ol;
      c.ors[s] = run_or;
    }
    tick(sm, X_CY_TABLES);
  }

  // ---- the segments -------------------------------------------------------
  // Each reads the state and `recv` (the last segment's closing barrier
  // made them visible), works, and leaves its state and send words (thread
  // 0) behind a closing barrier. No segment opens with a barrier: where
  // thread 0 writes a word that other threads read in the same segment,
  // either a barrier of the work lies between, or only thread 0's copy of
  // what it computes from that word is used.

  static __device__ __forceinline__ void seg_init(const Ctx& c, Shared& sm,
                                                  const int* rows_in) {
    tick(sm, X_CY_OTHER);
    int hi = 0;
    for (int j0 = 0; j0 < c.R; j0 += kThreads * kHitK) {
      int o[kHitK], l[kHitK];
#pragma unroll
      for (int k = 0; k < kHitK; ++k) {
        const int j = j0 + k * kThreads + threadIdx.x;
        o[k] = j < c.R ? c.ordp[j] : 0;
        l[k] = j < c.R ? c.lenp[j] : 0;
      }
#pragma unroll
      for (int k = 0; k < kHitK; ++k)
        if (o[k] != 0 || l[k] != 0) hi = j0 + k * kThreads + threadIdx.x + 1;
    }
    hi = block_max(hi, sm);
    if (threadIdx.x == 0) {
      for (int k = 0; k < kStateWords; ++k) sm.st[k] = 0;
      sm.st[ST_ROWS] = rows_in[0];
      sm.st[ST_EXT] = hi;
    }
    __syncthreads();
    tick(sm, X_CY_INDEX);
  }

  // The fast path of a local delete's span: every tile sane, and the
  // carry, the positions and the shard's end in [0, INT_MAX].
  static __device__ __forceinline__ bool fast_span(const Summary& s, int carry,
                                                   const Op& op) {
    return s.sane && carry >= 0 && op.p >= 0 && op.d > 0 &&
           (long long)op.p + op.d <= kIntMax &&
           (long long)carry + (long long)s.live <= kIntMax;
  }

  // Local delete, 1: this shard's live total.
  static __device__ __forceinline__ void seg_ld_total(const Ctx& c,
                                                      Shared& sm) {
    const int E = extent(sm.st[ST_EXT], sm.st[ST_ROWS], c.R);
    prep(c, sm, E);
    const Summary s = summarize(c, sm, tiles(E));
    if (threadIdx.x == 0) sm.st[ST_SEND] = (int)(uint32_t)s.live;
    __syncthreads();
  }

  // Local delete, 2: the carry from the gathered totals; the covered count.
  static __device__ __forceinline__ void seg_ld_cover(const Ctx& c, Shared& sm,
                                                      const int* recv,
                                                      const Op& op) {
    uint32_t carry = 0;
    for (int k = 0; k < c.sidx; ++k) carry += (uint32_t)recv[k];
    const int E = extent(sm.st[ST_EXT], sm.st[ST_ROWS], c.R);
    prep(c, sm, E);
    const int NTE = tiles(E);
    const Summary s = summarize(c, sm, NTE);
    const int pe = add32(op.p, op.d);
    int cov;
    if (fast_span(s, (int)carry, op)) {
      // The rows' spans tile [carry, carry + total): the overlap with
      // [p, pe) is the sum of the clips.
      const long long lo = max((long long)op.p, (long long)(int)carry);
      const long long hi = min((long long)op.p + op.d,
                               (long long)(int)carry + (long long)s.live);
      cov = hi > lo ? (int)(hi - lo) : 0;
    } else {
      count(sm, X_FALLBACKS, 1);
      tick(sm, X_CY_OTHER);
      scan_index(c, sm, NTE, true);
      uint32_t covered = 0;
      row_pass(c, sm, 0, NTE, 1, [&](int j, int o, int l, int b) {
        int cs, ce;
        live_clip(op.p, pe, add32((int)carry, b), o > 0 ? l : 0, cs, ce);
        covered += (uint32_t)sub32(ce, cs);
        return o;
      });
      cov = block_sum(covered, sm);
      tick(sm, X_CY_DELETE);
    }
    if (threadIdx.x == 0) {
      sm.st[ST_CARRY] = (int)carry;
      sm.st[ST_SEND] = cov;
    }
    __syncthreads();
  }

  // The clip of live span [p, pe) against a located row.
  static __device__ __forceinline__ void hit_clip(const Op& op, int pe,
                                                  int carry, const Hit& h,
                                                  int* cl, bool& full,
                                                  bool& part) {
    int cs, ce;
    live_clip(op.p, pe, add32(carry, h.excl), h.o > 0 ? h.l : 0, cs, ce);
    const int cov = sub32(ce, cs);
    full = cov > 0 && cov == h.l;
    part = cov > 0 && !full;
    cl[0] = cs;
    cl[1] = ce;
    cl[2] = h.o;
    cl[3] = h.l;
  }

  // Local delete, 3: the bad-delete flag, full-cover flips and the splits.
  static __device__ __forceinline__ void seg_ld_split(const Ctx& c, Shared& sm,
                                                      const int* recv,
                                                      const Op& op) {
    const int covered = recv[0];
    const int carry = sm.st[ST_CARRY];
    int rows = sm.st[ST_ROWS], ext = sm.st[ST_EXT], err = sm.st[ST_ERR];
    if (covered < op.d) err |= kErrBadDelete;
    const bool cap_bad = (long long)rows + 2 > c.R, act = !cap_bad;
    const int E = extent(ext, rows, c.R), NTE = tiles(E);
    prep(c, sm, E);
    const Summary s = summarize(c, sm, NTE);
    const int pe = add32(op.p, op.d);
    Cut cut;
    cut.n = 0;
    cut.i1 = c.R;
    cut.i2 = -1;
    if (fast_span(s, carry, op)) {
      // The rows with cov > 0 run from ja, the first whose end passes p,
      // to ke, the first whose end reaches pe (E - 1 if none does); the
      // live rows strictly between are wholly covered.
      const int X[2] = {sub32(op.p, carry), sub32(pe, carry)};
      const bool strict[2] = {true, false};
      Hit h[2];
      locate(c, sm, NTE, true, 2, X, strict, h);
      const int ja = h[0].row, ke = h[1].row;
      if (ja != kNoHit) {
        int ca[4], cb[4];
        bool full_a, part_a, full_e = false, part_e = false;
        hit_clip(op, pe, carry, h[0], ca, full_a, part_a);
        if (ke != kNoHit && ke != ja)
          hit_clip(op, pe, carry, h[1], cb, full_e, part_e);
        const int kx = ke == kNoHit ? E : ke;
        if (act && (full_a || full_e || kx > ja + 1)) {
          tick(sm, X_CY_OTHER);
          const int hi = ke == kNoHit ? E : ke + 1;
          row_pass(c, sm, ja >> 5, tiles(hi), 0,
                   [&](int j, int o, int l, int) {
            const bool full = j == ja ? full_a
                              : j == ke ? full_e
                                        : (j > ja && j < kx && o > 0 && l > 0);
            return full ? neg32(o) : o;
          });
          __syncthreads();
          tick(sm, X_CY_DELETE);
        }
        if (part_a) {
          cut.n = 1;
          cut.i1 = cut.i2 = ja;
          for (int k = 0; k < 4; ++k) cut.a[k] = cut.b[k] = ca[k];
        }
        if (part_e) {
          cut.i2 = ke;
          for (int k = 0; k < 4; ++k) cut.b[k] = cb[k];
          if (cut.n == 0) {
            cut.i1 = ke;
            for (int k = 0; k < 4; ++k) cut.a[k] = cb[k];
          }
          ++cut.n;
        }
      }
    } else {
      count(sm, X_FALLBACKS, 1);
      tick(sm, X_CY_OTHER);
      scan_index(c, sm, NTE, true);
      Partials part;
      row_pass(c, sm, 0, NTE, 1, [&](int j, int o, int ln, int b) {
        int cs, ce;
        live_clip(op.p, pe, add32(carry, b), o > 0 ? ln : 0, cs, ce);
        const int cov = sub32(ce, cs);
        const bool full = cov > 0 && cov == ln;
        if (cov > 0 && !full) part.add(j, cs, ce, o, ln);
        return (full && act) ? neg32(o) : o;
      });
      cut = part.reduce(sm, c.R);
      tick(sm, X_CY_DELETE);
    }
    if (cut.n > 0 && cap_bad) err |= kErrCapacity;
    split_partials(c, sm, act, cut, rows, ext);
    if (threadIdx.x == 0) {
      sm.st[ST_ROWS] = rows;
      sm.st[ST_EXT] = ext;
      sm.st[ST_ERR] = err;
    }
    __syncthreads();
  }

  // Local insert, 1: this shard's live total and head row.
  static __device__ __forceinline__ void seg_li_head(const Ctx& c,
                                                     Shared& sm) {
    const int rows = sm.st[ST_ROWS];
    const int E = extent(sm.st[ST_EXT], rows, c.R);
    prep(c, sm, E);
    const Summary s = summarize(c, sm, tiles(E));
    if (threadIdx.x == 0) {
      sm.st[ST_SEND] = (int)(uint32_t)s.live;
      sm.st[ST_SEND + 1] = rows > 0 ? sm.row0 : 0;
    }
    __syncthreads();
  }

  // Local insert, 2: the owner shard of live rank p splices; (owner, left
  // origin, right origin, active) for the sum.
  static __device__ __forceinline__ void seg_li_splice(const Ctx& c,
                                                       Shared& sm,
                                                       const int* recv,
                                                       const Op& op) {
    uint32_t carry = 0;
    int nxt_head = 0, first_head = 0;
    bool got_next = false, got_first = false;
    for (int k = 0; k < c.nsp; ++k) {
      const int h = recv[2 * k + 1];
      if (k < c.sidx) carry += (uint32_t)recv[2 * k];
      if (h != 0 && !got_first) { first_head = h; got_first = true; }
      if (h != 0 && k > c.sidx && !got_next) { nxt_head = h; got_next = true; }
    }
    const int total = recv[2 * c.sidx];
    int rows = sm.st[ST_ROWS], ext = sm.st[ST_EXT];
    const int p = op.p;
    const bool owner =
        p == 0 ? c.sidx == 0
               : ((int)carry < p && p <= add32((int)carry, total));
    const bool cap_bad = (long long)rows + 2 > c.R;
    const bool active = owner && !cap_bad;
    const int local_rank = sub32(p, (int)carry);

    const int E = extent(ext, rows, c.R), NTE = tiles(E);
    prep(c, sm, E);
    const Summary s = summarize(c, sm, NTE);
    const Hit h = find_rank(c, sm, NTE, rows, local_rank, true, false,
                            s.sane && s.live <= (unsigned long long)kIntMax);
    const int i_r = h.row, o_r = h.o, l_r = h.l;
    const int off = sub32(local_rank, h.excl);

    const bool mrg = p > 0 && off == l_r && add32(op.st, 1) == add32(o_r, l_r);
    const bool is_split = p > 0 && off < l_r;
    const int left = p == 0 ? kRoot : add32(sub32(o_r, 1), sub32(off, 1));
    const int nxt_in_rows = i_r + 1 < rows ? h.onext : nxt_head;
    const int succ =
        p == 0 ? first_head : (is_split ? add32(o_r, off) : nxt_in_rows);
    const int right = succ == 0 ? kRoot : sub32(abs32(succ), 1);
    const int ins_at = p == 0 ? 0 : i_r + 1;
    splice(c, sm, active, is_split, mrg, i_r, ins_at, l_r, off,
           add32(o_r, off), op.il, op.st, rows, ext);
    if (threadIdx.x == 0) {
      sm.st[ST_ROWS] = rows;
      sm.st[ST_EXT] = ext;
      sm.st[ST_OWNER] = owner;
      sm.st[ST_CAPBAD] = cap_bad;
      sm.st[ST_SEND] = owner;
      sm.st[ST_SEND + 1] = active ? left : 0;
      sm.st[ST_SEND + 2] = active ? right : 0;
      sm.st[ST_SEND + 3] = active;
    }
    __syncthreads();
  }

  // Local insert, 3: the flags, the discovered origins into the tables.
  static __device__ __forceinline__ void seg_li_end(const Ctx& c, Shared& sm,
                                                    const int* recv,
                                                    const Op& op, int s) {
    const int r0 = recv[0], r1 = recv[1], r2 = recv[2], r3 = recv[3];
    int err = sm.st[ST_ERR];
    const bool owner = sm.st[ST_OWNER], cap_bad = sm.st[ST_CAPBAD];
    if (r0 == 0) err |= kErrNoOwner;
    if (owner && cap_bad) err |= kErrCapacity;
    const bool any = r3 > 0;
    upkeep(c, sm, op, s, any, any ? r1 : 0, any ? r2 : 0);
    if (threadIdx.x == 0) sm.st[ST_ERR] = err;
    __syncthreads();
  }

  // Remote delete, 1: the covered count (dead runs count, unflipped).
  static __device__ __forceinline__ void seg_rd_cover(const Ctx& c, Shared& sm,
                                                      const Op& op) {
    const int E = extent(sm.st[ST_EXT], sm.st[ST_ROWS], c.R);
    tick(sm, X_CY_OTHER);
    uint32_t covered = 0;
    row_pass(c, sm, 0, tiles(E), 0, [&](int, int o, int l, int) {
      int cs, ce;
      order_clip(op, o, l, cs, ce);
      if (o != 0) covered += (uint32_t)sub32(ce, cs);
      return o;
    });
    const int cov = block_sum(covered, sm);
    if (threadIdx.x == 0) sm.st[ST_SEND] = cov;
    __syncthreads();
    tick(sm, X_CY_DELETE);
  }

  // Remote delete, 2: the flag, flips of live covered runs, the splits.
  static __device__ __forceinline__ void seg_rd_split(const Ctx& c, Shared& sm,
                                                      const int* recv,
                                                      const Op& op) {
    const int covered = recv[0];
    int rows = sm.st[ST_ROWS], ext = sm.st[ST_EXT], err = sm.st[ST_ERR];
    if (covered < op.d) err |= kErrBadDelete;
    const bool cap_bad = (long long)rows + 2 > c.R, act = !cap_bad;
    const int E = extent(ext, rows, c.R);
    prep(c, sm, E);
    tick(sm, X_CY_OTHER);
    Partials part;
    row_pass(c, sm, 0, tiles(E), 0, [&](int j, int o, int ln, int) {
      int cs, ce;
      order_clip(op, o, ln, cs, ce);
      const int cov = o != 0 ? sub32(ce, cs) : 0;
      const bool hit = o > 0 && cov > 0;
      if (hit && cov != ln) part.add(j, cs, ce, o, ln);
      return (hit && cov == ln && act) ? neg32(o) : o;
    });
    const Cut cut = part.reduce(sm, c.R);
    tick(sm, X_CY_DELETE);
    if (cut.n > 0 && cap_bad) err |= kErrCapacity;
    split_partials(c, sm, act, cut, rows, ext);
    if (threadIdx.x == 0) {
      sm.st[ST_ROWS] = rows;
      sm.st[ST_EXT] = ext;
      sm.st[ST_ERR] = err;
    }
    __syncthreads();
  }

  // Remote insert, 1: this shard's raw total.
  static __device__ __forceinline__ void seg_ri_total(const Ctx& c,
                                                      Shared& sm) {
    const int E = extent(sm.st[ST_EXT], sm.st[ST_ROWS], c.R);
    prep(c, sm, E);
    const Summary s = summarize(c, sm, tiles(E));
    if (threadIdx.x == 0) {
      sm.st[ST_TOTAL] = (int)(uint32_t)s.raw;
      sm.st[ST_SEND] = (int)(uint32_t)s.raw;
    }
    __syncthreads();
  }

  // The first row of [0, E) that is nonzero and whose order run holds oc,
  // kNoHit if none: waves of kThreads * kHitK rows, stopping at the first
  // wave with a hit.
  static __device__ __forceinline__ int first_hit(const Ctx& c, Shared& sm,
                                                  int E, int oc) {
    for (int j0 = 0; j0 < E; j0 += kThreads * kHitK) {
      int o[kHitK], l[kHitK];
#pragma unroll
      for (int k = 0; k < kHitK; ++k) {
        const int j = j0 + k * kThreads + threadIdx.x;
        o[k] = j < E ? c.ordp[j] : 0;
        l[k] = j < E ? c.lenp[j] : 0;
      }
      int first = kNoHit;
#pragma unroll
      for (int k = kHitK - 1; k >= 0; --k) {
        const int so = sub32(abs32(o[k]), 1);
        if (o[k] != 0 && so <= oc && oc < add32(so, l[k]))
          first = j0 + k * kThreads + threadIdx.x;
      }
      first = block_min(first, sm);
      if (first != kNoHit) return first;
    }
    return kNoHit;
  }

  // The first half of the replicated raw cursor after order o: the unknown
  // flag, and this shard's (raw position term, found) for the sum. Called
  // after the segment's opening barrier; carry is the raw carry.
  static __device__ __forceinline__ void cursor_terms(const Ctx& c, Shared& sm,
                                                      int o, bool need,
                                                      int carry, int err) {
    if (need && o == kTabUnknown) err |= kErrOrderMiss;
    const int oc = max(o, 0);
    const int E = extent(sm.st[ST_EXT], sm.st[ST_ROWS], c.R);
    prep(c, sm, E);
    tick(sm, X_CY_OTHER);
    const int first = first_hit(c, sm, E, oc);
    tick(sm, X_CY_YATA);
    const bool found = first != kNoHit;
    const Hit h = row_at(c, sm, found ? first : 0, false);
    const int off = sub32(oc, sub32(abs32(h.o), 1));
    if (threadIdx.x == 0) {
      sm.st[ST_SEND] = found ? add32(add32(carry, h.excl), off) : 0;
      sm.st[ST_SEND + 1] = found;
      sm.st[ST_PEND_O] = o;
      sm.st[ST_PEND_NEED] = need;
      sm.st[ST_ERR] = err;
    }
    __syncthreads();
  }

  // Remote insert, 2: the raw carry and total, then the left origin's terms.
  static __device__ __forceinline__ void seg_ri_left(const Ctx& c, Shared& sm,
                                                     const int* recv,
                                                     const Op& op) {
    uint32_t carry = 0, n = 0;
    for (int k = 0; k < c.nsp; ++k) {
      if (k < c.sidx) carry += (uint32_t)recv[k];
      n += (uint32_t)recv[k];
    }
    const int err = sm.st[ST_ERR];
    if (threadIdx.x == 0) {
      sm.st[ST_CARRY] = (int)carry;
      sm.st[ST_N] = (int)n;
    }
    cursor_terms(c, sm, op.ol, true, (int)carry, err);
  }

  // Remote insert, 3: the scan state from the left origin's cursor.
  static __device__ __forceinline__ void seg_ri_start(Shared& sm,
                                                      const int* recv) {
    const int o = sm.st[ST_PEND_O], n = sm.st[ST_N];
    const bool need = sm.st[ST_PEND_NEED];
    int err = sm.st[ST_ERR];
    const int r0 = recv[0], r1 = recv[1];
    const int rr[2] = {r0, r1};
    const int lc = cursor_done(rr, o, need, err);
    if (threadIdx.x == 0) {
      sm.st[ST_ERR] = err;
      sm.st[ST_LEFTC] = lc;
      sm.st[ST_CURSOR] = lc;
      sm.st[ST_SCAN_START] = lc;
      sm.st[ST_SCANNING] = 0;
      sm.st[ST_DONE] = 0;
      sm.st[ST_MORE] = lc < n;
    }
    __syncthreads();
  }

  // Remote insert, loop 1: the probed run's (order, length, offset) terms
  // from the shard that owns the cursor.
  static __device__ __forceinline__ void seg_ri_run(const Ctx& c, Shared& sm) {
    const int cursor = sm.st[ST_CURSOR], carry = sm.st[ST_CARRY];
    const int total = sm.st[ST_TOTAL], rows = sm.st[ST_ROWS];
    const int E = extent(sm.st[ST_EXT], rows, c.R);
    const bool own = cursor >= carry && cursor < add32(carry, total);
    const int local = sub32(cursor, carry);
    int v0 = 0, v1 = 0, v2 = 0;
    if (own) {
      const int NTE = tiles(E);
      prep(c, sm, E);
      const Summary s = summarize(c, sm, NTE);
      const Hit h = find_rank(c, sm, NTE, rows, local, false, true,
                              s.sane && s.raw <= (unsigned long long)kIntMax);
      v0 = h.o;
      v1 = h.l;
      v2 = sub32(local, h.excl);
    }
    if (threadIdx.x == 0) {
      sm.st[ST_SEND] = v0;
      sm.st[ST_SEND + 1] = v1;
      sm.st[ST_SEND + 2] = v2;
    }
    __syncthreads();
    tick(sm, X_CY_YATA);
  }

  // Remote insert, loop 2: the probed item's order; its table terms.
  static __device__ __forceinline__ void seg_ri_tabs(const Ctx& c, Shared& sm,
                                                     const int* recv) {
    const int o_r = recv[0], l_r = recv[1], off = recv[2];
    const int oo = add32(sub32(abs32(o_r), 1), off);
    if (threadIdx.x == 0) {
      sm.st[ST_OR] = o_r;
      sm.st[ST_LR] = l_r;
      sm.st[ST_OFF] = off;
      sm.st[ST_OTHER_ORDER] = oo;
      sm.st[ST_SEND] = tab_local(c, c.oll, oo);
      sm.st[ST_SEND + 1] = tab_local(c, c.orl, oo);
      sm.st[ST_SEND + 2] = tab_local(c, c.rkl, oo);
    }
    __syncthreads();
    tick(sm, X_CY_YATA);
  }

  // Remote insert, loop 3: the probed item's origins; its left origin's
  // cursor terms.
  static __device__ __forceinline__ void seg_ri_oleft(const Ctx& c, Shared& sm,
                                                      const int* recv) {
    const int other_left = recv[0], other_right = recv[1], rank = recv[2];
    const bool done = sm.st[ST_DONE];
    const int carry = sm.st[ST_CARRY], err = sm.st[ST_ERR];
    if (threadIdx.x == 0) {
      sm.st[ST_OTHER_RIGHT] = other_right;
      sm.st[ST_OTHER_RANK] = rank;
    }
    cursor_terms(c, sm, other_left, !done, carry, err);
  }

  // Remote insert, loop 4: one step of the conflict scan (`doc.rs:183-222`).
  static __device__ __forceinline__ void seg_ri_next(Shared& sm,
                                                     const int* recv,
                                                     const Op& op) {
    const int r0 = recv[0], r1 = recv[1];
    const int o = sm.st[ST_PEND_O];
    const bool need = sm.st[ST_PEND_NEED];
    int err = sm.st[ST_ERR];
    const int lc = sm.st[ST_LEFTC], n = sm.st[ST_N];
    int cursor = sm.st[ST_CURSOR], scan_start = sm.st[ST_SCAN_START];
    bool scanning = sm.st[ST_SCANNING], done = sm.st[ST_DONE];
    const int oo = sm.st[ST_OTHER_ORDER], other_right = sm.st[ST_OTHER_RIGHT];
    const int other_rank = sm.st[ST_OTHER_RANK];
    const int o_r = sm.st[ST_OR], l_r = sm.st[ST_LR], off = sm.st[ST_OFF];
    const int rr[2] = {r0, r1};
    const int olc = cursor_done(rr, o, need, err);
    bool brk = oo == op.orr || olc < lc;
    const bool eq = !brk && olc == lc;
    const bool gt = op.rk > other_rank;
    const bool same_right = op.orr == other_right;
    brk = brk || (eq && !gt && same_right);
    if (eq && !gt && !same_right && !scanning) scan_start = cursor;
    if (eq) scanning = gt ? false : (same_right ? scanning : true);
    const int so = sub32(abs32(o_r), 1);
    const bool contains_right = op.orr > oo && op.orr < add32(so, l_r);
    const int stp = contains_right ? sub32(op.orr, oo) : sub32(l_r, off);
    if (!brk) cursor = add32(cursor, stp);
    done = done || brk;
    if (threadIdx.x == 0) {
      sm.st[ST_ERR] = err;
      sm.st[ST_CURSOR] = cursor;
      sm.st[ST_SCAN_START] = scan_start;
      sm.st[ST_SCANNING] = scanning;
      sm.st[ST_DONE] = done;
      sm.st[ST_MORE] = !done && cursor < n;
    }
    __syncthreads();
    tick(sm, X_CY_YATA);
  }

  // Remote insert, 4: the splice at the scan's raw position on the owner
  // shard (`doc.rs:274-293`); (owner, active) for the sum.
  static __device__ __forceinline__ void seg_ri_splice(const Ctx& c,
                                                       Shared& sm,
                                                       const Op& op) {
    const bool scanning = sm.st[ST_SCANNING];
    const int cpos = scanning ? sm.st[ST_SCAN_START] : sm.st[ST_CURSOR];
    const int carry = sm.st[ST_CARRY], total = sm.st[ST_TOTAL];
    int rows = sm.st[ST_ROWS], ext = sm.st[ST_EXT];
    const bool owner =
        cpos == 0 ? c.sidx == 0
                  : (carry < cpos && cpos <= add32(carry, total));
    const bool cap_bad = (long long)rows + 2 > c.R;
    const bool active = owner && !cap_bad;
    const int local = sub32(cpos, carry);
    const int E = extent(ext, rows, c.R), NTE = tiles(E);
    prep(c, sm, E);
    const Summary s = summarize(c, sm, NTE);
    const Hit h = find_rank(c, sm, NTE, rows, local, false, false,
                            s.sane && s.raw <= (unsigned long long)kIntMax);
    const int i_r = h.row, o_r = h.o, l_r = h.l;
    const int off = sub32(local, h.excl);
    const bool mrg = cpos > 0 && o_r > 0 && off == l_r &&
                     add32(op.st, 1) == add32(o_r, l_r) &&
                     op.ol == sub32(add32(o_r, l_r), 2);
    const bool is_split = cpos > 0 && off < l_r;
    const int ins_at = cpos == 0 ? 0 : i_r + 1;
    const int tail_o = o_r > 0 ? add32(o_r, off) : sub32(o_r, off);
    splice(c, sm, active, is_split, mrg, i_r, ins_at, l_r, off, tail_o,
           op.il, op.st, rows, ext);
    if (threadIdx.x == 0) {
      sm.st[ST_ROWS] = rows;
      sm.st[ST_EXT] = ext;
      sm.st[ST_OWNER] = owner;
      sm.st[ST_CAPBAD] = cap_bad;
      sm.st[ST_SEND] = owner;
      sm.st[ST_SEND + 1] = active;
    }
    __syncthreads();
  }

  // Remote insert, 5: the flags, the given origins into the tables.
  static __device__ __forceinline__ void seg_ri_end(const Ctx& c, Shared& sm,
                                                    const int* recv,
                                                    const Op& op, int s) {
    const int r0 = recv[0], r1 = recv[1];
    int err = sm.st[ST_ERR];
    const bool owner = sm.st[ST_OWNER], cap_bad = sm.st[ST_CAPBAD];
    if (r0 == 0) err |= kErrNoOwner;
    if (owner && cap_bad) err |= kErrCapacity;
    const bool ri = r1 > 0;
    upkeep(c, sm, op, s, ri, ri ? op.ol : 0, ri ? op.orr : 0);
    if (threadIdx.x == 0) sm.st[ST_ERR] = err;
    __syncthreads();
  }

  static __device__ __forceinline__ void seg_finish(Shared& sm) {
    __syncthreads();
    if (threadIdx.x == 0) sm.st[ST_SEND] = sm.st[ST_ERR];
    __syncthreads();
  }

  static __device__ __forceinline__ void run_segment(const Ctx& c, Shared& sm,
                                                     const int* rows_in,
                                                     const int* recv, int code,
                                                     int s, const Op& op) {
    count(sm, X_SEGMENTS, 1);
    switch (code) {
      case SEG_INIT: seg_init(c, sm, rows_in); break;
      case SEG_LD_TOTAL: seg_ld_total(c, sm); break;
      case SEG_LD_COVER: seg_ld_cover(c, sm, recv, op); break;
      case SEG_LD_SPLIT: seg_ld_split(c, sm, recv, op); break;
      case SEG_LI_HEAD: seg_li_head(c, sm); break;
      case SEG_LI_SPLICE: seg_li_splice(c, sm, recv, op); break;
      case SEG_LI_END: seg_li_end(c, sm, recv, op, s); break;
      case SEG_RD_COVER: seg_rd_cover(c, sm, op); break;
      case SEG_RD_SPLIT: seg_rd_split(c, sm, recv, op); break;
      case SEG_RI_TOTAL: seg_ri_total(c, sm); break;
      case SEG_RI_LEFT: seg_ri_left(c, sm, recv, op); break;
      case SEG_RI_START: seg_ri_start(sm, recv); break;
      case SEG_RI_RUN: seg_ri_run(c, sm); break;
      case SEG_RI_TABS: seg_ri_tabs(c, sm, recv); break;
      case SEG_RI_OLEFT: seg_ri_oleft(c, sm, recv); break;
      case SEG_RI_NEXT: seg_ri_next(sm, recv, op); break;
      case SEG_RI_SPLICE: seg_ri_splice(c, sm, op); break;
      case SEG_RI_END: seg_ri_end(c, sm, recv, op, s); break;
      default: seg_finish(sm); break;
    }
  }

  static __device__ __forceinline__ void run(const Ctx& c, Shared& sm,
                                             const int* rows_in, int* st_g,
                                             const int* recv,
                                             const Items& items) {
    const long long t_all = STATS ? clock64() : 0;
    if (threadIdx.x == 0) {
      sm.idx_ok = 0;
      sm.sum_ok = 0;
      if (STATS) {
        for (int k = 0; k < kStats; ++k) sm.x[k] = 0;
        sm.t0 = t_all;
      }
    }
    if (items.n < 0) {
      // The whole stream at sp = 1: sp_apply.drive on the card, each
      // collective the identity (a segment's result is its own send words).
      // Each step's op is read once, a step ahead.
      const int* self = sm.st + ST_SEND;
      const Op none{};
      run_segment(c, sm, rows_in, self, SEG_INIT, 0, none);
      // Thread k < 9 reads field k of the next step's op a step ahead; the
      // step reads its op from shared memory.
      const int f = threadIdx.x;
      if (f < 9 && c.S > 0)
        reinterpret_cast<int*>(&sm.op[0])[f] = c.cols[f * c.S];
      for (int s = 0; s < c.S; ++s) {
        // Buffer s & 1 holds this step's op; the other, last read in step
        // s - 1, takes the next one, whose loads run under this step.
        const int mine = f < 9 && s + 1 < c.S ? c.cols[f * c.S + s + 1] : 0;
        __syncthreads();
        const Op& op = sm.op[s & 1];
        if (op.kd == kKindLocal && op.d > 0) {
          run_segment(c, sm, rows_in, self, SEG_LD_TOTAL, s, op);
          run_segment(c, sm, rows_in, self, SEG_LD_COVER, s, op);
          run_segment(c, sm, rows_in, self, SEG_LD_SPLIT, s, op);
        }
        if (op.kd == kKindLocal && op.il > 0) {
          run_segment(c, sm, rows_in, self, SEG_LI_HEAD, s, op);
          run_segment(c, sm, rows_in, self, SEG_LI_SPLICE, s, op);
          run_segment(c, sm, rows_in, self, SEG_LI_END, s, op);
        }
        if (op.kd == kKindRemoteDel && op.d > 0) {
          run_segment(c, sm, rows_in, self, SEG_RD_COVER, s, op);
          run_segment(c, sm, rows_in, self, SEG_RD_SPLIT, s, op);
        }
        if (op.kd == kKindRemoteIns && op.il > 0) {
          run_segment(c, sm, rows_in, self, SEG_RI_TOTAL, s, op);
          run_segment(c, sm, rows_in, self, SEG_RI_LEFT, s, op);
          run_segment(c, sm, rows_in, self, SEG_RI_START, s, op);
          while (sm.st[ST_MORE]) {
            run_segment(c, sm, rows_in, self, SEG_RI_RUN, s, op);
            run_segment(c, sm, rows_in, self, SEG_RI_TABS, s, op);
            run_segment(c, sm, rows_in, self, SEG_RI_OLEFT, s, op);
            run_segment(c, sm, rows_in, self, SEG_RI_NEXT, s, op);
          }
          run_segment(c, sm, rows_in, self, SEG_RI_SPLICE, s, op);
          run_segment(c, sm, rows_in, self, SEG_RI_END, s, op);
        }
        if (f < 9) reinterpret_cast<int*>(&sm.op[(s + 1) & 1])[f] = mine;
      }
      run_segment(c, sm, rows_in, self, SEG_FINISH, c.S, none);
    } else {
      for (int k = threadIdx.x; k < kStateWords; k += kThreads)
        sm.st[k] = st_g[k];
      __syncthreads();
      for (int i = 0; i < items.n; ++i) {
        const int s = items.step[i];
        run_segment(c, sm, rows_in, recv, items.code[i], s,
                    s < c.S ? load_op(c, s) : Op{});
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kStateWords; k += kThreads)
      st_g[k] = sm.st[k];
    if (STATS && threadIdx.x == 0 && c.stats != nullptr) {
      tick(sm, X_CY_OTHER);
      sm.x[X_EXTENT] = extent(sm.st[ST_EXT], sm.st[ST_ROWS], c.R);
      sm.x[X_CY_ALL] = clock64() - t_all;
      for (int k = 0; k < kStats; ++k)
        c.stats[k] = k == X_EXTENT ? sm.x[k] : c.stats[k] + sm.x[k];
    }
  }
};

template <bool STATS>
__global__ void __launch_bounds__(kThreads, 1)
    sp_replay_kernel(Ctx c, const int* rows_in, int* st_g, const int* recv,
                     Items items) {
  __shared__ Shared sm;
  K<STATS>::run(c, sm, rows_in, st_g, recv, items);
}

template <bool STATS>
void launch(const Ctx& c, const int* rows_in, int* st, const int* recv,
            const Items& items, cudaStream_t stream) {
  sp_replay_kernel<STATS><<<1, kThreads, 0, stream>>>(c, rows_in, st, recv,
                                                      items);
}

}  // namespace

// stats: kStats int64 counters (the STATS build; segment counts and cycles
// add up over launches, the extent is the last launch's), or null (the
// main build). index: 4 * NTp ints of scratch, NTp = ceil(R / 32) rounded
// up to a multiple of 4 (sp_kernel.index_words).
extern "C" int sp_replay_launch(int* ordp, int* lenp, int* oll, int* orl,
                                int* rkl, const int* rows_in,
                                const int* cols, int* ols, int* ors,
                                int* st, const int* recv, int* index,
                                long long* stats, int R, int OTS, int S,
                                int nsp, int sidx, int n_items, int c0,
                                int s0, int c1, int s1, int c2, int s2,
                                int c3, int s3, void* stream) {
  Ctx c;
  c.ordp = ordp;
  c.lenp = lenp;
  c.oll = oll;
  c.orl = orl;
  c.rkl = rkl;
  c.cols = cols;
  c.ols = ols;
  c.ors = ors;
  const int ntp = ((R + 31) / 32 + 3) / 4 * 4;
  c.idx_live = index;
  c.idx_raw = index + ntp;
  c.idx_bad = index + 2 * ntp;
  c.idx_pre = index + 3 * ntp;
  c.stats = stats;
  c.R = R;
  c.OTS = OTS;
  c.S = S;
  c.sidx = sidx;
  c.nsp = nsp;
  c.tab_base = sidx * OTS;
  Items items;
  items.n = n_items < kMaxItems ? n_items : kMaxItems;
  const int codes[kMaxItems] = {c0, c1, c2, c3};
  const int steps[kMaxItems] = {s0, s1, s2, s3};
  for (int i = 0; i < kMaxItems; ++i) {
    items.code[i] = codes[i];
    items.step[i] = steps[i];
  }
  if (stats != nullptr)
    launch<true>(c, rows_in, st, recv, items, (cudaStream_t)stream);
  else
    launch<false>(c, rows_in, st, recv, items, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int sp_replay_threads() { return kThreads; }

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
