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
// Mapping. One thread block of kThreads threads. The planes stay in device
// memory (at config sp's whole-trace plan they are 2 x 38,416 x 4 B = 307
// KB, past a block's 227 KB of shared memory; they live in the 50 MB L2).
// Rows past an extent E = max(ext, rows + 2) are zero (`ext` is the
// nonzero extent found at the start and grown by every shift), so each
// pass touches rows [0, E) only; each thread owns E/kThreads consecutive
// rows. Prefix sums are block scans (warp shuffles, one shared pass); a
// count or a first-hit index is a block reduction; the prefix at one row
// is finished by the thread owning it. A splice moves the rows at and
// after its point by 0, 1 or 2 with a barrier between the read of the rows
// that cross a thread's boundary and the writes; one thread then writes
// the <= 3 touched rows. The tables stay in device memory; an insert
// writes only the table entries of its own orders.
//
// What bounds it. Bytes are few (the planes in and out once, the op
// columns once); the floor is the serial chain: each step's passes over
// rows [0, E) with a few block barriers each, and at sp > 1 the host's
// collectives between segments. A simple, correct kernel first: its speed
// is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SP_THREADS
#define SP_THREADS 1024
#endif

namespace {

constexpr int kThreads = SP_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kNoHit = 0x7FFFFFFF;
constexpr int kRoot = -1;         // ROOT_ORDER's u32 bits as int32
constexpr int kTabUnknown = -2;   // by-order table: entry not yet known
constexpr int kErrCapacity = 1, kErrBadDelete = 2, kErrNoOwner = 4,
              kErrOrderMiss = 8;
constexpr int kKindLocal = 0, kKindRemoteIns = 1, kKindRemoteDel = 2;
constexpr int kMaxItems = 4;

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
  int R, OTS, S, sidx, nsp, tab_base;
};

struct Op {
  int kd, p, d, t, ol, orr, rk, il, st;
};

struct Shared {
  int red[kWarps];      // reduction scratch
  int pref[kThreads];   // each thread's exclusive prefix of the last scan
  int st[kStateWords];  // the state, uniform
  int bc[8];            // broadcast scratch
};

// ---- int32 arithmetic that wraps, as the JAX package's ------------------

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

// ---- block-wide reductions and scans --------------------------------------
// Every thread gets the result. The leading barrier frees `red` from the
// previous reduction.

__device__ int block_sum(uint32_t v, Shared& sm) {
  v = __reduce_add_sync(0xffffffffu, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red[threadIdx.x >> 5] = (int)v;
  __syncthreads();
  uint32_t t = 0;
  for (int i = 0; i < kWarps; ++i) t += (uint32_t)sm.red[i];
  return (int)t;
}

__device__ int block_min(int v, Shared& sm) {
  v = __reduce_min_sync(0xffffffffu, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = sm.red[0];
  for (int i = 1; i < kWarps; ++i) t = min(t, sm.red[i]);
  return t;
}

__device__ int block_max(int v, Shared& sm) {
  v = __reduce_max_sync(0xffffffffu, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = sm.red[0];
  for (int i = 1; i < kWarps; ++i) t = max(t, sm.red[i]);
  return t;
}

// Exclusive scan of one value a thread (wrapping); also kept in sm.pref.
__device__ uint32_t block_scan(uint32_t v, Shared& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) sm.red[warp] = (int)x;
  __syncthreads();
  uint32_t base = 0;
  for (int i = 0; i < warp; ++i) base += (uint32_t)sm.red[i];
  base += x - v;
  sm.pref[threadIdx.x] = (int)base;
  return base;
}

// ---- rows -----------------------------------------------------------------

// The rows a pass touches: [0, E), E = max(ext, rows + 2) within [1, R].
__device__ __forceinline__ int extent(int ext, int rows, int R) {
  long long e = (long long)rows + 2;
  if (e < ext) e = ext;
  if (e > R) e = R;
  return e < 1 ? 1 : (int)e;
}

__device__ __forceinline__ int per_thread(int E) {
  return (E + kThreads - 1) / kThreads;
}

__device__ __forceinline__ void chunk(int E, int& lo, int& hi) {
  const int per = per_thread(E);
  lo = min(E, (int)threadIdx.x * per);
  hi = min(E, lo + per);
}

__device__ __forceinline__ int live_len(const Ctx& c, int j) {
  return c.ordp[j] > 0 ? c.lenp[j] : 0;
}

// Exclusive scan of live lengths (live) or raw lengths over each thread's
// rows: returns the thread's base.
__device__ uint32_t scan_rows(const Ctx& c, Shared& sm, int lo, int hi,
                              bool live) {
  uint32_t s = 0;
  for (int j = lo; j < hi; ++j)
    s += (uint32_t)(live ? live_len(c, j) : c.lenp[j]);
  return block_scan(s, sm);
}

// The exclusive prefix at row i < E of the last scan_rows over [0, E),
// finished by the thread that owns row i.
__device__ int prefix_at(const Ctx& c, Shared& sm, int i, int E, bool live) {
  const int per = per_thread(E);
  __syncthreads();
  if ((int)threadIdx.x == i / per) {
    uint32_t acc = (uint32_t)sm.pref[threadIdx.x];
    for (int j = threadIdx.x * per; j < i; ++j)
      acc += (uint32_t)(live ? live_len(c, j) : c.lenp[j]);
    sm.bc[0] = (int)acc;
  }
  __syncthreads();
  const int v = sm.bc[0];
  __syncthreads();
  return v;
}

// Rows [q, E) move up by amt (1 or 2); rows pushed to R and past are
// dropped (the plane's circular roll, whose wrapped rows the splice always
// overwrites). Rows [q, q + amt) keep their old values for the splice to
// write.
__device__ void shift_up(const Ctx& c, int q, int amt, int E) {
  const int E2 = min(c.R, E + amt);
  if (q >= E2) return;  // uniform
  int lo, hi;
  chunk(E2, lo, hi);
  // The sources of this thread's first amt rows lie in the previous
  // thread's rows, which that thread overwrites: read them first.
  int o0 = 0, l0 = 0, o1 = 0, l1 = 0;
  for (int k = 0; k < amt; ++k) {
    const int j = lo + k, src = j - amt;
    if (j < hi && src >= q && src < lo) {
      if (k == 0) { o0 = c.ordp[src]; l0 = c.lenp[src]; }
      else { o1 = c.ordp[src]; l1 = c.lenp[src]; }
    }
  }
  __syncthreads();
  for (int j = hi - 1; j >= lo; --j) {
    const int src = j - amt;
    if (src < q) break;
    int vo, vl;
    if (src >= lo) {
      vo = c.ordp[src];
      vl = c.lenp[src];
    } else if (j - lo == 0) {
      vo = o0;
      vl = l0;
    } else {
      vo = o1;
      vl = l1;
    }
    c.ordp[j] = vo;
    c.lenp[j] = vl;
  }
  __syncthreads();
}

// One boundary split of a delete (sp_apply._Shard.apply_partial) at row ip,
// whose run (o, ln) the delete clips to [cs, ce). Uniform; returns amt.
__device__ int apply_partial(const Ctx& c, bool act, int ip, int cs, int ce,
                             int o, int ln, int rows, int& ext) {
  if (!act) return 0;
  const bool head = cs > 0, tail = ce < ln;
  const int amt = (int)head + (int)tail;
  const int cov = sub32(ce, cs);
  if (amt > 0) {
    const int E = extent(ext, rows, c.R);
    shift_up(c, ip + 1, amt, E);
    ext = min(c.R, E + amt);
  }
  if (threadIdx.x == 0) {
    c.ordp[ip] = head ? o : neg32(add32(o, cs));
    c.lenp[ip] = head ? cs : cov;
    if (amt >= 1 && ip + 1 < c.R) {
      c.ordp[ip + 1] = head ? neg32(add32(o, cs)) : add32(o, ce);
      c.lenp[ip + 1] = head ? cov : sub32(ln, ce);
    }
    if (amt == 2 && ip + 2 < c.R) {
      c.ordp[ip + 2] = add32(o, ce);
      c.lenp[ip + 2] = sub32(ln, ce);
    }
  }
  __syncthreads();
  return amt;
}

// The insert splice of both inserts (sp_apply._Shard.splice). Uniform.
__device__ void splice(const Ctx& c, bool active, bool is_split, bool mrg,
                       int i_r, int ins_at, int o_r, int l_r, int off,
                       int tail_o, int il, int st, int& rows, int& ext) {
  const int amt = (!active || mrg) ? 0 : (is_split ? 2 : 1);
  if (amt > 0) {
    const int E = extent(ext, rows, c.R);
    shift_up(c, ins_at, amt, E);
    ext = min(c.R, E + amt);
  }
  if (threadIdx.x == 0 && active) {
    if (is_split) c.lenp[i_r] = off;
    if (!mrg && ins_at < c.R) {
      c.ordp[ins_at] = add32(st, 1);
      c.lenp[ins_at] = il;
    }
    if (is_split && ins_at + 1 < c.R) {
      c.ordp[ins_at + 1] = tail_o;
      c.lenp[ins_at + 1] = sub32(l_r, off);
    }
    if (mrg) c.lenp[i_r] = add32(l_r, il);
  }
  __syncthreads();
  rows = add32(rows, amt);
}

// The shared tail of both deletes (sp_apply._Shard.clip_and_split): the
// pass found npart partial rows, the first at i1 and the last at i2, with
// their clips in sm.bc; full-cover flips are already done (act only).
__device__ void split_partials(const Ctx& c, Shared& sm, bool act,
                               int npart, int i1, int i2, int& rows,
                               int& ext) {
  const int cs1 = sm.bc[0], ce1 = sm.bc[1], o1 = sm.bc[2], l1 = sm.bc[3];
  const int cs2 = sm.bc[4], ce2 = sm.bc[5], o2 = sm.bc[6], l2 = sm.bc[7];
  __syncthreads();
  const int a2 = apply_partial(c, act && npart >= 1, i2, cs2, ce2, o2, l2,
                               rows, ext);
  const int a1 = apply_partial(c, act && npart == 2, i1, cs1, ce1, o1, l1,
                               rows, ext);
  if (act) rows = add32(rows, a1 + a2);
}

// Per-thread record of the first and last partial rows of a delete pass.
struct Partials {
  int n = 0, first = kNoHit, last = -1;
  int f[4] = {0, 0, 0, 0}, l[4] = {0, 0, 0, 0};

  __device__ void add(int j, int cs, int ce, int o, int ln) {
    ++n;
    if (first == kNoHit) {
      first = j;
      f[0] = cs; f[1] = ce; f[2] = o; f[3] = ln;
    }
    last = j;
    l[0] = cs; l[1] = ce; l[2] = o; l[3] = ln;
  }

  // Block-wide: (count, first row or R, last row or -1), the two rows'
  // clips into sm.bc.
  __device__ void reduce(Shared& sm, int R, int& npart, int& i1, int& i2) {
    npart = block_sum((uint32_t)n, sm);
    i1 = block_min(first, sm);
    i2 = block_max(last, sm);
    if (first != kNoHit && first == i1)
      for (int k = 0; k < 4; ++k) sm.bc[k] = f[k];
    if (last >= 0 && last == i2)
      for (int k = 0; k < 4; ++k) sm.bc[4 + k] = l[k];
    if (i1 == kNoHit) i1 = R;
    __syncthreads();
  }
};

// ---- by-order tables ------------------------------------------------------

// This shard's term of tab[o]: 0 off its order range.
__device__ int tab_local(const Ctx& c, const int* tab, int o) {
  const bool mine = o >= c.tab_base && (long long)o < (long long)c.tab_base +
                                                          c.OTS;
  return mine ? tab[clampi(sub32(o, c.tab_base), 0, c.OTS - 1)] : 0;
}

// Table upkeep and step s's log entries: the insert run [st, st + il)
// records its origin chain, right origin and rank on its range owner.
__device__ void upkeep(const Ctx& c, const Op& op, int s, bool on,
                       int head_ol, int run_or) {
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
}

// ---- the segments -----------------------------------------------------------
// Each reads the state and `recv`, passes a barrier, works, and leaves its
// state and send words (thread 0) behind a closing barrier.

__device__ Op load_op(const Ctx& c, int s) {
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

__device__ void seg_init(const Ctx& c, Shared& sm, const int* rows_in) {
  int hi = 0;
  for (int j = threadIdx.x; j < c.R; j += kThreads)
    if (c.ordp[j] != 0 || c.lenp[j] != 0) hi = j + 1;
  hi = block_max(hi, sm);
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStateWords; ++k) sm.st[k] = 0;
    sm.st[ST_ROWS] = rows_in[0];
    sm.st[ST_EXT] = hi;
  }
  __syncthreads();
}

// Local delete, 1: this shard's live total.
__device__ void seg_ld_total(const Ctx& c, Shared& sm) {
  const int E = extent(sm.st[ST_EXT], sm.st[ST_ROWS], c.R);
  int lo, hi;
  chunk(E, lo, hi);
  uint32_t s = 0;
  for (int j = lo; j < hi; ++j) s += (uint32_t)live_len(c, j);
  const int total = block_sum(s, sm);
  if (threadIdx.x == 0) sm.st[ST_SEND] = total;
  __syncthreads();
}

// Local delete, 2: the carry from the gathered totals; the covered count.
__device__ void seg_ld_cover(const Ctx& c, Shared& sm, const int* recv,
                             const Op& op) {
  uint32_t carry = 0;
  for (int k = 0; k < c.sidx; ++k) carry += (uint32_t)recv[k];
  const int E = extent(sm.st[ST_EXT], sm.st[ST_ROWS], c.R);
  __syncthreads();
  int lo, hi;
  chunk(E, lo, hi);
  uint32_t run = scan_rows(c, sm, lo, hi, true);
  uint32_t covered = 0;
  const int pe = add32(op.p, op.d);
  for (int j = lo; j < hi; ++j) {
    const int lv = live_len(c, j);
    const int before = (int)(carry + run);
    run += (uint32_t)lv;
    const int cs = min(max(sub32(op.p, before), 0), lv);
    const int ce = min(max(sub32(pe, before), 0), lv);
    covered += (uint32_t)sub32(ce, cs);
  }
  const int cov = block_sum(covered, sm);
  if (threadIdx.x == 0) {
    sm.st[ST_CARRY] = (int)carry;
    sm.st[ST_SEND] = cov;
  }
  __syncthreads();
}

// Local delete, 3: the bad-delete flag, full-cover flips and the splits.
__device__ void seg_ld_split(const Ctx& c, Shared& sm, const int* recv,
                             const Op& op) {
  const int covered = recv[0];
  const uint32_t carry = (uint32_t)sm.st[ST_CARRY];
  int rows = sm.st[ST_ROWS], ext = sm.st[ST_EXT], err = sm.st[ST_ERR];
  __syncthreads();
  if (covered < op.d) err |= kErrBadDelete;
  const bool cap_bad = (long long)rows + 2 > c.R, act = !cap_bad;
  const int E = extent(ext, rows, c.R);
  int lo, hi;
  chunk(E, lo, hi);
  uint32_t run = scan_rows(c, sm, lo, hi, true);
  const int pe = add32(op.p, op.d);
  Partials part;
  for (int j = lo; j < hi; ++j) {
    const int o = c.ordp[j], ln = c.lenp[j];
    const int lv = o > 0 ? ln : 0;
    const int before = (int)(carry + run);
    run += (uint32_t)lv;
    const int cs = min(max(sub32(op.p, before), 0), lv);
    const int ce = min(max(sub32(pe, before), 0), lv);
    const int cov = sub32(ce, cs);
    const bool full = cov > 0 && cov == ln;
    if (cov > 0 && !full) part.add(j, cs, ce, o, ln);
    if (full && act) c.ordp[j] = neg32(o);
  }
  int npart, i1, i2;
  part.reduce(sm, c.R, npart, i1, i2);
  if (npart > 0 && cap_bad) err |= kErrCapacity;
  split_partials(c, sm, act, npart, i1, i2, rows, ext);
  if (threadIdx.x == 0) {
    sm.st[ST_ROWS] = rows;
    sm.st[ST_EXT] = ext;
    sm.st[ST_ERR] = err;
  }
  __syncthreads();
}

// Local insert, 1: this shard's live total and head row.
__device__ void seg_li_head(const Ctx& c, Shared& sm) {
  const int rows = sm.st[ST_ROWS];
  const int E = extent(sm.st[ST_EXT], rows, c.R);
  int lo, hi;
  chunk(E, lo, hi);
  uint32_t s = 0;
  for (int j = lo; j < hi; ++j) s += (uint32_t)live_len(c, j);
  const int total = block_sum(s, sm);
  if (threadIdx.x == 0) {
    sm.st[ST_SEND] = total;
    sm.st[ST_SEND + 1] = rows > 0 ? c.ordp[0] : 0;
  }
  __syncthreads();
}

// Local insert, 2: the owner shard of live rank p splices; (owner, left
// origin, right origin, active) for the sum.
__device__ void seg_li_splice(const Ctx& c, Shared& sm, const int* recv,
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
  __syncthreads();
  const int p = op.p;
  const bool owner = p == 0 ? c.sidx == 0
                            : ((int)carry < p && p <= add32((int)carry, total));
  const bool cap_bad = (long long)rows + 2 > c.R;
  const bool active = owner && !cap_bad;
  const int local_rank = sub32(p, (int)carry);

  const int E = extent(ext, rows, c.R);
  int lo, hi;
  chunk(E, lo, hi);
  uint32_t run = scan_rows(c, sm, lo, hi, true);
  uint32_t cnt = 0;
  for (int j = lo; j < hi; ++j) {
    run += (uint32_t)live_len(c, j);
    if ((int)run < local_rank && j < rows) ++cnt;
  }
  const int i_r = min(block_sum(cnt, sm), c.R - 1);
  const int excl = prefix_at(c, sm, i_r, E, true);
  const int o_r = c.ordp[i_r], l_r = c.lenp[i_r];
  const int off = sub32(local_rank, excl);

  const bool mrg = p > 0 && off == l_r && add32(op.st, 1) == add32(o_r, l_r);
  const bool is_split = p > 0 && off < l_r;
  const int left = p == 0 ? kRoot : add32(sub32(o_r, 1), sub32(off, 1));
  const int nxt_in_rows =
      i_r + 1 < rows ? c.ordp[min(i_r + 1, c.R - 1)] : nxt_head;
  const int succ =
      p == 0 ? first_head : (is_split ? add32(o_r, off) : nxt_in_rows);
  const int right = succ == 0 ? kRoot : sub32(abs32(succ), 1);
  const int ins_at = p == 0 ? 0 : i_r + 1;
  __syncthreads();
  splice(c, active, is_split, mrg, i_r, ins_at, o_r, l_r, off,
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
__device__ void seg_li_end(const Ctx& c, Shared& sm, const int* recv,
                           const Op& op, int s) {
  const int r0 = recv[0], r1 = recv[1], r2 = recv[2], r3 = recv[3];
  int err = sm.st[ST_ERR];
  const bool owner = sm.st[ST_OWNER], cap_bad = sm.st[ST_CAPBAD];
  __syncthreads();
  if (r0 == 0) err |= kErrNoOwner;
  if (owner && cap_bad) err |= kErrCapacity;
  const bool any = r3 > 0;
  upkeep(c, op, s, any, any ? r1 : 0, any ? r2 : 0);
  if (threadIdx.x == 0) sm.st[ST_ERR] = err;
  __syncthreads();
}

// The clip of the order interval [t, t + d) against run (o, ln).
__device__ __forceinline__ void order_clip(const Op& op, int o, int ln,
                                           int& cs, int& ce) {
  const int so = sub32(abs32(o), 1);
  cs = min(max(sub32(op.t, so), 0), ln);
  ce = min(max(sub32(add32(op.t, op.d), so), 0), ln);
}

// Remote delete, 1: the covered count (dead runs count, unflipped).
__device__ void seg_rd_cover(const Ctx& c, Shared& sm, const Op& op) {
  const int E = extent(sm.st[ST_EXT], sm.st[ST_ROWS], c.R);
  int lo, hi;
  chunk(E, lo, hi);
  uint32_t covered = 0;
  for (int j = lo; j < hi; ++j) {
    const int o = c.ordp[j];
    int cs, ce;
    order_clip(op, o, c.lenp[j], cs, ce);
    if (o != 0) covered += (uint32_t)sub32(ce, cs);
  }
  const int cov = block_sum(covered, sm);
  if (threadIdx.x == 0) sm.st[ST_SEND] = cov;
  __syncthreads();
}

// Remote delete, 2: the flag, flips of live covered runs, the splits.
__device__ void seg_rd_split(const Ctx& c, Shared& sm, const int* recv,
                             const Op& op) {
  const int covered = recv[0];
  int rows = sm.st[ST_ROWS], ext = sm.st[ST_EXT], err = sm.st[ST_ERR];
  __syncthreads();
  if (covered < op.d) err |= kErrBadDelete;
  const bool cap_bad = (long long)rows + 2 > c.R, act = !cap_bad;
  const int E = extent(ext, rows, c.R);
  int lo, hi;
  chunk(E, lo, hi);
  Partials part;
  for (int j = lo; j < hi; ++j) {
    const int o = c.ordp[j], ln = c.lenp[j];
    int cs, ce;
    order_clip(op, o, ln, cs, ce);
    const int cov = o != 0 ? sub32(ce, cs) : 0;
    const bool hit = o > 0 && cov > 0;
    if (hit && cov != ln) part.add(j, cs, ce, o, ln);
    if (hit && cov == ln && act) c.ordp[j] = neg32(o);
  }
  int npart, i1, i2;
  part.reduce(sm, c.R, npart, i1, i2);
  if (npart > 0 && cap_bad) err |= kErrCapacity;
  split_partials(c, sm, act, npart, i1, i2, rows, ext);
  if (threadIdx.x == 0) {
    sm.st[ST_ROWS] = rows;
    sm.st[ST_EXT] = ext;
    sm.st[ST_ERR] = err;
  }
  __syncthreads();
}

// Remote insert, 1: this shard's raw total.
__device__ void seg_ri_total(const Ctx& c, Shared& sm) {
  const int E = extent(sm.st[ST_EXT], sm.st[ST_ROWS], c.R);
  int lo, hi;
  chunk(E, lo, hi);
  uint32_t s = 0;
  for (int j = lo; j < hi; ++j) s += (uint32_t)c.lenp[j];
  const int total = block_sum(s, sm);
  if (threadIdx.x == 0) {
    sm.st[ST_TOTAL] = total;
    sm.st[ST_SEND] = total;
  }
  __syncthreads();
}

// The first half of the replicated raw cursor after order o: the unknown
// flag, and this shard's (raw position term, found) for the sum. Called
// after the segment's opening barrier; carry is the raw carry.
__device__ void cursor_terms(const Ctx& c, Shared& sm, int o, bool need,
                             int carry, int err) {
  if (need && o == kTabUnknown) err |= kErrOrderMiss;
  const int oc = max(o, 0);
  const int E = extent(sm.st[ST_EXT], sm.st[ST_ROWS], c.R);
  __syncthreads();
  int lo, hi;
  chunk(E, lo, hi);
  scan_rows(c, sm, lo, hi, false);
  int first = kNoHit;
  for (int j = lo; j < hi; ++j) {
    const int oj = c.ordp[j];
    const int so = sub32(abs32(oj), 1);
    if (oj != 0 && so <= oc && oc < add32(so, c.lenp[j])) {
      first = j;
      break;
    }
  }
  first = block_min(first, sm);
  const bool found = first != kNoHit;
  const int row = found ? first : 0;
  const int before = prefix_at(c, sm, row, E, false);
  const int off = sub32(oc, sub32(abs32(c.ordp[row]), 1));
  if (threadIdx.x == 0) {
    sm.st[ST_SEND] = found ? add32(add32(carry, before), off) : 0;
    sm.st[ST_SEND + 1] = found;
    sm.st[ST_PEND_O] = o;
    sm.st[ST_PEND_NEED] = need;
    sm.st[ST_ERR] = err;
  }
  __syncthreads();
}

// The second half: the cursor (0 for ROOT) from the summed terms.
__device__ int cursor_done(const int* recv, int o, bool need, int& err) {
  const bool is_root = o == kRoot;
  if (need && !is_root && recv[1] == 0) err |= kErrOrderMiss;
  return is_root ? 0 : add32(recv[0], 1);
}

// Remote insert, 2: the raw carry and total, then the left origin's terms.
__device__ void seg_ri_left(const Ctx& c, Shared& sm, const int* recv,
                            const Op& op) {
  uint32_t carry = 0, n = 0;
  for (int k = 0; k < c.nsp; ++k) {
    if (k < c.sidx) carry += (uint32_t)recv[k];
    n += (uint32_t)recv[k];
  }
  const int err = sm.st[ST_ERR];
  __syncthreads();
  if (threadIdx.x == 0) {
    sm.st[ST_CARRY] = (int)carry;
    sm.st[ST_N] = (int)n;
  }
  cursor_terms(c, sm, op.ol, true, (int)carry, err);
}

// Remote insert, 3: the scan state from the left origin's cursor.
__device__ void seg_ri_start(Shared& sm, const int* recv) {
  const int o = sm.st[ST_PEND_O], n = sm.st[ST_N];
  const bool need = sm.st[ST_PEND_NEED];
  int err = sm.st[ST_ERR];
  const int r0 = recv[0], r1 = recv[1];
  __syncthreads();
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
__device__ void seg_ri_run(const Ctx& c, Shared& sm) {
  const int cursor = sm.st[ST_CURSOR], carry = sm.st[ST_CARRY];
  const int total = sm.st[ST_TOTAL], rows = sm.st[ST_ROWS];
  const int E = extent(sm.st[ST_EXT], rows, c.R);
  __syncthreads();
  const bool own = cursor >= carry && cursor < add32(carry, total);
  const int local = sub32(cursor, carry);
  int v0 = 0, v1 = 0, v2 = 0;
  if (own) {
    int lo, hi;
    chunk(E, lo, hi);
    uint32_t run = scan_rows(c, sm, lo, hi, false);
    uint32_t cnt = 0;
    for (int j = lo; j < hi; ++j) {
      run += (uint32_t)c.lenp[j];
      if ((int)run <= local && j < rows) ++cnt;
    }
    const int i_r = min(block_sum(cnt, sm), c.R - 1);
    const int excl = prefix_at(c, sm, i_r, E, false);
    v0 = c.ordp[i_r];
    v1 = c.lenp[i_r];
    v2 = sub32(local, excl);
  }
  if (threadIdx.x == 0) {
    sm.st[ST_SEND] = v0;
    sm.st[ST_SEND + 1] = v1;
    sm.st[ST_SEND + 2] = v2;
  }
  __syncthreads();
}

// Remote insert, loop 2: the probed item's order; its table terms.
__device__ void seg_ri_tabs(const Ctx& c, Shared& sm, const int* recv) {
  const int o_r = recv[0], l_r = recv[1], off = recv[2];
  __syncthreads();
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
}

// Remote insert, loop 3: the probed item's origins; its left origin's
// cursor terms.
__device__ void seg_ri_oleft(const Ctx& c, Shared& sm, const int* recv) {
  const int other_left = recv[0], other_right = recv[1], rank = recv[2];
  const bool done = sm.st[ST_DONE];
  const int carry = sm.st[ST_CARRY], err = sm.st[ST_ERR];
  __syncthreads();
  if (threadIdx.x == 0) {
    sm.st[ST_OTHER_RIGHT] = other_right;
    sm.st[ST_OTHER_RANK] = rank;
  }
  cursor_terms(c, sm, other_left, !done, carry, err);
}

// Remote insert, loop 4: one step of the conflict scan (`doc.rs:183-222`).
__device__ void seg_ri_next(Shared& sm, const int* recv, const Op& op) {
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
  __syncthreads();
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
}

// Remote insert, 4: the splice at the scan's raw position on the owner
// shard (`doc.rs:274-293`); (owner, active) for the sum.
__device__ void seg_ri_splice(const Ctx& c, Shared& sm, const Op& op) {
  const bool scanning = sm.st[ST_SCANNING];
  const int cpos = scanning ? sm.st[ST_SCAN_START] : sm.st[ST_CURSOR];
  const int carry = sm.st[ST_CARRY], total = sm.st[ST_TOTAL];
  int rows = sm.st[ST_ROWS], ext = sm.st[ST_EXT];
  __syncthreads();
  const bool owner = cpos == 0 ? c.sidx == 0
                               : (carry < cpos && cpos <= add32(carry, total));
  const bool cap_bad = (long long)rows + 2 > c.R;
  const bool active = owner && !cap_bad;
  const int local = sub32(cpos, carry);
  const int E = extent(ext, rows, c.R);
  int lo, hi;
  chunk(E, lo, hi);
  uint32_t run = scan_rows(c, sm, lo, hi, false);
  uint32_t cnt = 0;
  for (int j = lo; j < hi; ++j) {
    run += (uint32_t)c.lenp[j];
    if ((int)run < local && j < rows) ++cnt;
  }
  const int i_r = min(block_sum(cnt, sm), c.R - 1);
  const int excl = prefix_at(c, sm, i_r, E, false);
  const int o_r = c.ordp[i_r], l_r = c.lenp[i_r];
  const int off = sub32(local, excl);
  const bool mrg = cpos > 0 && o_r > 0 && off == l_r &&
                   add32(op.st, 1) == add32(o_r, l_r) &&
                   op.ol == sub32(add32(o_r, l_r), 2);
  const bool is_split = cpos > 0 && off < l_r;
  const int ins_at = cpos == 0 ? 0 : i_r + 1;
  const int tail_o = o_r > 0 ? add32(o_r, off) : sub32(o_r, off);
  __syncthreads();
  splice(c, active, is_split, mrg, i_r, ins_at, o_r, l_r, off, tail_o,
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
__device__ void seg_ri_end(const Ctx& c, Shared& sm, const int* recv,
                           const Op& op, int s) {
  const int r0 = recv[0], r1 = recv[1];
  int err = sm.st[ST_ERR];
  const bool owner = sm.st[ST_OWNER], cap_bad = sm.st[ST_CAPBAD];
  __syncthreads();
  if (r0 == 0) err |= kErrNoOwner;
  if (owner && cap_bad) err |= kErrCapacity;
  const bool ri = r1 > 0;
  upkeep(c, op, s, ri, ri ? op.ol : 0, ri ? op.orr : 0);
  if (threadIdx.x == 0) sm.st[ST_ERR] = err;
  __syncthreads();
}

__device__ void seg_finish(Shared& sm) {
  __syncthreads();
  if (threadIdx.x == 0) sm.st[ST_SEND] = sm.st[ST_ERR];
  __syncthreads();
}

__device__ void run_segment(const Ctx& c, Shared& sm, const int* rows_in,
                            const int* recv, int code, int s) {
  Op op{};
  if (s < c.S) op = load_op(c, s);
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

__global__ void __launch_bounds__(kThreads, 1)
    sp_replay_kernel(Ctx c, const int* rows_in, int* st_g, const int* recv,
                     Items items) {
  __shared__ Shared sm;
  if (items.n < 0) {
    // The whole stream at sp = 1: sp_apply.drive on the card, each
    // collective the identity (a segment's result is its own send words).
    const int* self = sm.st + ST_SEND;
    run_segment(c, sm, rows_in, self, SEG_INIT, 0);
    for (int s = 0; s < c.S; ++s) {
      const Op op = load_op(c, s);
      if (op.kd == kKindLocal && op.d > 0) {
        run_segment(c, sm, rows_in, self, SEG_LD_TOTAL, s);
        run_segment(c, sm, rows_in, self, SEG_LD_COVER, s);
        run_segment(c, sm, rows_in, self, SEG_LD_SPLIT, s);
      }
      if (op.kd == kKindLocal && op.il > 0) {
        run_segment(c, sm, rows_in, self, SEG_LI_HEAD, s);
        run_segment(c, sm, rows_in, self, SEG_LI_SPLICE, s);
        run_segment(c, sm, rows_in, self, SEG_LI_END, s);
      }
      if (op.kd == kKindRemoteDel && op.d > 0) {
        run_segment(c, sm, rows_in, self, SEG_RD_COVER, s);
        run_segment(c, sm, rows_in, self, SEG_RD_SPLIT, s);
      }
      if (op.kd == kKindRemoteIns && op.il > 0) {
        run_segment(c, sm, rows_in, self, SEG_RI_TOTAL, s);
        run_segment(c, sm, rows_in, self, SEG_RI_LEFT, s);
        run_segment(c, sm, rows_in, self, SEG_RI_START, s);
        while (sm.st[ST_MORE]) {
          run_segment(c, sm, rows_in, self, SEG_RI_RUN, s);
          run_segment(c, sm, rows_in, self, SEG_RI_TABS, s);
          run_segment(c, sm, rows_in, self, SEG_RI_OLEFT, s);
          run_segment(c, sm, rows_in, self, SEG_RI_NEXT, s);
        }
        run_segment(c, sm, rows_in, self, SEG_RI_SPLICE, s);
        run_segment(c, sm, rows_in, self, SEG_RI_END, s);
      }
    }
    run_segment(c, sm, rows_in, self, SEG_FINISH, c.S);
  } else {
    for (int k = threadIdx.x; k < kStateWords; k += kThreads)
      sm.st[k] = st_g[k];
    __syncthreads();
    for (int i = 0; i < items.n; ++i)
      run_segment(c, sm, rows_in, recv, items.code[i], items.step[i]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kStateWords; k += kThreads) st_g[k] = sm.st[k];
}

}  // namespace

extern "C" int sp_replay_launch(int* ordp, int* lenp, int* oll, int* orl,
                                int* rkl, const int* rows_in,
                                const int* cols, int* ols, int* ors,
                                int* st, const int* recv, int R, int OTS,
                                int S, int nsp, int sidx, int n_items,
                                int c0, int s0, int c1, int s1, int c2,
                                int s2, int c3, int s3, void* stream) {
  Ctx c;
  c.ordp = ordp;
  c.lenp = lenp;
  c.oll = oll;
  c.orl = orl;
  c.rkl = rkl;
  c.cols = cols;
  c.ols = ols;
  c.ors = ors;
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
  sp_replay_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(c, rows_in, st,
                                                             recv, items);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
