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
// Mapping. One thread block per lane walks the lane's T x S steps in
// order. The lane's signed column lives in shared memory for the launch
// (two copies: the splice reads one and writes the other) with its
// live-prefix counts; the four by-order logs stay in device memory (read
// by the YATA scan, written only in the lmax-wide window). Each thread
// owns E = ceil(CAP / 128) consecutive rows: the live-prefix cumsum is a
// block scan, `oli` a block sum, every order -> row lookup a block min
// over the first hit in each thread's rows (no hit -> row 0, as argmax of
// an all-false mask). The YATA scan's iterations run in order, each with
// one block-wide lookup. A step whose op is idle on a lane still adds its
// ins_len (0) and order_advance, as the TPU program does.
//
// What bounds it. Bytes are small (the signed column in and out once per
// launch, the op stack once, a few log words a step); the floor is each
// lane's serial chain of steps, each a handful of block barriers. A
// simple, correct kernel first: its speed is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kRoot = 0xFFFFFFFFu;
constexpr int kNoHit = 0x7FFFFFFF;

// Op columns, in ops/flat.py::OP_COLUMNS order.
enum {
  C_KIND, C_POS, C_DLEN, C_DTGT, C_OL, C_OR, C_ILEN, C_IOS, C_ADV, C_RANK
};
constexpr uint32_t kKindLocal = 0, kKindRemoteIns = 1, kKindRemoteDel = 2;

__device__ __forceinline__ uint32_t abs_u(int s) {
  return s < 0 ? 0u - (uint32_t)s : (uint32_t)s;
}

// Row content -> order (u32; garbage on empty rows).
__device__ __forceinline__ uint32_t order_of(int s) { return abs_u(s) - 1u; }

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Block-wide sum / min; every thread gets the result. `red` holds kWarps
// ints; the leading barrier frees it from the previous reduction.
__device__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) t += red[i];
  return t;
}

__device__ int block_min(int v, int* red) {
  v = __reduce_min_sync(0xffffffffu, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) t = min(t, red[i]);
  return t;
}

struct Lane {
  int* sig;        // shared: the signed column being read
  int* sig2;       // shared: the splice's target
  int* cum;        // shared: live-prefix counts
  int* red;        // shared: reduction scratch
  uint32_t* ol;    // device: this lane's by-order logs
  uint32_t* orr;
  const uint32_t* rank;
  int cap, ocap, E;
};

// First row holding item `order`, 0 when none does.
__device__ int row_of(const Lane& L, uint32_t order) {
  const int lo = threadIdx.x * L.E, hi = min(L.cap, lo + L.E);
  int hit = kNoHit;
  for (int j = lo; j < hi; ++j) {
    const int s = L.sig[j];
    if (s != 0 && order_of(s) == order) { hit = j; break; }
  }
  hit = block_min(hit, L.red);
  return hit == kNoHit ? 0 : hit;
}

__device__ int cursor_after(const Lane& L, uint32_t order) {
  return order == kRoot ? 0 : row_of(L, order) + 1;
}

__device__ uint32_t read_log(const uint32_t* log, uint32_t order, int ocap) {
  return log[clampi((int)order, 0, ocap - 1)];
}

// The YATA conflict scan (`doc.rs:167-234`) on the post-delete column: the
// final row of a remote insert run. Uniform across the block.
__device__ int integrate(const Lane& L, int n, uint32_t my_rank,
                         uint32_t origin_left, uint32_t origin_right) {
  const int cursor0 = cursor_after(L, origin_left);
  int cursor = cursor0, scan_start = cursor0;
  bool scanning = false;
  while (cursor < n) {
    const int c = clampi(cursor, 0, L.cap - 1);
    const uint32_t other = order_of(L.sig[c]);
    const uint32_t other_left = read_log(L.ol, other, L.ocap);
    const uint32_t other_right = read_log(L.orr, other, L.ocap);
    const uint32_t other_rank = read_log(L.rank, other, L.ocap);
    const int olc = cursor_after(L, other_left);
    bool brk = other == origin_right || olc < cursor0;
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

// The lane's live-prefix counts: cum[j] = live rows in [0, j].
__device__ void live_cumsum(const Lane& L) {
  const int lo = threadIdx.x * L.E, hi = min(L.cap, lo + L.E);
  int c = 0;
  for (int j = lo; j < hi; ++j) c += L.sig[j] > 0;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) L.red[w] = x;
  __syncthreads();
  int base = x - c;
  for (int i = 0; i < w; ++i) base += L.red[i];
  for (int j = lo; j < hi; ++j) {
    base += L.sig[j] > 0;
    L.cum[j] = base;
  }
}

__global__ void __launch_bounds__(kThreads)
flat_replay_kernel(int* __restrict__ g_signed, uint32_t* g_ol, uint32_t* g_or,
                   const uint32_t* g_rank, int* __restrict__ g_n,
                   uint32_t* __restrict__ g_next,
                   const uint32_t* __restrict__ ops,
                   const int* __restrict__ active, int* __restrict__ flags,
                   int T, int S, int B, int CAP, int OCAP, int LMAX) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  Lane L;
  L.sig = smem;
  L.sig2 = smem + CAP;
  L.cum = smem + 2 * CAP;
  L.red = smem + 3 * CAP;
  L.ol = g_ol + (size_t)b * OCAP;
  L.orr = g_or + (size_t)b * OCAP;
  L.rank = g_rank + (size_t)b * OCAP;
  L.cap = CAP;
  L.ocap = OCAP;
  L.E = (CAP + kThreads - 1) / kThreads;

  int* const lane_signed = g_signed + (size_t)b * CAP;
  for (int j = threadIdx.x; j < CAP; j += kThreads) L.sig[j] = lane_signed[j];
  int n = g_n[b];
  uint32_t next_order = g_next[b];
  bool flag = false;
  const size_t col_stride = (size_t)T * S * B;
  const int nbits = 32 - __clz(LMAX > 1 ? LMAX : 1);
  const int roll_mask = (int)((1u << nbits) - 1u);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int s = 0; s < S; ++s) {
      if (!active[t * S + s]) continue;
      const uint32_t* op = ops + ((size_t)t * S + s) * B + b;
      const uint32_t kind = op[C_KIND * col_stride];
      const bool is_local = kind == kKindLocal;
      const bool is_rins = kind == kKindRemoteIns;
      const bool is_rdel = kind == kKindRemoteDel;
      const int pos = (int)op[C_POS * col_stride];
      const uint32_t dlen_u = op[C_DLEN * col_stride];
      const int dlen = (int)dlen_u;
      const uint32_t dtgt = op[C_DTGT * col_stride];
      const int ilen = is_rdel ? 0 : (int)op[C_ILEN * col_stride];
      const uint32_t ios = op[C_IOS * col_stride];

      // ---- delete phase, post-delete prefix counts, oli -------------------
      live_cumsum(L);
      const int pos_end = (int)((uint32_t)pos + dlen_u);
      const int lo = threadIdx.x * L.E, hi = min(CAP, lo + L.E);
      int below = 0;
      for (int j = lo; j < hi; ++j) {
        const int sj = L.sig[j];
        const int cj = L.cum[j];
        bool del = false;
        if (is_local) {
          del = sj > 0 && cj > pos && cj <= pos_end;
        } else if (is_rdel) {
          del = sj != 0 && (order_of(sj) - dtgt) < dlen_u;
        }
        if (del) L.sig[j] = (int)(0u - abs_u(sj));
        int c2 = cj;
        if (is_local) {
          int x = (int)((uint32_t)cj - (uint32_t)pos);
          x = x < 0 ? 0 : x;
          x = x > dlen ? dlen : x;
          c2 = cj - x;
        }
        below += c2 < pos;
      }
      const int oli = block_sum(below, L.red);  // barrier: flips visible

      // ---- insert phase ---------------------------------------------------
      int cursor;
      uint32_t origin_left, origin_right;
      if (is_rins) {
        origin_left = op[C_OL * col_stride];
        cursor = integrate(L, n, op[C_RANK * col_stride], origin_left,
                           op[C_OR * col_stride]);
        origin_right = op[C_OR * col_stride];
      } else {
        cursor = pos == 0 ? 0 : oli + 1;
        origin_left =
            pos == 0 ? kRoot : order_of(L.sig[clampi(oli, 0, CAP - 1)]);
        origin_right = cursor < n
                           ? order_of(L.sig[clampi(cursor, 0, CAP - 1)])
                           : kRoot;
      }
      // Splice into the other copy: rows >= cursor take row j - ilen (a
      // circular roll by ilen's low bits), the new run its orders.
      const int eff = ilen & roll_mask;
      const int run_end = (int)((uint32_t)cursor + (uint32_t)ilen);
      for (int j = lo; j < hi; ++j) {
        int v;
        if (j < cursor) {
          v = L.sig[j];
        } else if (j < run_end) {
          v = (int)(ios + (uint32_t)(j - cursor) + 1u);
        } else {
          int src = (j - eff) % CAP;
          if (src < 0) src += CAP;
          v = L.sig[src];
        }
        L.sig2[j] = v;
      }
      // The lmax-wide log window of a local insert's origins.
      if (is_local && ilen > 0) {
        const int start = clampi((int)ios, 0, OCAP - LMAX);
        for (int k = threadIdx.x; k < LMAX && k < ilen; k += kThreads) {
          if (k == 0) L.ol[start] = origin_left;
          L.orr[start + k] = origin_right;
        }
      }
      int* tmp = L.sig;
      L.sig = L.sig2;
      L.sig2 = tmp;
      n = (int)((uint32_t)n + (uint32_t)ilen);
      next_order += op[C_ADV * col_stride];
      __syncthreads();
    }
    flag = flag || n > CAP || next_order > (uint32_t)(OCAP - LMAX);
  }

  for (int j = threadIdx.x; j < CAP; j += kThreads) lane_signed[j] = L.sig[j];
  if (threadIdx.x == 0) {
    g_n[b] = n;
    g_next[b] = next_order;
    flags[b] = flag ? 1 : 0;
  }
}

}  // namespace

extern "C" int flat_replay_launch(int* signed_, int* ol, int* orr,
                                  const int* rank, int* n, int* next_order,
                                  const int* ops, const int* active,
                                  int* flags, int T, int S, int B, int CAP,
                                  int OCAP, int LMAX, int smem,
                                  void* stream) {
  // smem: bytes of the kernel's shared layout, from the Python wrapper
  // (ops/flat.py::kernel_smem_bytes), which also refuses a capacity past
  // the shared-memory limit.
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flat_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0) {
    flat_replay_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        signed_, (uint32_t*)ol, (uint32_t*)orr, (const uint32_t*)rank, n,
        (uint32_t*)next_order, (const uint32_t*)ops, active, flags, T, S, B,
        CAP, OCAP, LMAX);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
