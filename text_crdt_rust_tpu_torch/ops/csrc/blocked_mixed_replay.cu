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
// An order -> block hint table (ordblk) is verified against its block on
// every lookup, falls back to a search of the whole state, and is healed.
// The by-order tables (128 orders a row: oll, orl mutable, rkl read-only)
// come prefilled from the host; a splice records its run's block, origin
// left and origins right. err row 0: the rebalance found fill > K - lmax;
// row 1: a delete ran past the end or left targets unresolved; row 2: an
// order absent from the document.
//
// A cursor after ROOT is 0 and looks nothing up here; the TPU kernel also
// runs the lookup of ROOT (jnp.where evaluates both branches), whose only
// effect is a hint entry that the next lookup verifies, so no output
// differs.
//
// Mapping. One thread block per lane of threads_for(K) threads (64 at
// K = 256: each barrier of the scan is cheaper with fewer warps). The
// document's CAP rows (32,768 at the config-4 storm, 128 KB) and the block
// tables live in shared memory; the three mutable tables (53 KB each at the storm) do not
// fit beside them, so each lane keeps its own copy in device memory (the
// TPU kernel holds one lane-replicated copy in VMEM); rkl is read by all
// lanes. The rebalance goes through a lane-private scratch in device
// memory.
//
// What bounds it. Not bytes (the output, the origins and the tables, a few
// tens of MB). The serial chain of dependent steps and, within a remote
// insert, of conflict-scan iterations (each a descent, a table read and an
// order lookup) bounds it. The design keeps each step inside one thread
// block and the rows it touches in shared memory, and runs all B chains at
// once.

#include <cuda_runtime.h>

#include "blocked_ops.cuh"

namespace {

using namespace blocked_ops;

constexpr int kLanes = 128;  // orders per by-order table row
constexpr int kLocal = 0, kRemoteIns = 1, kRemoteDel = 2;

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

struct Mixed : Blocked {
  int* ordblk;      // this lane's [OTL] tables, device memory
  int* oll;
  int* orl;
  const int* rkl;   // [OTL], read-only, all lanes
  int OT, DMAX;

  __device__ int tab_index(int o) const {
    const int r = clampi(floordiv(o, kLanes), 0, OT - 1);
    return r * kLanes + (o - floordiv(o, kLanes) * kLanes);
  }
  __device__ int tab_read(const int* tab, int o) const {
    return tab[tab_index(o)];
  }
  // Thread 0 writes, then every thread synchronises.
  __device__ void tab_write(int* tab, int o, int v) {
    if (t == 0) tab[tab_index(o)] = v;
    __syncthreads();
  }
  // tab[start, start+n) = v through the TPU kernel's two-row window.
  __device__ void tab_write_run(int* tab, int start, int n, int v) {
    if (t == 0) {
      const int r0 = floordiv(start, kLanes);
      const int r0c = clampi(r0, 0, OT - 2);
      for (int gi = start; gi < start + n; ++gi) {
        const int q = gi - r0 * kLanes;
        if (q >= 0 && q < 2 * kLanes) tab[r0c * kLanes + q] = v;
      }
    }
    __syncthreads();
  }

  // Smallest block holding raw position c, clamped to the last block.
  __device__ int block_of_raw(int c) {
    return min(count_prefix_below(rws, NB, c + 1), NB - 1);
  }
  __device__ int item_at_raw(int c) {
    const int b = block_of_raw(c);
    const int row = c - raw_before_block(b);
    return (row >= 0 && row < K) ? block(b)[row] : 0;
  }

  // (block, row) of the item with order o: the hinted block, else a
  // search of the whole state (err row 2 when absent: block NB, row 0);
  // the hint is healed either way.
  __device__ void locate_order(int o, int* b_out, int* row_out) {
    const int bh = clampi(tab_read(ordblk, o), 0, NB - 1);
    const int* blk = block(bh);
    int m = K;
    for (int k = t; k < K; k += T)
      if (blk[k] == o + 1 || blk[k] == -(o + 1)) m = min(m, k);
    int row = bmin(m), b = bh;
    if (row == K) {
      int gm = CAP;
      for (int i = t; i < CAP; i += T)
        if (sig[i] == o + 1 || sig[i] == -(o + 1)) gm = min(gm, i);
      const int gq = bmin(gm);
      if (gq == CAP) raise_err(2);
      b = gq / K;
      row = gq % K;
    }
    tab_write(ordblk, o, b);
    *b_out = b;
    *row_out = row;
  }

  __device__ int cursor_after(int o) {
    if (o == -1) return 0;  // ROOT
    int b, row;
    locate_order(o, &b, &row);
    return raw_before_block(b) + row + 1;
  }

  // The shared splice plus the order index and the origin tables.
  __device__ void splice_at(int b, int c, int il, int st, int left,
                            int right) {
    splice(b, c, il, st);
    tab_write_run(ordblk, st, il, b);
    tab_write(oll, st, left);
    tab_write_run(orl, st, il, right);
  }

  __device__ void local_insert_mixed(int p, int il, int st, int* ol_k,
                                     int* or_k) {
    const Target x = insert_target(p, il);
    const int left = p == 0 ? -1 : (int)order_of(x.left);
    const int right = x.succ == 0 ? -1 : (int)order_of(x.succ);
    splice_at(x.b, x.c, il, st, left, right);
    if (t == 0) {
      *ol_k = left;
      *or_k = right;
    }
  }

  // The YATA conflict scan (`doc.rs:183-222`), pinned-scan_start rule.
  __device__ int integrate_cursor(int my_rank, int o_left, int o_right) {
    const int left_cursor = cursor_after(o_left);
    int cursor = left_cursor, scan_start = left_cursor;
    bool scanning = false;
    const int n = total_raw();
    while (cursor < n) {
      const int v = item_at_raw(cursor);
      const int other_order = (v < 0 ? -v : v) - 1;
      const int other_left = tab_read(oll, other_order);
      const int other_right = tab_read(orl, other_order);
      const int other_rank = tab_read(rkl, other_order);
      const int olc = cursor_after(other_left);
      bool brk = other_order == o_right || olc < left_cursor;
      const bool eq = !brk && olc == left_cursor;
      const bool gt = my_rank > other_rank;
      brk = brk || (eq && !gt && o_right == other_right);
      if (eq && !gt && o_right != other_right && !scanning)
        scan_start = cursor;
      if (eq) scanning = gt ? false : (o_right == other_right ? scanning : true);
      if (brk) break;
      ++cursor;
    }
    return scanning ? scan_start : cursor;
  }

  __device__ void remote_insert(int my_rank, int o_left, int o_right, int il,
                                int st, int* ol_k, int* or_k) {
    const int raw = integrate_cursor(my_rank, o_left, o_right);
    int b = block_of_raw(raw);
    if (block_rows(b) + il > K) {
      rebalance();  // the raw cursor is invariant under a rebalance
      b = block_of_raw(raw);
    }
    const int c = raw - raw_before_block(b);
    splice_at(b, c, il, st, o_left, o_right);
    if (t == 0) {
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
      int* blk = block(b);
      int flips = 0, bits = 0;
      for (int k = t; k < K; k += T) {
        const int v = blk[k];
        const int diff = (v < 0 ? -v : v) - 1 - tg;
        if (v != 0 && diff >= 0 && diff < dl) {
          bits += 1 << clampi(diff, 0, 30);
          if (v > 0) {
            blk[k] = -v;  // only this thread touches row k here
            ++flips;
          }
        }
      }
      const int F = bsum(flips);
      bits = bsum(bits);
      if (t == 0) liv[slot(b)] -= F;
      __syncthreads();
      mask &= ~bits;
      ++iters;
    }
    if (mask != 0) raise_err(1);
  }
};

__global__ void __launch_bounds__(kThreads) blocked_mixed_replay_kernel(
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
    int* ordblk, int* oll, int* orl,  // [B, OTL] lane-private tables
    int S, int B, int CAP, int K, int NB, int NBp, int LMAX, int DMAX,
    int OTL) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x;
  Mixed X;
  X.t = threadIdx.x;
  X.T = blockDim.x;
  X.B = B;
  X.lane = lane;
  X.K = K;
  X.NB = NB;
  X.NBp = NBp;
  X.NSUP = 0;
  X.LMAX = LMAX;
  X.CAP = CAP;
  X.two_level = false;
  X.sig = smem;
  X.rws = X.sig + CAP;
  X.liv = X.rws + NBp;
  X.red = X.liv + NBp;
  X.supliv = nullptr;
  X.tmp = tmp + (size_t)lane * CAP;
  X.err = err;
  X.ordblk = ordblk + (size_t)lane * OTL;
  X.oll = oll + (size_t)lane * OTL;
  X.orl = orl + (size_t)lane * OTL;
  X.rkl = rkl;
  X.OT = OTL / kLanes;
  X.DMAX = DMAX;
  zero(smem, CAP + 2 * NBp);
  for (int i = X.t; i < OTL; i += X.T) {
    X.ordblk[i] = 0;
    X.oll[i] = oll_in[i];
    X.orl[i] = orl_in[i];
  }
  __syncthreads();

  for (int k = 0; k < S; ++k) {
    const int kd = kind[k], p = pos[k], d = dlen[k], il = ilen[k];
    const size_t o = (size_t)k * B + lane;
    if (kd == kLocal && d > 0) X.local_delete(p, d);
    if (kd == kLocal && il > 0)
      X.local_insert_mixed(p, il, start[k], ol + o, orr + o);
    if (kd == kRemoteIns && il > 0)
      X.remote_insert(rank[k], olop[k], orop[k], il, start[k], ol + o,
                      orr + o);
    if (kd == kRemoteDel) X.remote_delete(dtgt[k], d);
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
    int* ordblk, int* oll, int* orl, int S, int B, int CAP, int K, int NB,
    int NBp, int LMAX, int DMAX, int OTL, int smem, void* stream) {
  // smem: bytes of the kernel's shared layout, from the Python wrapper
  // (ops/blocked.py::kernel_smem_bytes), which also refuses a K outside
  // [8, 1024] and a document past the shared-memory limit.
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blocked_mixed_replay_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  blocked_mixed_replay_kernel<<<B, threads_for(K), smem, (cudaStream_t)stream>>>(
      kind, pos, dlen, dtgt, olop, orop, rank, ilen, start, oll_in, orl_in,
      rkl, ol, orr, signed_out, rows_out, err, tmp, ordblk, oll, orl, S, B,
      CAP, K, NB, NBp, LMAX, DMAX, OTL);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
