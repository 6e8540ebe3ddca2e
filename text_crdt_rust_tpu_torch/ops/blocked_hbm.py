"""Per-character blocked replay with the state in device memory, on
PyTorch and CUDA (counterpart of ``text_crdt_rust_tpu/ops/blocked_hbm.py``).

``ops.blocked`` keeps a document in on-chip memory, which caps it near
50k rows at 128 lanes; this engine holds the full automerge-paper trace
(182,315 inserted characters, capacity 524,288 rows) across a 128-doc
batch. It is ``ops.blocked``'s algebra with two differences of its own:

- position -> block descends two levels: the ``SUP``-block segment sums
  ``supliv`` first (clamped to the last segment), then one 64-block
  segment of ``liv`` (clamped to the last block), the B-tree's internal
  levels (`mod.rs:85-93`) as two scans; ``supliv`` follows every live
  count change and is rebuilt after a rebalance;
- doc GROUPS: each group replays its own stream into its own
  ``capacity``-row slab of the state; ``err`` is one ``[8, B]`` for all
  groups.

On valid streams the two engines give the same state; past the end of
the document their descents differ (``ops.blocked`` may return NB, this
one clamps to NB-1), and each raises ``err[1]`` by its own arithmetic.

Two implementations, held against each other bit for bit:

- ``blocked_hbm_replay_plain``: plain PyTorch on ``[rows, B]`` tensors,
  ``ops.blocked._BlockOps`` with this engine's descent (the Pallas body's
  window cache and DMA staging move data without changing a value, so the
  plain version works on the state directly);
- ``ops/csrc/blocked_hbm_replay.cu``: the hand-written CUDA kernel, one
  thread block per (lane, group), the lane's rows in device memory.

``blocked_hbm_replay`` picks between them by the device of its inputs.
Results are ``BlockedResult``s, read by ``blocked_to_flat`` as they are.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import resolve_device
from . import _kernels
from .batch import KIND_LOCAL, require_unfused
from .blocked import (
    KMAX_KERNEL,
    SMEM_LIMIT,
    BlockedResult,
    _BlockOps,
    _check_columns,
    _cumsum_rows,
    _lane_scalar,
    _require,
    add_counts,
    check_rows_limit,
    local_columns,
    replay_local_steps,
    stage_columns,
)

I32 = torch.int32

SUP = 64  # blocks per super-block (level-2 index fan-out)


def hbm_geometry(capacity: int, block_k: int):
    """``(NB, NSUP, NBp, NSUPp)``: blocks, super-blocks, the rows of the
    per-block tables (whole super-blocks) and of ``supliv`` (>= 8)."""
    NB = capacity // block_k
    NSUP = (NB + SUP - 1) // SUP
    return NB, NSUP, NSUP * SUP, max(8, ((NSUP + 7) // 8) * 8)


class _HbmOps(_BlockOps):
    """``_BlockOps`` with the two-level live index of
    ``_hbm_replay_kernel``."""

    def __init__(self, sig, rws, liv, err, *, K, NB, NSUP, NSUPp, LMAX):
        super().__init__(sig, rws, liv, err, K=K, NB=NB, LMAX=LMAX)
        self.NSUP = NSUP
        self.supliv = torch.zeros(NSUPp, sig.shape[1], dtype=I32,
                                  device=sig.device)

    def live_before_block(self, b: int) -> int:
        """Super-block prefix + in-segment remainder."""
        s = b // SUP
        return (_lane_scalar(self.supliv[:s])
                + _lane_scalar(self.liv[s * SUP:b]))

    def block_of_rank(self, rank1: int) -> int:
        """Smallest block whose cumulative live count reaches ``rank1``,
        clamped to the last super-block and the last block."""
        supcum = _cumsum_rows(self.supliv[:self.NSUP])
        s = min(_lane_scalar((supcum < rank1).to(I32)), self.NSUP - 1)
        base = _lane_scalar(self.supliv[:s])
        segcum = _cumsum_rows(self.liv[s * SUP:(s + 1) * SUP])
        within = _lane_scalar((segcum < (rank1 - base)).to(I32))
        return min(s * SUP + within, self.NB - 1)

    def add_live(self, b: int, delta: int) -> None:
        self.liv[b] += delta
        self.supliv[b // SUP] += delta

    def rebalance(self) -> None:
        super().rebalance()
        self.supliv[:self.NSUP] = self.liv.view(self.NSUP, SUP, -1).sum(
            dim=1, dtype=I32)


def _alloc(G, S, B, CAP, NBp, dev):
    ol = torch.zeros(G, S, B, dtype=I32, device=dev)
    orr = torch.zeros_like(ol)
    state = torch.zeros(G * CAP, B, dtype=I32, device=dev)
    rows = torch.zeros(G, NBp, B, dtype=I32, device=dev)
    err = torch.zeros(8, B, dtype=I32, device=dev)
    return ol, orr, state, rows, err


def blocked_hbm_replay_plain(pos, dlen, ilen, start, *, groups: int,
                             steps: int, batch: int, capacity: int,
                             block_k: int, lmax: int, counts=None):
    """The plain PyTorch version of ``_hbm_replay_kernel``: replay each
    group's local stream (int32 columns ``[groups*steps]``). Returns
    ``(ol, orr, state, rows, err)`` in the JAX layout (``[G, S, B]`` u32
    bits twice, ``[G*CAP, B]``, ``[G, NBp, B]``, ``[8, B]``) on the device
    of the inputs; ``counts`` as ``blocked_replay_plain``'s."""
    G, S, B, CAP, K = groups, steps, batch, capacity, block_k
    NB, NSUP, NBp, NSUPp = hbm_geometry(CAP, K)
    dev = pos.device
    ol, orr, state, rows, err = outs = _alloc(G, S, B, CAP, NBp, dev)
    cols = [c.cpu().tolist() for c in (pos, dlen, ilen, start)]
    for g in range(G):
        ops_ = _HbmOps(state[g * CAP:(g + 1) * CAP], rows[g],
                       torch.zeros_like(rows[g]), err, K=K, NB=NB,
                       NSUP=NSUP, NSUPp=NSUPp, LMAX=lmax)
        replay_local_steps(ops_, cols, g * S, S, ol[g], orr[g])
        add_counts(counts, ops_)
    return outs


# -- the CUDA kernel ------------------------------------------------------------

_KERNEL = "blocked_hbm_replay"
_LAUNCH = "blocked_hbm_replay_launch"
_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def kernel_smem_bytes(nbp: int, nsupp: int) -> int:
    """Shared memory of one thread block of ``blocked_hbm_replay_kernel``:
    ``rws``/``liv``, ``supliv`` and 40 ints of reduction and broadcast
    scratch (the rows stay in device memory)."""
    return 4 * (2 * nbp + nsupp + 40)


def blocked_hbm_replay_cuda(pos, dlen, ilen, start, *, groups: int,
                            steps: int, batch: int, capacity: int,
                            block_k: int, lmax: int):
    """Launch ``ops/csrc/blocked_hbm_replay.cu`` on PyTorch's current
    stream. Same arguments and results as ``blocked_hbm_replay_plain``."""
    G, S, B, CAP, K = groups, steps, batch, capacity, block_k
    NB, NSUP, NBp, NSUPp = hbm_geometry(CAP, K)
    dev = pos.device
    _check_columns((pos, dlen, ilen, start), G * S, dev)
    _require(8 <= K <= KMAX_KERNEL,
             f"block_k must lie in [8, {KMAX_KERNEL}] for the kernel")
    smem = kernel_smem_bytes(NBp, NSUPp)
    _require(smem <= SMEM_LIMIT,
             f"the block tables of {NB} blocks need {smem} B of shared "
             f"memory (limit {SMEM_LIMIT}); raise block_k")
    ol = torch.zeros(G, S, B, dtype=I32, device=dev)
    orr = torch.zeros_like(ol)
    state = torch.empty(G * CAP, B, dtype=I32, device=dev)
    rows = torch.empty(G, NBp, B, dtype=I32, device=dev)
    err = torch.zeros(8, B, dtype=I32, device=dev)
    # Lane-major working rows and rebalance scratch [G, B, CAP]: one
    # thread block's rows are contiguous; the kernel zeroes its working
    # rows and transposes them into ``state`` once at the end.
    work = torch.empty(G, B, CAP, dtype=I32, device=dev)
    tmp = torch.empty_like(work)
    fn = _kernels.function(_KERNEL, _LAUNCH, _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tensors = (pos, dlen, ilen, start, ol, orr, state, rows, err, work, tmp)
    code = fn(*(t.data_ptr() for t in tensors), G, S, B, CAP, K, NB, NBp,
              NSUP, lmax, smem, stream)
    _kernels.check(_KERNEL, code)
    _kernels.count_launch(_KERNEL)
    return ol, orr, state, rows, err


def blocked_hbm_replay(pos, dlen, ilen, start, **shape):
    """The replay on the device of its inputs: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if pos.device.type == "cpu":
        return blocked_hbm_replay_plain(pos, dlen, ilen, start, **shape)
    if pos.device.type == "cuda":
        return blocked_hbm_replay_cuda(pos, dlen, ilen, start, **shape)
    raise ValueError(f"no replay for device {pos.device}")


# -- the replayer -----------------------------------------------------------------


def make_replayer_hbm(
    ops,
    capacity: int,
    batch: int = 128,
    block_k: int = 512,
    chunk: int = 1024,
    device=None,
):
    """The device-memory variant of ``blocked.make_replayer``.

    ``ops`` is one local stream (``run()`` returns a ``BlockedResult``) or
    a SEQUENCE of them, doc groups (``run()`` returns a list): each group
    replays its own stream into its own ``capacity``-row slab, and lanes
    batch ``batch`` identical documents per group."""
    dev = resolve_device(device)
    grouped = isinstance(ops, (list, tuple))
    streams = list(ops) if grouped else [ops]
    G = len(streams)
    _require(G >= 1, "need at least one op stream")
    lmax = streams[0].lmax
    for st in streams:
        kinds = np.asarray(st.kind)
        _require(kinds.ndim == 1, "blocked engine takes per-group shared "
                 "streams (no per-lane batching inside a group)")
        _require(bool((kinds == KIND_LOCAL).all()),
                 "hbm engine replays local streams; remote ops -> "
                 "ops.blocked_mixed")
        _require(st.lmax == lmax, "all groups must share one lmax")
        require_unfused(st, "the blocked-hbm engine")
    _require(capacity % block_k == 0,
             f"capacity ({capacity}) must be a multiple of block_k "
             f"({block_k})")
    _require(chunk >= 1, "chunk must be positive")
    NB = capacity // block_k
    _require(NB >= 2 and NB % 2 == 0, "need an even number of blocks >= 2")
    _require(block_k > lmax, (
        f"block_k ({block_k}) must exceed the insert chunk width ({lmax})"))
    check_rows_limit(streams, capacity, block_k, lmax,
                     lambda gi: f"group {gi}")

    s_pad, lens, staged = stage_columns(streams, local_columns, chunk, dev)
    shape = dict(groups=G, steps=s_pad, batch=batch, capacity=capacity,
                 block_k=block_k, lmax=lmax)

    def run():
        ol, orr, state, rows, err = blocked_hbm_replay(*staged, **shape)
        results = [
            BlockedResult(
                signed=state[gi * capacity:(gi + 1) * capacity],
                rows=rows[gi], ol=ol[gi, :lens[gi]], orr=orr[gi, :lens[gi]],
                err=err, block_k=block_k, num_blocks=NB, batch=batch)
            for gi in range(G)
        ]
        return results if grouped else results[0]

    run.staged = staged
    run.shape = shape
    return run


def replay_local_hbm(ops, capacity: int, **kw):
    """One-shot convenience wrapper over ``make_replayer_hbm``."""
    return make_replayer_hbm(ops, capacity, **kw)()
