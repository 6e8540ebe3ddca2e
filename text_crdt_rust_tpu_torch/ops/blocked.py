"""Per-character blocked replay on PyTorch and CUDA (counterpart of
``text_crdt_rust_tpu/ops/blocked.py``), and the block-plane helpers the
run replays share.

Device state is one row per character: ``signed`` holds ±(order+1) (the
``span_arrays`` encoding, 0 = empty) as ``NB`` blocks of ``K`` rows, the
occupied rows packed at each block's front, with per-block row and live
counts ``rws``/``liv``:

- position -> block is a cumsum over the ``NB`` block live counts,
  position -> row one cumsum over a K-row block;
- an insert splices one block by a circular roll of its rows;
- a delete flips signs inside a two-block window walked across the span;
- a block overflow runs a global rebalance: every block's packed rows are
  compacted in order and dealt out evenly again (``fill`` rows a block).

Documents batch in the lane dimension: every lane replays the same local
stream. Each insert emits ``origin_left`` / ``origin_right``
(`doc.rs:447-453`: the raw predecessor and successor, tombstones not
skipped), merged into the by-order logs on the host by
``blocked_to_flat``.

Two implementations of the replay, held against each other bit for bit:

- ``blocked_replay_plain``: plain PyTorch on ``[rows, B]`` tensors, a
  line-for-line translation of ``_replay_kernel`` over ``_BlockOps``, with
  its lane-max control scalars (the rebalance's compaction is one
  vectorised gather; it leaves the rows the deal reads as the kernel's
  K-row copies do);
- ``ops/csrc/blocked_replay.cu``: the hand-written CUDA kernel, one thread
  block per lane, the lane's whole document in shared memory, one warp
  running the step chain.

``blocked_replay`` picks between them by the device of its inputs.
``_BlockOps`` is written once and also carries ``ops/blocked_hbm.py``
(two-level descent) and ``ops/blocked_mixed.py`` (remote ops); its CUDA
twin is ``ops/csrc/blocked_ops.cuh``.

``_order_of`` lives here (the JAX package keeps it in ``ops/flat.py``,
whose other functions are still to be ported).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..common import ROOT_ORDER
from . import _kernels
from .batch import (
    KIND_LOCAL,
    OpTensors,
    merge_fused_origins,
    prefill_logs,
    require_unfused,
)
from .span_arrays import FlatDoc, make_flat_doc, u32_bits

I32 = torch.int32

#: Shared memory one thread block may use on an H100 (232,448 bytes).
SMEM_LIMIT = 232448
#: Rows compared at a time by ``lanes_equal`` (bounds its temporary).
_ROWS_PER_PASS = 1 << 20


def _require(cond: bool, msg: str) -> None:
    """Config/capacity precheck that must fire even under ``python -O``
    (a violated precondition corrupts device state silently, no crash)."""
    if not cond:
        raise ValueError(msg)


def _lane_scalar(x2d: torch.Tensor) -> int:
    """Row-sum then lane-max: collapse a lane-replicated [rows, B] value
    to one scalar. Valid because every doc (lane) replays the same stream,
    so all lanes hold identical control state."""
    return int(x2d.sum(dim=0).max())


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the row axis, kept in the input's dtype
    (int32 wraps as the JAX roll-add scan does)."""
    return torch.cumsum(x, dim=0, dtype=x.dtype)


def _roll_amount(amount: int, max_amount: int, n: int) -> int:
    """The net roll of the JAX package's one-static-roll-per-bit shift:
    only the low ``bit_length(max_amount)`` bits of ``amount`` are read,
    and the rolls wrap modulo the row count ``n``."""
    bits = max(max_amount, 1).bit_length()
    return (amount & ((1 << bits) - 1)) % n


def _shift_rows(x: torch.Tensor, amount: int, max_amount: int) -> torch.Tensor:
    """Rows shifted toward higher indices by ``amount`` (0..max_amount).

    A CIRCULAR roll, as ``pltpu.roll`` is: the top rows wrap to the
    bottom, and every caller masks what it must not keep."""
    return torch.roll(x, _roll_amount(amount, max_amount, x.shape[0]), 0)


def _order_of(signed: int) -> int:
    """Magnitude decode of one row value: ±(order+1) -> order as u32
    (an empty row decodes to ``ROOT_ORDER``, as the u32 cast wraps)."""
    return (abs(signed) - 1) & 0xFFFF_FFFF


def _clamp(x: int, lo: int, hi: int) -> int:
    return max(lo, min(x, hi))


def _row_scalar(arr2d: torch.Tensor, r: int) -> int:
    """Row ``r`` of a lane-replicated [rows, B] value, as one scalar (the
    lane max). A row outside reads as 0, as the masked sum of the Pallas
    body does."""
    if 0 <= r < arr2d.shape[0]:
        return int(arr2d[r].max())
    return 0


# -- the shared block algebra ---------------------------------------------------


class _BlockOps:
    """The block-grid op set on ``[rows, B]`` tensors: the descent, the
    rebalance (the B-tree node-split analog) and the windowed local
    delete, written once for the three per-character engines. Control
    scalars are Python ints (lane-max of lane-replicated values).

    A block or row index past the end reads and writes the last one, as a
    dynamic slice past the end does in the Pallas body (only invalid
    streams reach that). ``counts`` tallies the data-dependent work: the
    rebalances and the delete windows walked."""

    def __init__(self, sig, rws, liv, err, *, K: int, NB: int, LMAX: int):
        self.sig, self.rws, self.liv, self.err = sig, rws, liv, err
        self.K, self.NB, self.LMAX = K, NB, LMAX
        self.CAP, self.NBp = sig.shape[0], rws.shape[0]
        dev = sig.device
        self.idx_nb = torch.arange(self.NBp, dtype=I32, device=dev)[:, None]
        self.idx_k = torch.arange(K, dtype=I32, device=dev)[:, None]
        self.idx_2k = torch.arange(2 * K, dtype=I32, device=dev)[:, None]
        self.counts = {"rebalances": 0, "delete_windows": 0}

    def rows_of(self, b: int, nblocks: int = 1) -> slice:
        """The rows of blocks ``b .. b+nblocks`` (clamped into the state)."""
        s = _clamp(b * self.K, 0, self.CAP - nblocks * self.K)
        return slice(s, s + nblocks * self.K)

    def slot(self, b: int) -> int:
        return _clamp(b, 0, self.NBp - 1)

    def live_before_block(self, b: int) -> int:
        return _lane_scalar(self.liv[:max(b, 0)])

    def raw_before_block(self, b: int) -> int:
        return _lane_scalar(self.rws[:max(b, 0)])

    def block_of_rank(self, rank1: int) -> int:
        """Smallest block whose cumulative live count reaches ``rank1``
        (the B-tree descent `root.rs:54-88` over block sums); NB when
        none does."""
        cumlive = _cumsum_rows(self.liv[:self.NB])
        return _lane_scalar((cumlive < rank1).to(I32))

    def block_rows(self, b: int) -> int:
        return _row_scalar(self.rws, b)

    def total_raw(self) -> int:
        return _lane_scalar(self.rws[:self.NB])

    def add_live(self, b: int, delta: int) -> None:
        self.liv[self.slot(b)] += delta

    def rebalance(self) -> None:
        """Compact all packed rows, redeal ``fill`` rows a block
        (`mutations.rs:623-808` analog). The Pallas body copies each
        block's K rows to the running offset, so its scratch holds every
        block's packed rows in order on ``[0, total)``, and the deal reads
        no other row: that prefix is gathered here at once."""
        K, NB = self.K, self.NB
        self.counts["rebalances"] += 1
        total = self.total_raw()
        fill = (total + NB - 1) // NB
        if fill > K - self.LMAX:
            self.err[0] = 1
        rows = self.rws[:NB].amax(dim=1)
        blocks = self.sig.view(NB, K, -1)
        packed = blocks[self.idx_k.T < rows[:, None]]          # [total, B]
        j = torch.arange(NB, device=rows.device)
        rows_j = torch.clamp(total - j * fill, 0, fill)
        keep = self.idx_k.T < rows_j[:, None]                   # [NB, K]
        src = (j[:, None] * fill + self.idx_k.T)[keep]
        dealt = torch.zeros_like(blocks)
        dealt[keep] = packed[src]
        self.sig.copy_(dealt.view(self.CAP, -1))
        self.rws[:NB] = rows_j[:, None].to(I32)
        self.liv[:NB] = (dealt > 0).sum(dim=1, dtype=I32)

    def local_delete(self, p: int, d: int) -> None:
        """Tombstone ``d`` live chars after content pos ``p``
        (`mutations.rs:520-570`); walks 2-block windows across the span.
        NB+1 windows without finishing means the delete ran off the
        document: ``err[1]``."""
        K, NB = self.K, self.NB
        rem, iters = d, 0
        while rem > 0 and iters <= NB:
            b = min(self.block_of_rank(p + 1), NB - 2)
            base = self.live_before_block(b)
            rows = self.rows_of(b, 2)
            win = self.sig[rows]
            wlive = win > 0
            rank = base + _cumsum_rows(wlive.to(I32))
            flip = wlive & (rank > p) & (rank <= p + rem)
            self.sig[rows] = torch.where(flip, -win, win)
            fc = flip.to(I32)
            f0 = _lane_scalar(torch.where(self.idx_2k < K, fc, 0))
            f1 = _lane_scalar(torch.where(self.idx_2k >= K, fc, 0))
            self.add_live(b, -f0)
            self.add_live(b + 1, -f1)
            rem -= f0 + f1
            iters += 1
        self.counts["delete_windows"] += iters
        if rem > 0:
            self.err[1] = 1

    def local_insert_block(self, p: int):
        """(block, occupied rows) an insert at live rank ``p`` targets —
        the cheap pre-check before the overflow rebalance."""
        b = 0 if p == 0 else self.block_of_rank(p)
        return b, self.block_rows(b)

    def local_insert_target(self, p: int, b: int, r0: int):
        """(row cursor, left_signed, succ_signed) of a local insert at live
        rank ``p`` into block ``b`` of ``r0`` rows (``local_insert_block``
        after any rebalance). Origins per `doc.rs:447-453`: the raw
        successor, tombstones not skipped; past the block's packed rows,
        the first row of the next non-empty block."""
        K, NB, idx_k = self.K, self.NB, self.idx_k
        local_rank = p - self.live_before_block(b)
        blk = self.sig[self.rows_of(b)]
        bcum = _cumsum_rows((blk > 0).to(I32))
        c0 = _lane_scalar((bcum < local_rank).to(I32))
        c = 0 if p == 0 else c0 + 1
        left_signed = _row_scalar(blk, c - 1)
        succ_here = _row_scalar(blk, c)
        lo = max(b + 1, 0)
        nonempty = self.rws[lo:NB] > 0
        nb_next = NB
        if nonempty.shape[0]:
            nb_next = int(torch.where(nonempty, self.idx_nb[lo:NB], NB)
                          .amin(dim=0).max())
        succ_next = _row_scalar(self.sig, self.rows_of(min(nb_next, NB - 1))
                                .start)
        if c < r0:
            succ_signed = succ_here
        else:
            succ_signed = succ_next if nb_next < NB else 0
        return c, left_signed, succ_signed

    def splice(self, b: int, c: int, il: int, st: int) -> None:
        """Insert the run (orders ``st .. st+il``) at row ``c`` of block
        ``b``: rows from ``c`` roll up by ``il`` (`mutations.rs:17-179`;
        packed slack instead of node splits)."""
        rows = self.rows_of(b)
        blk = self.sig[rows]
        shifted = _shift_rows(blk, il, self.LMAX)
        new_vals = st + (self.idx_k - c) + 1
        self.sig[rows] = torch.where(
            self.idx_k < c, blk,
            torch.where(self.idx_k < c + il, new_vals, shifted))
        self.rws[self.slot(b)] += il
        self.add_live(b, il)

    def insert_site(self, p: int, il: int):
        """(block, occupied rows) a local insert of ``il`` items at live
        rank ``p`` lands in, after the overflow rebalance if the block
        cannot absorb it. The Pallas body locates the block twice; without
        a rebalance between them both give the same block."""
        b, r0 = self.local_insert_block(p)
        if r0 + il > self.K:
            self.rebalance()
            b, r0 = self.local_insert_block(p)
        return b, r0

    def local_insert(self, p: int, il: int, st: int):
        """The local insert of ``_replay_kernel.do_insert``: rebalance on
        overflow, then splice. Returns the u32 origins (left, right)."""
        b, r0 = self.insert_site(p, il)
        c, left_signed, succ_signed = self.local_insert_target(p, b, r0)
        left = ROOT_ORDER if p == 0 else _order_of(left_signed)
        right = ROOT_ORDER if succ_signed == 0 else _order_of(succ_signed)
        self.splice(b, c, il, st)
        return left, right


def replay_local_steps(ops_: _BlockOps, cols, lo: int, steps: int, ol, orr):
    """Apply ``steps`` local steps of the op columns (Python lists ``pos,
    del_len, ins_len, ins_order_start``) from index ``lo`` to ``ops_``,
    writing step k's origins to ``ol[k]`` / ``orr[k]``."""
    pos, dlen, ilen, start = cols
    for k in range(steps):
        i = lo + k
        if dlen[i] > 0:
            ops_.local_delete(pos[i], dlen[i])
        if ilen[i] > 0:
            left, right = ops_.local_insert(pos[i], ilen[i], start[i])
            ol[k] = u32_bits(left)
            orr[k] = u32_bits(right)


def block_geometry(capacity: int, block_k: int):
    """``(NB, NBp)``: blocks and the rows of the per-block tables."""
    NB = capacity // block_k
    return NB, max(8, NB)


def add_counts(counts, ops_: _BlockOps) -> None:
    """Add a replay's work tallies to the caller's ``counts`` dict."""
    if counts is not None:
        for k, v in ops_.counts.items():
            counts[k] = counts.get(k, 0) + v


def blocked_replay_plain(pos, dlen, ilen, start, *, steps: int, batch: int,
                         capacity: int, block_k: int, lmax: int,
                         counts=None):
    """The plain PyTorch version of ``_replay_kernel``: replay one shared
    local stream (int32 columns ``[steps]``) into ``batch`` identical
    documents. Returns ``(ol, orr, signed, rows, err)`` in the JAX layout
    (``[S, B]``, ``[S, B]``, ``[CAP, B]``, ``[NBp, B]``, ``[8, B]``, all
    int32, origins as u32 bits) on the device of the inputs. A ``counts``
    dict, when given, receives the replay's work tallies (rebalances,
    delete windows)."""
    S, B, CAP, K = steps, batch, capacity, block_k
    NB, NBp = block_geometry(CAP, K)
    dev = pos.device
    ol = torch.zeros(S, B, dtype=I32, device=dev)
    orr = torch.zeros_like(ol)
    sig = torch.zeros(CAP, B, dtype=I32, device=dev)
    rws = torch.zeros(NBp, B, dtype=I32, device=dev)
    err = torch.zeros(8, B, dtype=I32, device=dev)
    ops_ = _BlockOps(sig, rws, torch.zeros_like(rws), err, K=K, NB=NB,
                     LMAX=lmax)
    cols = [c.cpu().tolist() for c in (pos, dlen, ilen, start)]
    replay_local_steps(ops_, cols, 0, S, ol, orr)
    add_counts(counts, ops_)
    return ol, orr, sig, rws, err


# -- the CUDA kernel ------------------------------------------------------------

_KERNEL = "blocked_replay"
_LAUNCH = "blocked_replay_launch"
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def table_ints(nbp: int, nsupp: int) -> int:
    """Ints of the block tables in shared memory (``blocked_ops.cuh::
    table_ints``): ``rws``, ``liv``, ``hw``, ``supliv``, the non-empty
    bitmask and the helper warps' job slots."""
    return 3 * nbp + nsupp + nbp // 32 + 1 + 2


def kernel_smem_bytes(capacity: int, nbp: int) -> int:
    """Shared memory of one thread block of ``blocked_replay_kernel``: the
    lane's ``capacity`` rows and the block tables."""
    return 4 * (capacity + table_ints(nbp, 0))


def _check_columns(cols, n: int, dev) -> None:
    for c in cols:
        _require(c.device == dev and c.dtype == I32 and c.is_contiguous()
                 and c.shape == (n,),
                 f"op columns must be contiguous int32 [{n}] on one device")


def blocked_replay_cuda(pos, dlen, ilen, start, *, steps: int, batch: int,
                        capacity: int, block_k: int, lmax: int):
    """Launch ``ops/csrc/blocked_replay.cu`` on PyTorch's current stream.
    Same arguments and results as ``blocked_replay_plain``. Refuses a
    document that does not fit one thread block's shared memory."""
    S, B, CAP, K = steps, batch, capacity, block_k
    NB, NBp = block_geometry(CAP, K)
    dev = pos.device
    _check_columns((pos, dlen, ilen, start), S, dev)
    _require(K >= 8, "block_k must be at least 8")
    smem = kernel_smem_bytes(CAP, NBp)
    _require(smem <= SMEM_LIMIT, (
        f"the blocked kernel keeps a document in shared memory: capacity "
        f"{CAP} needs {smem} B (limit {SMEM_LIMIT}); replay larger "
        f"documents on the 'hbm' engine (ops/blocked_hbm.py)"))
    ol = torch.zeros(S, B, dtype=I32, device=dev)
    orr = torch.zeros_like(ol)
    signed = torch.empty(CAP, B, dtype=I32, device=dev)
    rows = torch.empty(NBp, B, dtype=I32, device=dev)
    err = torch.zeros(8, B, dtype=I32, device=dev)
    tmp = torch.empty(B, CAP, dtype=I32, device=dev)  # rebalance scratch
    fn = _kernels.function(_KERNEL, _LAUNCH, _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tensors = (pos, dlen, ilen, start, ol, orr, signed, rows, err, tmp)
    code = fn(*(t.data_ptr() for t in tensors), S, B, CAP, K, NB, NBp, lmax,
              smem, stream)
    _kernels.check(_KERNEL, code)
    _kernels.count_launch(_KERNEL)
    return ol, orr, signed, rows, err


def blocked_replay(pos, dlen, ilen, start, **shape):
    """The replay on the device of its inputs: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if pos.device.type == "cpu":
        return blocked_replay_plain(pos, dlen, ilen, start, **shape)
    if pos.device.type == "cuda":
        return blocked_replay_cuda(pos, dlen, ilen, start, **shape)
    raise ValueError(f"no replay for device {pos.device}")


# -- the replayer -----------------------------------------------------------------


@dataclasses.dataclass
class BlockedResult:
    """Outputs of one per-character replay (one doc group).

    ``check()`` (or ``blocked_to_flat``, which calls it) surfaces the
    error flags."""

    signed: torch.Tensor   # i32[CAP, B] blocked rows (packed per block)
    rows: torch.Tensor     # i32[NBp, B] occupied rows per block
    ol: torch.Tensor       # u32 bits[S, B] per-step local origin_left
    orr: torch.Tensor      # u32 bits[S, B] per-step local origin_right
    err: torch.Tensor      # i32[8, B] 0: capacity; 1: bad delete; 2: order
    block_k: int
    num_blocks: int
    batch: int

    def check(self) -> None:
        # Explicit raises, not assert: these surface device error flags and
        # must fire even under ``python -O``.
        err = self.err.cpu().numpy()
        if err[0].max() != 0:
            raise RuntimeError(
                "blocked engine capacity exhausted (rebalance found fill > "
                "K-lmax); raise capacity")
        if err[1].max() != 0:
            raise RuntimeError(
                "delete ran past the end of the document (invalid op stream)")
        if err[2].max() != 0:
            raise RuntimeError(
                "remote op referenced an order not present in the document "
                "(bad origin or delete target)")


def lanes_equal(res: BlockedResult) -> bool:
    """Every lane equals lane 0: ``signed`` (a few row ranges at a time,
    so no full-size temporary is made), ``rows``, the origins and
    ``err``."""
    n = res.signed.shape[0]
    for lo in range(0, n, _ROWS_PER_PASS):
        part = res.signed[lo:min(lo + _ROWS_PER_PASS, n)]
        if not bool((part == part[:, :1]).all()):
            return False
    return all(bool((t == t[:, :1]).all())
               for t in (res.rows, res.ol, res.orr, res.err))


def check_rows_limit(streams, capacity: int, block_k: int, lmax: int,
                     label) -> None:
    """Refuse a stream that could overflow the rebalance fill limit:
    every insert row must fit ``NB * (K - lmax)``."""
    NB = capacity // block_k
    rows_limit = NB * (block_k - lmax)
    for gi, st in enumerate(streams):
        rows_needed = int(np.asarray(st.ins_len, dtype=np.int64).sum())
        _require(rows_needed <= rows_limit, (
            f"{label(gi)} inserts {rows_needed} rows but {NB} blocks of "
            f"{block_k} hold at most {rows_limit} at the rebalance fill "
            f"limit (K-lmax); raise capacity"))


def stage_columns(streams, get_cols, chunk: int, dev):
    """Each stream's int32 op columns padded to ``s_pad`` (a multiple of
    ``chunk``) and concatenated ``[G * s_pad]`` on ``dev``. Returns
    ``(s_pad, lens, columns)``."""
    lens = [st.num_steps for st in streams]
    s_pad = max(((max(lens) + chunk - 1) // chunk) * chunk, chunk)
    cols = []
    for i in range(len(get_cols(streams[0]))):
        parts = [np.pad(np.asarray(get_cols(st)[i], dtype=np.uint32)
                        .view(np.int32), (0, s_pad - n))
                 for st, n in zip(streams, lens)]
        cols.append(torch.from_numpy(np.concatenate(parts)).to(dev))
    return s_pad, lens, tuple(cols)


def local_columns(ops: OpTensors):
    return (ops.pos, ops.del_len, ops.ins_len, ops.ins_order_start)


def make_replayer(
    ops: OpTensors,
    capacity: int,
    batch: int = 128,
    block_k: int = 256,
    chunk: int = 1024,
    device=None,
):
    """Stage one local stream and return a function of no arguments that
    replays it into ``batch`` identical documents and returns a
    ``BlockedResult``. ``chunk`` pads the step count to a multiple of
    itself, as the JAX package's grid does."""
    dev = resolve_device(device)
    kinds = np.asarray(ops.kind)
    _require(kinds.ndim == 1, "blocked engine takes one shared stream")
    _require(bool((kinds == KIND_LOCAL).all()),
             "blocked engine replays local streams; remote ops -> "
             "ops.blocked_mixed")
    require_unfused(ops, "the blocked engine")
    _require(capacity % block_k == 0,
             f"capacity ({capacity}) must be a multiple of block_k "
             f"({block_k})")
    _require(chunk >= 1, "chunk must be positive")
    NB = capacity // block_k
    _require(NB >= 2, "need at least two blocks (delete window)")
    lmax = ops.lmax
    _require(block_k > lmax, (
        f"block_k ({block_k}) must exceed the insert chunk width "
        f"({lmax}); a full block could never absorb an insert"))
    check_rows_limit([ops], capacity, block_k, lmax, lambda _: "stream")

    s_pad, (s,), staged = stage_columns([ops], local_columns, chunk, dev)
    shape = dict(steps=s_pad, batch=batch, capacity=capacity,
                 block_k=block_k, lmax=lmax)

    def run() -> BlockedResult:
        ol, orr, signed, rows, err = blocked_replay(*staged, **shape)
        return BlockedResult(signed=signed, rows=rows, ol=ol[:s],
                             orr=orr[:s], err=err, block_k=block_k,
                             num_blocks=NB, batch=batch)

    run.staged = staged
    run.shape = shape
    return run


def replay_local(ops: OpTensors, capacity: int, **kw) -> BlockedResult:
    """One-shot convenience wrapper over ``make_replayer``."""
    return make_replayer(ops, capacity, **kw)()


def blocked_to_flat(
    ops: OpTensors,
    res: BlockedResult,
    capacity: int | None = None,
    order_capacity: int | None = None,
    doc_index: int = 0,
) -> FlatDoc:
    """Replay result -> a standard ``FlatDoc`` (one doc of the batch) on
    the result's device: concatenate each block's packed rows, prefill the
    by-order logs, then merge the replay's per-step origins."""
    res.check()
    sig = res.signed[:, doc_index].cpu().numpy()
    r = res.rows[:, doc_index].cpu().numpy()
    K, NB = res.block_k, res.num_blocks
    parts = [sig[b * K: b * K + r[b]] for b in range(NB)]
    flat = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    n = len(flat)
    if capacity is None:
        capacity = max(res.signed.shape[0], n)
    dev = res.signed.device
    doc = prefill_logs(make_flat_doc(capacity, order_capacity, device=dev),
                       ops)
    ol_log = doc.ol_log.cpu().numpy().view(np.uint32).copy()
    or_log = doc.or_log.cpu().numpy().view(np.uint32).copy()
    merge_fused_origins(ol_log, or_log, ops,
                        res.ol[:, doc_index].cpu().numpy().view(np.uint32),
                        res.orr[:, doc_index].cpu().numpy().view(np.uint32))
    signed_col = np.zeros(capacity, np.int32)
    signed_col[:n] = flat
    advance = int(np.asarray(ops.order_advance, dtype=np.int64).sum())
    return dataclasses.replace(
        doc,
        signed=torch.from_numpy(signed_col).to(dev),
        ol_log=torch.from_numpy(ol_log.view(np.int32)).to(dev),
        or_log=torch.from_numpy(or_log.view(np.int32)).to(dev),
        n=n,
        next_order=advance & 0xFFFF_FFFF,
    )
