"""Per-character blocked replay of mixed local/remote streams on PyTorch
and CUDA (counterpart of ``text_crdt_rust_tpu/ops/blocked_mixed.py``).

``ops.blocked``'s block layout and ``_BlockOps``, with the full op
surface: ``KIND_LOCAL``, ``KIND_REMOTE_INS`` (YATA integrate,
`doc.rs:167-234`) and ``KIND_REMOTE_DEL`` (order-range tombstones,
`doc.rs:295-340`), so the config-4 concurrent-insert storm replays in one
launch. What the remote paths add:

- an order -> block HINT table (``ordblk``): a splice records its run's
  block; a rebalance leaves it stale on purpose, so a lookup verifies the
  hinted block, falls back to one search over the whole state and heals
  the entry;
- by-order origin/rank tables (``oll``/``orl`` mutable, ``rkl``
  read-only), prefilled on the host (``batch.prefill_logs``), 128 orders
  a row (``LANES`` counts ORDERS of a table row, not documents);
- the remote insert's conflict scan over raw positions, with the
  reference's pinned ``scan_start`` rule (not upstream Rust's, see
  ``tests/test_integrate_divergence.py``);
- the remote delete's bitmask walk over its (<= 16) target orders: each
  pass resolves the lowest open order to its block, flips every in-range
  row there and retires their bits (repeated deletes are idempotent,
  `double_delete.rs:6-9`).

A cursor after ``ROOT`` is 0 and looks nothing up here; the Pallas body
also runs the lookup of ``ROOT`` (``jnp.where`` evaluates both branches),
whose only effect is a hint entry the next lookup verifies, so no output
differs.

Two implementations, held against each other bit for bit:

- ``blocked_mixed_replay_plain``: plain PyTorch on ``[rows, B]``
  tensors with lane-max control scalars, as ``_mixed_kernel`` is; the
  conflict scan, which only reads the state, walks one host copy of it
  per remote insert;
- ``ops/csrc/blocked_mixed_replay.cu``: the hand-written CUDA kernel, one
  thread block per lane, the document in shared memory and the lane's
  own copy of the mutable tables in device memory.

``blocked_mixed_replay`` picks between them by the device of its inputs.
Results are ``BlockedResult``s (``err`` row 2: an unknown order).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import resolve_device
from . import _kernels
from .batch import (
    KIND_LOCAL,
    KIND_REMOTE_DEL,
    KIND_REMOTE_INS,
    OpTensors,
    prefill_logs,
    require_unfused,
)
from .blocked import (
    KMAX_KERNEL,
    SMEM_LIMIT,
    BlockedResult,
    _BlockOps,
    _check_columns,
    _clamp,
    _cumsum_rows,
    _lane_scalar,
    _require,
    add_counts,
    block_geometry,
    check_rows_limit,
    kernel_smem_bytes,
    stage_columns,
)
from .span_arrays import make_flat_doc, u32_bits

I32 = torch.int32
LANES = 128  # orders per by-order table row
ROOT_I = -1  # ROOT_ORDER as int32
DMAX = 16    # most remote delete targets a step


class _MixedOps(_BlockOps):
    """``_BlockOps`` plus the order index and the by-order tables of
    ``_mixed_kernel`` (``[OT*128]`` int32 values, one copy for all
    lanes, kept as Python lists)."""

    def __init__(self, sig, rws, liv, err, oll, orl, rkl, *, K, NB, LMAX,
                 OT):
        super().__init__(sig, rws, liv, err, K=K, NB=NB, LMAX=LMAX)
        self.OT = OT
        # The tables hold one value an order for all lanes: host lists.
        self.ordblk = [0] * (OT * LANES)
        self.oll, self.orl, self.rkl = (t.tolist() for t in (oll, orl, rkl))
        self.idx_cap = torch.arange(self.CAP, dtype=I32,
                                    device=sig.device)[:, None]
        self.counts.update(scan_steps=0, fallbacks=0)

    # -- by-order tables (order o at row o // 128, column o % 128) --------

    def tab_index(self, o: int) -> int:
        return _clamp(o // LANES, 0, self.OT - 1) * LANES + o % LANES

    def tab_read(self, tab, o: int) -> int:
        return tab[self.tab_index(o)]

    def tab_write(self, tab, o: int, v: int) -> None:
        tab[self.tab_index(o)] = v

    def tab_write_run(self, tab, start: int, run_len: int, v: int) -> None:
        """``tab[start : start+run_len] = v`` through the Pallas body's
        two-row window (run_len <= 128; the tables keep a spare row)."""
        r0 = start // LANES
        r0c = _clamp(r0, 0, self.OT - 2)
        for g in range(start, start + run_len):
            q = g - r0 * LANES
            if 0 <= q < 2 * LANES:
                tab[r0c * LANES + q] = v

    # -- position plumbing ------------------------------------------------

    def block_of_raw(self, c: int) -> int:
        """Smallest block holding raw position c, clamped to the last
        block (an end-of-document cursor)."""
        cumraw = _cumsum_rows(self.rws[:self.NB])
        return min(_lane_scalar((cumraw <= c).to(I32)), self.NB - 1)

    def find_in_block(self, b: int, o: int):
        blk = self.sig[self.rows_of(b)]
        hit = (blk == o + 1) | (blk == -(o + 1))
        found = _lane_scalar(hit.to(I32)) > 0
        row = int(torch.where(hit, self.idx_k, self.K).amin(dim=0).max())
        return found, row

    def locate_order(self, o: int):
        """(block, row) of the item with order ``o``: the hinted block,
        else a search of the whole state (``err[2]`` when absent); the
        hint is healed either way."""
        bh = _clamp(self.tab_read(self.ordblk, o), 0, self.NB - 1)
        found, row = self.find_in_block(bh, o)
        b = bh
        if not found:
            self.counts["fallbacks"] += 1
            hit = (self.sig == o + 1) | (self.sig == -(o + 1))
            g = int(torch.where(hit, self.idx_cap, self.CAP)
                    .amin(dim=0).max())
            if _lane_scalar(hit.to(I32)) == 0:
                self.err[2] = 1
            b, row = g // self.K, g % self.K
        self.tab_write(self.ordblk, o, b)
        return b, row

    def cursor_after(self, o: int) -> int:
        if o == ROOT_I:
            return 0
        b, row = self.locate_order(o)
        return self.raw_before_block(b) + row + 1

    # -- splices ------------------------------------------------------------

    def splice_at(self, b, c, il, st, left, right):
        """The shared splice plus the order index and origin tables."""
        self.splice(b, c, il, st)
        self.tab_write_run(self.ordblk, st, il, b)
        self.tab_write(self.oll, st, left)
        self.tab_write_run(self.orl, st, il, right)

    def do_local_insert(self, p, il, st):
        b, r0 = self.insert_site(p, il)
        c, left_signed, succ_signed = self.local_insert_target(p, b, r0)
        left = ROOT_I if p == 0 else abs(left_signed) - 1
        right = ROOT_I if succ_signed == 0 else abs(succ_signed) - 1
        self.splice_at(b, c, il, st, left, right)
        return left, right

    def raw_view(self):
        """The state as the conflict scan reads it, on the host: the raw
        sequence (each block's packed rows in order, lane max), the block
        of each raw position and each present order's raw position (-1
        when absent). The scan writes only hints, so one view serves a
        whole scan."""
        K, NB = self.K, self.NB
        packed_rows = self.idx_k.T < self.rws[:NB].amax(dim=1)[:, None]
        packed = self.sig.amax(dim=1).view(NB, K)[packed_rows].cpu()
        where = torch.full((self.OT * LANES,), -1, dtype=torch.int64)
        orders = packed.abs().long() - 1
        ok = (orders >= 0) & (orders < where.shape[0])
        where[orders[ok]] = torch.arange(packed.shape[0])[ok]
        block = packed_rows.nonzero()[:, 0].cpu()
        return packed.tolist(), block.tolist(), where.tolist()

    def cursor_after_in(self, view, o: int) -> int:
        """``cursor_after`` read through a ``raw_view`` of the unchanged
        state: the same result, hint and tallies. An order absent from
        the view takes the search over the whole state."""
        if o == ROOT_I:
            return 0
        _raw, block, where = view
        i = where[o] if 0 <= o < len(where) else -1
        if i < 0:
            return self.cursor_after(o)
        b = block[i]
        if _clamp(self.tab_read(self.ordblk, o), 0, self.NB - 1) != b:
            self.counts["fallbacks"] += 1
        self.tab_write(self.ordblk, o, b)
        return i + 1

    def integrate_cursor(self, my_rank, o_left, o_right) -> int:
        """The YATA conflict scan (`doc.rs:183-222`), pinned-scan_start
        rule, over one ``raw_view``."""
        view = self.raw_view()
        raw = view[0]
        cursor = left_cursor = scan_start = self.cursor_after_in(view,
                                                                 o_left)
        scanning = False
        n = len(raw)
        while cursor < n:
            self.counts["scan_steps"] += 1
            other_order = abs(raw[cursor]) - 1
            other_left = self.tab_read(self.oll, other_order)
            other_right = self.tab_read(self.orl, other_order)
            other_rank = self.tab_read(self.rkl, other_order)
            olc = self.cursor_after_in(view, other_left)
            brk = other_order == o_right or olc < left_cursor
            eq = not brk and olc == left_cursor
            gt = my_rank > other_rank
            brk = brk or (eq and not gt and o_right == other_right)
            if eq and not gt and o_right != other_right and not scanning:
                scan_start = cursor
            if eq:
                scanning = False if gt else (
                    scanning if o_right == other_right else True)
            if brk:
                break
            cursor += 1
        return scan_start if scanning else cursor

    def do_remote_insert(self, my_rank, o_left, o_right, il, st):
        raw_cursor = self.integrate_cursor(my_rank, o_left, o_right)
        b = self.block_of_raw(raw_cursor)
        if self.block_rows(b) + il > self.K:
            self.rebalance()  # raw_cursor is invariant under a rebalance
            b = self.block_of_raw(raw_cursor)
        c = raw_cursor - self.raw_before_block(b)
        self.splice_at(b, c, il, st, o_left, o_right)
        return o_left, o_right

    def do_remote_delete(self, t: int, dlen: int) -> None:
        """Tombstone orders ``[t, t+dlen)``: a bit of ``mask`` is a target
        order not yet accounted for; each pass resolves the lowest one to
        its block and retires every in-range row found there."""
        mask = (1 << dlen) - 1
        iters = 0
        while mask != 0 and iters <= DMAX:
            low = mask & -mask
            b, _row = self.locate_order(t + low.bit_length() - 1)
            rows = self.rows_of(b)
            blk = self.sig[rows]
            diff = blk.abs() - 1 - t
            in_range = (blk != 0) & (diff >= 0) & (diff < dlen)
            flip = in_range & (blk > 0)
            self.sig[rows] = torch.where(flip, -blk, blk)
            self.liv[self.slot(b)] -= flip.sum(dim=0, dtype=I32)
            bits = _lane_scalar(torch.where(
                in_range, torch.bitwise_left_shift(
                    torch.ones_like(diff), diff.clamp(0, 30)), 0))
            mask &= ~bits
            iters += 1
        if mask != 0:
            self.err[1] = 1


def blocked_mixed_replay_plain(kind, pos, dlen, dtgt, olop, orop, rank,
                               ilen, start, oll, orl, rkl, *, steps: int,
                               batch: int, capacity: int, block_k: int,
                               lmax: int, order_rows: int, counts=None):
    """The plain PyTorch version of ``_mixed_kernel``: replay one shared
    op stream (nine int32 columns ``[steps]``) with the by-order tables
    ``oll``/``orl``/``rkl`` (int32 ``[order_rows*128]``) into ``batch``
    identical documents. Returns ``(ol, orr, signed, rows, err)`` in the
    JAX layout on the device of the inputs; ``counts``, when given,
    receives the work tallies (rebalances, delete windows, conflict-scan
    steps, full-state lookups)."""
    S, B, CAP, K = steps, batch, capacity, block_k
    NB, NBp = block_geometry(CAP, K)
    dev = kind.device
    ol = torch.zeros(S, B, dtype=I32, device=dev)
    orr = torch.zeros_like(ol)
    sig = torch.zeros(CAP, B, dtype=I32, device=dev)
    rws = torch.zeros(NBp, B, dtype=I32, device=dev)
    err = torch.zeros(8, B, dtype=I32, device=dev)
    m = _MixedOps(sig, rws, torch.zeros_like(rws), err, oll, orl, rkl, K=K,
                  NB=NB, LMAX=lmax, OT=order_rows)
    cols = [c.cpu().tolist() for c in (kind, pos, dlen, dtgt, olop, orop,
                                       rank, ilen, start)]
    for k in range(S):
        kd, p, d, tg, o_l, o_r, rk, il, st = (c[k] for c in cols)
        origins = None
        if kd == KIND_LOCAL and d > 0:
            m.local_delete(p, d)
        if kd == KIND_LOCAL and il > 0:
            origins = m.do_local_insert(p, il, st)
        if kd == KIND_REMOTE_INS and il > 0:
            origins = m.do_remote_insert(rk, o_l, o_r, il, st)
        if kd == KIND_REMOTE_DEL:
            m.do_remote_delete(tg, d)
        if origins is not None:
            ol[k] = u32_bits(origins[0])
            orr[k] = u32_bits(origins[1])
    add_counts(counts, m)
    return ol, orr, sig, rws, err


# -- the CUDA kernel ------------------------------------------------------------

_KERNEL = "blocked_mixed_replay"
_LAUNCH = "blocked_mixed_replay_launch"
_ARGTYPES = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def blocked_mixed_replay_cuda(kind, pos, dlen, dtgt, olop, orop, rank,
                              ilen, start, oll, orl, rkl, *, steps: int,
                              batch: int, capacity: int, block_k: int,
                              lmax: int, order_rows: int):
    """Launch ``ops/csrc/blocked_mixed_replay.cu`` on PyTorch's current
    stream. Same arguments and results as ``blocked_mixed_replay_plain``.
    Refuses a document that does not fit one thread block's shared
    memory."""
    S, B, CAP, K = steps, batch, capacity, block_k
    NB, NBp = block_geometry(CAP, K)
    OTL = order_rows * LANES
    dev = kind.device
    cols = (kind, pos, dlen, dtgt, olop, orop, rank, ilen, start)
    _check_columns(cols, S, dev)
    _check_columns((oll, orl, rkl), OTL, dev)
    _require(8 <= K <= KMAX_KERNEL,
             f"block_k must lie in [8, {KMAX_KERNEL}] for the kernel")
    smem = kernel_smem_bytes(CAP, NBp)
    _require(smem <= SMEM_LIMIT, (
        f"the blocked-mixed kernel keeps a document in shared memory: "
        f"capacity {CAP} needs {smem} B (limit {SMEM_LIMIT})"))
    ol = torch.zeros(S, B, dtype=I32, device=dev)
    orr = torch.zeros_like(ol)
    signed = torch.empty(CAP, B, dtype=I32, device=dev)
    rows = torch.empty(NBp, B, dtype=I32, device=dev)
    err = torch.zeros(8, B, dtype=I32, device=dev)
    tmp = torch.empty(B, CAP, dtype=I32, device=dev)  # rebalance scratch
    # Each lane's own mutable tables: ordblk, oll, orl.
    tables = torch.empty(3, B, OTL, dtype=I32, device=dev)
    fn = _kernels.function(_KERNEL, _LAUNCH, _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tensors = (*cols, oll, orl, rkl, ol, orr, signed, rows, err, tmp,
               *tables)
    code = fn(*(t.data_ptr() for t in tensors), S, B, CAP, K, NB, NBp, lmax,
              DMAX, OTL, smem, stream)
    _kernels.check(_KERNEL, code)
    _kernels.count_launch(_KERNEL)
    return ol, orr, signed, rows, err


def blocked_mixed_replay(*cols, **shape):
    """The replay on the device of its inputs: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    dev = cols[0].device
    if dev.type == "cpu":
        return blocked_mixed_replay_plain(*cols, **shape)
    if dev.type == "cuda":
        return blocked_mixed_replay_cuda(*cols, **shape)
    raise ValueError(f"no replay for device {dev}")


# -- the replayer -----------------------------------------------------------------


def mixed_columns(ops: OpTensors):
    return (ops.kind, ops.pos, ops.del_len, ops.del_target, ops.origin_left,
            ops.origin_right, ops.rank, ops.ins_len, ops.ins_order_start)


def make_replayer_mixed(
    ops: OpTensors,
    capacity: int,
    batch: int = 128,
    block_k: int = 256,
    chunk: int = 1024,
    device=None,
):
    """Stage a mixed local/remote op stream and return a function of no
    arguments that replays it into ``batch`` identical documents and
    returns a ``BlockedResult``. Remote delete runs must be pre-chunked to
    <= 16 targets a step (``compile_remote_txns(..., dmax=16)``)."""
    dev = resolve_device(device)
    kinds = np.asarray(ops.kind)
    _require(kinds.ndim == 1, "blocked engine takes one shared stream")
    require_unfused(ops, "the blocked-mixed engine")
    _require(capacity % block_k == 0,
             f"capacity ({capacity}) must be a multiple of block_k "
             f"({block_k})")
    _require(chunk >= 1, "chunk must be positive")
    NB = capacity // block_k
    _require(NB >= 2, "need at least two blocks (delete window)")
    lmax = ops.lmax
    _require(block_k > lmax, (
        f"block_k ({block_k}) must exceed the insert chunk width ({lmax})"))
    dlens = np.asarray(ops.del_len)[kinds == KIND_REMOTE_DEL]
    _require(dlens.size == 0 or int(dlens.max()) <= DMAX, (
        f"remote delete runs must be <= {DMAX} targets per step "
        f"(compile with dmax={DMAX})"))
    check_rows_limit([ops], capacity, block_k, lmax, lambda _: "stream")

    # By-order tables: everything the compiler knows (remote origins,
    # within-run chains, ranks), 128 orders a row, ROOT as -1, one spare
    # tail row for the two-row run writes, rounded up to 8 rows.
    total_orders = int(np.asarray(ops.order_advance, dtype=np.int64).sum())
    ocap = max(total_orders + lmax, LANES)
    OT = (ocap + LANES - 1) // LANES + 1
    OT = ((OT + 7) // 8) * 8
    doc0 = prefill_logs(make_flat_doc(8, OT * LANES, device=dev), ops)
    tables = (doc0.ol_log, doc0.or_log, doc0.rank_log)

    s_pad, (s,), staged = stage_columns([ops], mixed_columns, chunk, dev)
    staged = staged + tables
    shape = dict(steps=s_pad, batch=batch, capacity=capacity,
                 block_k=block_k, lmax=lmax, order_rows=OT)

    def run() -> BlockedResult:
        ol, orr, signed, rows, err = blocked_mixed_replay(*staged, **shape)
        return BlockedResult(signed=signed, rows=rows, ol=ol[:s],
                             orr=orr[:s], err=err, block_k=block_k,
                             num_blocks=NB, batch=batch)

    run.staged = staged
    run.shape = shape
    return run


def replay_mixed(ops: OpTensors, capacity: int, **kw) -> BlockedResult:
    """One-shot convenience wrapper over ``make_replayer_mixed``."""
    return make_replayer_mixed(ops, capacity, **kw)()
