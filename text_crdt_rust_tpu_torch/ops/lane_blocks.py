"""Per-lane K-row block machinery of the blocked streaming engine, as plain
PyTorch on ``[rows, B]`` tensors (counterpart of
``text_crdt_rust_tpu/ops/lane_blocks.py``).

Runs live in K-row physical blocks; per-lane logical block tables order
them. Every block index is a ``[1, B]`` lane vector, so a block is
gathered and scattered per lane. The index rules are the Pallas body's:
a gather of a block id outside ``[0, NB)`` reads block 0, a scatter to
one writes nothing. ``oracle_runs`` and ``pack_lane_blocks`` are numpy:
they seed one lane's columns from a host oracle (the serve residency's
upload path).
"""
from __future__ import annotations

import numpy as np
import torch

from .rle_lanes import _vrow, _vshift


def vshift_up(x: torch.Tensor, amt: torch.Tensor, max_amt: int):
    """Rows shifted toward LOWER indices by per-lane ``amt`` in
    ``[0, max_amt]``: ``out[j, b] = x[(j + amt[0, b]) mod rows, b]``, one
    circular roll per bit as in the Pallas body."""
    n = x.shape[0]
    out = x
    for bit in range(max(max_amt, 1).bit_length()):
        s = (1 << bit) % n
        if s:
            out = torch.where(((amt >> bit) & 1) != 0,
                              torch.roll(out, -s, 0), out)
    return out


def _block_rows(b: torch.Tensor, K: int, NB: int) -> torch.Tensor:
    """Row indices ``[K, B]`` of per-lane block ``b`` (block 0 where ``b``
    lies outside ``[0, NB)``)."""
    bc = torch.where((b >= 0) & (b < NB), b, 0)
    kdx = torch.arange(K, device=b.device, dtype=b.dtype)[:, None]
    return (bc * K + kdx).long()


def gather_block(plane: torch.Tensor, b: torch.Tensor, K: int, NB: int):
    """``out[j, lane] = plane[b[0, lane]*K + j, lane]``."""
    return torch.gather(plane, 0, _block_rows(b, K, NB))


def gather_head(plane: torch.Tensor, b: torch.Tensor, K: int, NB: int):
    """Row 0 of per-lane block ``b`` as a ``[1, B]`` vector."""
    return torch.gather(plane, 0, _block_rows(b, K, NB)[:1])


def scatter_block(plane: torch.Tensor, b: torch.Tensor, ws: torch.Tensor,
                  act: torch.Tensor, K: int, NB: int) -> None:
    """Write ``ws`` back to per-lane block ``b`` on ``act`` lanes, in place
    (lanes whose ``b`` lies outside ``[0, NB)`` write nothing)."""
    rows = _block_rows(b, K, NB)
    cur = torch.gather(plane, 0, rows)
    put = act & (b >= 0) & (b < NB)
    plane.scatter_(0, rows, torch.where(put, ws, cur))


def scatter_block2(plane, b1, ws1, b2, ws2, act, K: int, NB: int) -> None:
    """Two-block scatter of a block split (keep-half to ``b1``, moved half
    to the fresh block ``b2``; ``b2`` wins where they coincide)."""
    scatter_block(plane, b1, ws1, act, K, NB)
    scatter_block(plane, b2, ws2, act, K, NB)


def oracle_runs(oracle):
    """RLE-compress a host oracle body into the lanes engines' run rows:
    ``(signed_starts, lens)`` — ±(order+1) of each run head and its
    length, in document order.

    A char extends the current run only when its order is consecutive,
    its tombstone flag matches, AND its ``origin_left`` chains to its
    predecessor.  The chain condition is load-bearing, not cosmetic:
    the kernels' YATA scan skips whole runs on the premise that every
    non-head char's origin_left is its own predecessor (`doc.rs`
    span-skip; see ``rle_lanes_mixed.do_remote_insert``'s merge
    predicate) — seeding a run across an unchained boundary would let a
    later concurrent-insert scan skip a char it must evaluate and land
    the insert at a diverged cursor."""
    n = oracle.n
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    order = oracle.order[:n].astype(np.int64)
    deleted = oracle.deleted[:n]
    oleft = oracle.origin_left[:n].astype(np.int64)
    brk = np.ones(n, dtype=bool)
    brk[1:] = ((order[1:] != order[:-1] + 1)
               | (deleted[1:] != deleted[:-1])
               | (oleft[1:] != order[:-1]))
    starts = np.nonzero(brk)[0]
    lens = np.diff(np.append(starts, n)).astype(np.int64)
    sign = np.where(deleted[starts], -1, 1).astype(np.int64)
    return sign * (order[starts] + 1), lens


def pack_lane_blocks(signed_starts, lens, *, K: int, NB: int, NBT: int,
                     capacity: int):
    """Seed ONE lane's blocked state columns from a run list (the
    residency restore/upload path of ``serve.lanes_backend``): pack runs
    into K-row physical blocks at most ``(K-1)//2`` rows each — the same
    half-full occupancy a leaf split leaves, so every seeded block keeps
    the out-of-blocks row bound the serve capacity probe relies on AND
    immediate insert traffic never needs a split to find headroom.

    Returns ``(cols, run_block)``: the numpy state columns
    ``(ordp[capacity], lenp[capacity], nlog[1], blkord[NBT], rws[NBT],
    liv[NBT], raw[NBT])`` with blocks in identity logical order
    (blkord[l] = l), plus the run -> physical-block assignment
    (i64[R]) so hint seeding stays bit-consistent with the packing
    (one occupancy rule, one owner)."""
    R = len(signed_starts)
    per = max(1, (K - 1) // 2)
    nblocks = -(-R // per) if R else 0
    if nblocks > NB:
        raise ValueError(
            f"{R} runs need {nblocks} blocks of {per} rows but only {NB} "
            f"blocks exist (the fits_doc probe should have refused)")
    ordp = np.zeros(capacity, np.int32)
    lenp = np.zeros(capacity, np.int32)
    blkord = np.zeros(NBT, np.int32)
    rws = np.zeros(NBT, np.int32)
    liv = np.zeros(NBT, np.int32)
    raw = np.zeros(NBT, np.int32)
    for b in range(nblocks):
        lo, hi = b * per, min((b + 1) * per, R)
        rows = hi - lo
        ordp[b * K: b * K + rows] = signed_starts[lo:hi]
        lenp[b * K: b * K + rows] = lens[lo:hi]
        blkord[b] = b
        rws[b] = rows
        live = signed_starts[lo:hi] > 0
        liv[b] = int(lens[lo:hi][live].sum())
        raw[b] = int(lens[lo:hi].sum())
    nlog = np.asarray([max(nblocks, 1)], np.int32)
    run_block = np.arange(R, dtype=np.int64) // per
    return (ordp, lenp, nlog, blkord, rws, liv, raw), run_block


def lane_apply_partial(a, i_p, bo, bl, cs, ce, idx):
    """Split run row ``i_p`` around its covered live sub-range
    ``[cs, ce)`` into [head?] [tombstone mid] [tail?] (<= +2 rows), per
    lane where ``a``. ``idx`` is the row iota of the plane being edited."""
    o = _vrow(bo, i_p)
    ln = _vrow(bl, i_p)
    cs_i = _vrow(cs, i_p)
    ce_i = _vrow(ce, i_p)
    cov_i = ce_i - cs_i
    has_head = (cs_i > 0) & a
    has_tail = (ce_i < ln) & a
    amt = has_head.to(torch.int32) + has_tail.to(torch.int32)
    so = _vshift(bo, amt)
    sl = _vshift(bl, amt)
    no = torch.where(idx <= i_p, bo, so)
    nl = torch.where(idx <= i_p, bl, sl)
    p0o = torch.where(has_head, o, -(o + cs_i))
    p0l = torch.where(has_head, cs_i, cov_i)
    p1o = torch.where(has_head, -(o + cs_i), o + ce_i)
    p1l = torch.where(has_head, cov_i, ln - ce_i)
    w0 = a & (idx == i_p)
    no = torch.where(w0, p0o, no)
    nl = torch.where(w0, p0l, nl)
    w1 = a & (idx == i_p + 1) & (amt >= 1)
    no = torch.where(w1, p1o, no)
    nl = torch.where(w1, p1l, nl)
    w2 = a & (idx == i_p + 2) & (amt == 2)
    no = torch.where(w2, o + ce_i, no)
    nl = torch.where(w2, ln - ce_i, nl)
    return no, nl, amt
