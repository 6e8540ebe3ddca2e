"""Per-lane K-row block machinery of the blocked streaming engine, as plain
PyTorch on ``[rows, B]`` tensors (counterpart of
``text_crdt_rust_tpu/ops/lane_blocks.py:26-76, 149-183``).

Runs live in K-row physical blocks; per-lane logical block tables order
them. Every block index is a ``[1, B]`` lane vector, so a block is
gathered and scattered per lane. The index rules are the Pallas body's:
a gather of a block id outside ``[0, NB)`` reads block 0, a scatter to
one writes nothing. ``oracle_runs`` and ``pack_lane_blocks`` come with
the serve slice.
"""
from __future__ import annotations

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
