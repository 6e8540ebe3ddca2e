"""Per-lane divergent RLE replay: the host and helper parts the mixed
per-lane engines use (counterpart of pieces of
``text_crdt_rust_tpu/ops/rle_lanes.py``).

Every lane is a different document; every op scalar of the blocked
engines becomes a ``[1, B]`` lane vector. This module holds the lane
result type, the plain PyTorch versions of the lane-vector primitives
(``_vcumsum``, ``_vrow``, ``_vshift``, ``_live_prefix``), the SHARED_CUM
gate, the state padding of growing streaming chunks and the lane
expansion to per-char state. The local-op kernels of that module
(``_rle_lanes_kernel``, ``_lanes_blocked_kernel``) come with a later
slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .blocked import _require

I32 = torch.int32


# -- lane-vector primitives on [rows, B] tensors (plain versions) -------------


def _vcumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along rows, kept in int32 (wraps as the JAX
    roll-add scan does)."""
    return torch.cumsum(x, dim=0, dtype=x.dtype)


def _vrow(arr: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-lane row extraction: ``arr[r[0, b], b]`` as a ``[1, B]`` vector;
    a row outside ``[0, rows)`` reads 0 (the masked sum of the Pallas
    body)."""
    n = arr.shape[0]
    ok = (r >= 0) & (r < n)
    v = torch.gather(arr, 0, torch.where(ok, r, 0).long())
    return torch.where(ok, v, 0)


def _vshift(x: torch.Tensor, amt: torch.Tensor, max_amt: int = 2):
    """Rows shifted down by per-lane ``amt`` in ``[0, max_amt]``: one
    circular roll per bit, selected per lane, as the Pallas body's
    ``pltpu.roll`` blend is (the top rows wrap to the bottom)."""
    n = x.shape[0]
    out = x
    for bit in range(max(max_amt, 1).bit_length()):
        s = (1 << bit) % n
        if s:
            out = torch.where(((amt >> bit) & 1) != 0,
                              torch.roll(out, s, 0), out)
    return out


def _live_prefix(bo: torch.Tensor, bl: torch.Tensor):
    """(lv, cum): live char counts per run row and their inclusive prefix."""
    lv = torch.where(bo > 0, bl, 0)
    return lv, _vcumsum(lv)


def _shared_cum_gate(step_has_del, step_has_ins, s_pad: int) -> bool:
    """Hoist one live prefix per step iff it pays: sound only when no lane
    deletes AND inserts in the same step (callers check that separately),
    and worth it only when steps running BOTH local branches outnumber
    steps running NEITHER (padded no-op steps included)."""
    both = int((step_has_del & step_has_ins).sum())
    neither = int((~(step_has_del | step_has_ins)).sum())
    neither += s_pad - len(step_has_del)
    return both > neither


# -- results and streaming state ---------------------------------------------


@dataclasses.dataclass
class LanesResult:
    """Per-lane divergent documents, on the device of the replay."""

    ordp: torch.Tensor     # i32[CAP, B]
    lenp: torch.Tensor     # i32[CAP, B]
    rows: torch.Tensor     # i32[1, B] occupied run rows per lane
    ol: torch.Tensor       # i32[S, B] (u32 bits)
    orr: torch.Tensor      # i32[S, B] (u32 bits)
    err: torch.Tensor      # i32[8, B]  0: capacity; 1: bad delete
    batch: int

    def check(self) -> None:
        err = self.err.cpu().numpy()
        if err[0].max() != 0:
            raise RuntimeError(
                f"rle_lanes capacity exhausted on lanes "
                f"{np.nonzero(err[0])[0][:8].tolist()}; raise capacity")
        if err[1].max() != 0:
            raise RuntimeError(
                f"delete ran past the end of the document on lanes "
                f"{np.nonzero(err[1])[0][:8].tolist()}")

    def state(self):
        """(ordp, lenp, rows): the next chunk's ``init`` (stays on the
        device)."""
        return self.ordp, self.lenp, self.rows


def _as_i32(a, dev) -> torch.Tensor:
    """A state array (tensor or numpy, e.g. from a checkpoint) as an int32
    tensor on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=I32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def _pad_rows(a: torch.Tensor, rows: int, fill: int) -> torch.Tensor:
    """``a`` [r, B] padded to ``rows`` rows with ``fill``, on its device."""
    if a.shape[0] >= rows:
        return a
    pad = torch.full((rows - a.shape[0], a.shape[1]), fill, dtype=I32,
                     device=a.device)
    return torch.cat([a, pad], dim=0)


def _grow_planes(state, capacity: int, B: int, dev):
    """Zero-pad a prior chunk's (ordp, lenp, rows) up to this chunk's row
    capacity (run rows pack at the front, so padding is free)."""
    o0, l0, r0 = (_as_i32(a, dev) for a in state)
    _require(o0.shape[0] <= capacity and o0.shape[1] == B,
             f"init state shape {tuple(o0.shape)} incompatible with "
             f"({capacity}, {B})")
    return (_pad_rows(o0, capacity, 0), _pad_rows(l0, capacity, 0),
            r0.reshape(1, B))


def _empty_blocked_state(capacity: int, NBT: int, B: int, dev):
    def z(r):
        return torch.zeros(r, B, dtype=I32, device=dev)

    return (z(capacity), z(capacity), z(1), z(NBT), z(NBT), z(NBT))


def _grow_blocked_state(state, capacity: int, block_k: int, B: int, dev):
    """Pad a prior chunk's blocked 6-tuple up to this chunk's capacity:
    fresh physical blocks append at the end, logical tables zero-pad past
    nlog."""
    o0, l0, nlog, blk, rws, liv = (_as_i32(a, dev) for a in state)
    _require(o0.shape[0] <= capacity and o0.shape[1] == B,
             f"init state shape {tuple(o0.shape)} incompatible with "
             f"({capacity}, {B})")
    _require(o0.shape[0] % block_k == 0,
             f"prior capacity {o0.shape[0]} is not a block_k "
             f"({block_k}) multiple: K must not change between chunks")
    NBT = max(8, capacity // block_k)
    for t in (blk, rws, liv):
        _require(t.shape[0] <= NBT, f"table rows {t.shape[0]} exceed {NBT}")
    return (_pad_rows(o0, capacity, 0), _pad_rows(l0, capacity, 0),
            nlog.reshape(1, B), _pad_rows(blk, NBT, 0),
            _pad_rows(rws, NBT, 0), _pad_rows(liv, NBT, 0))


# -- expansion to per-char state ---------------------------------------------


def _expand_runs(o: np.ndarray, ln: np.ndarray) -> np.ndarray:
    o = o.astype(np.int64)
    ln = ln.astype(np.int64)
    if len(o) == 0:
        return np.zeros(0, np.int32)
    assert (ln > 0).all(), "occupied run with non-positive length"
    total = int(ln.sum())
    base = np.repeat(np.abs(o), ln)
    within = np.arange(total) - np.repeat(np.cumsum(ln) - ln, ln)
    return (np.repeat(np.sign(o), ln) * (base + within)).astype(np.int32)


def expand_lane_blocked(res, doc_index: int) -> np.ndarray:
    """One lane of a blocked result -> per-char ±(order+1) column in doc
    order (walks the logical block table)."""
    res.check()
    K = res.block_k
    ordc = res.ordp[:, doc_index].cpu().numpy()
    lenc = res.lenp[:, doc_index].cpu().numpy()
    blk = res.blkord[:, doc_index].cpu().numpy()
    rows = res.rws[:, doc_index].cpu().numpy()
    nlog = int(res.nlog[0, doc_index])
    o_parts, l_parts = [], []
    for l in range(nlog):
        b, r = int(blk[l]), int(rows[l])
        o_parts.append(ordc[b * K: b * K + r])
        l_parts.append(lenc[b * K: b * K + r])
    if not o_parts:
        return np.zeros(0, np.int32)
    return _expand_runs(np.concatenate(o_parts), np.concatenate(l_parts))


def expand_lane(res, doc_index: int) -> np.ndarray:
    """One lane's run rows -> per-char ±(order+1) column in doc order
    (dispatches on the blocked-layout results too)."""
    if hasattr(res, "blkord"):
        return expand_lane_blocked(res, doc_index)
    res.check()
    r = int(res.rows[0, doc_index])
    return _expand_runs(res.ordp[:r, doc_index].cpu().numpy(),
                        res.lenp[:r, doc_index].cpu().numpy())
