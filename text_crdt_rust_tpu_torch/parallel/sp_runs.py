"""Sequence-parallel RLE runs, the read side: one huge document's run rows
sharded over the mesh's ``sp`` axis (counterpart of
``text_crdt_rust_tpu/parallel/sp_runs.py``).

Rank ``s`` of an ``sp`` group holds rows ``[s*R, (s+1)*R)`` of the run planes
``(±(order+1), len)`` in document order. Each lookup is a shard-local torch
scan on the rank's device plus the mesh's collectives (``parallel/mesh.py``):

- ``live_prefix``: the shard totals are all-gathered (one i32 a shard), so
  every shard knows the live characters before it — the B-tree's internal
  sums (`range_tree/mod.rs:85-93`) with the top levels replaced by the mesh;
- ``position_of_live_rank``: live rank -> (global row, 1-based offset in the
  run); exactly one shard hits, and one sum over the group carries its
  answer to every rank; ``(0, 0)`` when the rank is out of range (a real
  offset is 1-based);
- ``order_to_position``: CRDT order -> live characters strictly before it,
  or -1 when the order is a tombstone or unknown (`cursor.rs:147-190`).

The JAX package psums the hit and the answer apart; here the scalars of one
lookup ride one sum. Every rank of the group calls each lookup with the same
arguments; the answers are replicated.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .mesh import Mesh

I32 = torch.int32


def shard_runs(ordp: np.ndarray, lenp: np.ndarray, mesh: Mesh):
    """This rank's slice of run planes ``[CAP]`` (rows padded with empty
    rows, 0, to a multiple of the ``sp`` size), int32 on the mesh's
    device."""
    sp = mesh.sp
    pad = (-len(ordp)) % sp
    o = np.pad(np.asarray(ordp, np.int32), (0, pad))
    ln = np.pad(np.asarray(lenp, np.int32), (0, pad))
    r = len(o) // sp
    at = mesh.index("sp") * r
    return (torch.from_numpy(o[at:at + r].copy()).to(mesh.device),
            torch.from_numpy(ln[at:at + r].copy()).to(mesh.device))


def cumsum32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum (wraps as the JAX package's i32 cumsum)."""
    return torch.cumsum(x, 0, dtype=I32)


def sum32(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dtype=I32)


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first true entry, 0 when none is (``jnp.argmax`` of a
    bool mask), int64 0-dim."""
    n = mask.shape[0]
    at = torch.where(mask, torch.arange(n, device=mask.device), n).min()
    return torch.where(at == n, 0, at)


def pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for an in-range 0-dim index tensor, as a 0-dim tensor on
    ``x``'s device. ``x[i]`` itself reads ``i`` back to the host (a
    synchronisation on the card); ``index_select`` does not."""
    return x.index_select(0, i.reshape(1)).reshape(())


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for an index as JAX reads a traced one: a negative index
    counts from the end, then the index is clamped into range."""
    n = x.shape[0]
    return pick(x, torch.where(i < 0, i + n, i).clamp(0, n - 1))


def carry_of(mesh: Mesh, total: torch.Tensor):
    """(the sum of the totals of the lower ``sp`` shards, every shard's
    total ``[sp]``) from one all-gather of this shard's ``total``."""
    totals = mesh.all_gather(total.reshape(1)).reshape(-1)
    return sum32(totals[:mesh.index("sp")]), totals


class SpOps:
    """The three sharded lookups of one mesh (``make_sp_ops``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def _scan(self, ordp, lenp):
        lv = torch.where(ordp > 0, lenp, 0)
        local = cumsum32(lv)
        total = local[-1] if local.numel() else torch.zeros(
            (), dtype=I32, device=ordp.device)
        carry, totals = carry_of(self.mesh, total)
        return lv, local, carry, totals

    def live_prefix(self, ordp, lenp):
        """(this shard's rows of the global live prefix ``[R]``, the total
        live characters)."""
        _, local, carry, totals = self._scan(ordp, lenp)
        return local + carry, sum32(totals)

    def position_of_live_rank(self, ordp, lenp, rank1):
        """1-based live rank -> (global row, 1-based offset in that run);
        ``(0, 0)`` when ``rank1`` is past the live total."""
        lv, local, carry, _ = self._scan(ordp, lenp)
        cum = local + carry
        R = ordp.shape[0]
        mine = (carry < rank1) & (rank1 <= cum[-1])
        i_local = sum32(cum < rank1)
        hit = mine & (i_local < R)
        safe = torch.clamp(i_local, max=R - 1)
        row_g = torch.where(hit, self.mesh.index("sp") * R + safe, 0)
        off = torch.where(hit, rank1 - (pick(cum, safe) - pick(lv, safe)),
                          0)
        out = self.mesh.sum(torch.stack([row_g, off]).to(I32))
        return out[0], out[1]

    def order_to_position(self, ordp, lenp, order):
        """Item order -> content position (live characters strictly before
        it); -1 when the item is a tombstone or unknown."""
        lv, local, carry, _ = self._scan(ordp, lenp)
        starts = ordp.abs() - 1
        contains = (ordp != 0) & (starts <= order) & (order < starts + lenp)
        i = first_true(contains)
        hit = contains.any()
        live_run = hit & (pick(ordp, i) > 0)
        before = (carry + pick(local, i) - pick(lv, i)
                  + (order - pick(starts, i)))
        pos = torch.where(live_run, before, -1)
        found = torch.where(hit, pos, 0)
        out = self.mesh.sum(torch.stack([hit.to(I32), found.to(I32)]))
        return torch.where(out[0] > 0, out[1], -1)


@functools.lru_cache(maxsize=16)
def make_sp_ops(mesh: Mesh) -> SpOps:
    """The sharded lookups of ``mesh`` (one object per mesh)."""
    return SpOps(mesh)


__all__ = ["SpOps", "make_sp_ops", "pick", "shard_runs", "take"]
