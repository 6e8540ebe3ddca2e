"""A ``(dp, sp)`` grid of ranks on ``torch.distributed`` (counterpart of
``text_crdt_rust_tpu/parallel/mesh.py``).

The JAX package annotates shardings on a ``jax.sharding.Mesh`` and lets XLA
insert the collectives. Here every rank of a world (``parallel/launch.py``,
or any ``init_process_group`` the caller made) holds its own slice, and the
collectives are explicit calls on the ``Mesh`` object:

- **dp** — independent documents: rank ``(d, s)`` holds batch slice ``d``
  of a document batch;
- **sp** — one document's capacity axis: rank ``(d, s)`` holds capacity
  slice ``s`` (and ``parallel.sp_runs``/``sp_apply`` shard one document's
  run rows over it).

Rank ``r`` of the grid is ``(r // sp, r % sp)``, as ``make_mesh`` of the JAX
package reshapes its device list. ``make_mesh`` makes one process group per
``dp`` row (its ``sp`` group) and one per ``sp`` column (its ``dp`` group);
every rank of the world must call it with the same arguments.

Every collective of the port's parallel layer goes through three helpers,
each counted in ``Mesh.calls``: ``all_gather``, ``sum`` (an all-reduce) and
``bor`` (a bitwise OR of flag words, built from an all-gather: a sum would
collide bits, and NCCL has no bitwise reduction). They take tensors on the
rank's device under either backend: gloo takes CUDA tensors for both
collectives (checked on the card with PyTorch 2.11), so ranks sharing one
card pass their CUDA tensors to gloo as they are.

``make_sharded_apply`` runs the port's flat engine (``ops/flat.py``; F1,
``flat_replay.cu``, on CUDA tensors) on each rank's ``dp`` slice of the
documents. The flat step is not sharded: with ``sp > 1`` the ``sp`` group
all-gathers its capacity slices of every column (``signed`` and the four
by-order logs, one gather) into whole documents, every rank of the group
runs the step on them, and each keeps its own slice. That gather is all
that moves between ranks; the results equal the unsharded step's.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..ops.batch import OpTensors, _map_fields, prefill_logs
from ..ops.flat import _check_capacity, apply_ops, apply_ops_batch
from ..ops.span_arrays import FlatDoc

_COLUMNS = ("signed", "ol_log", "or_log", "rank_log", "chars_log")


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a ``(dp, sp)`` grid and its two process
    groups. ``member`` is false on ranks of the world past ``n_devices``
    (their groups are ``None``; they take no part)."""

    n_devices: int
    dp: int
    sp: int
    rank: int
    device: torch.device
    backend: str
    groups: Dict[str, Optional[dist.ProcessGroup]]
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def member(self) -> bool:
        return self.rank < self.n_devices

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": self.sp}

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.rank // self.sp if axis == "dp" else self.rank % self.sp

    def all_gather(self, x: torch.Tensor, axis: str = "sp") -> torch.Tensor:
        """``x`` of every rank of this rank's ``axis`` group, stacked in
        axis order: ``[size, *x.shape]``."""
        self.calls["all_gather"] += 1
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=self.groups[axis])
        return torch.stack(parts)

    def sum(self, x: torch.Tensor, axis: str = "sp") -> torch.Tensor:
        """Elementwise sum of ``x`` over this rank's ``axis`` group (the
        dtype's own arithmetic: int32 wraps as ``lax.psum`` does)."""
        self.calls["sum"] += 1
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.groups[axis])
        return y

    def bor(self, x: torch.Tensor, axis: str = "sp") -> torch.Tensor:
        """Bitwise OR of the integer ``x`` over this rank's ``axis`` group,
        from one all-gather."""
        g = self.all_gather(x, axis)
        out = g[0]
        for k in range(1, g.shape[0]):
            out = out | g[k]
        return out


_MESHES: Dict[tuple, Mesh] = {}


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              sp: int = 1, device=None) -> Mesh:
    """A ``(dp, sp)`` grid over the first ``n_devices`` ranks of the world
    (default: all of them); ``dp`` defaults to ``n_devices // sp``. Every
    rank of the world must call it, with the same arguments, in the same
    order (process groups are made collectively); a second call with the
    same arguments returns the same ``Mesh``.

    ``device`` is this rank's device: ``None`` means CUDA (the current
    card, which ``launch`` sets to the rank's) and raises without one;
    ``"cpu"`` must be named. The backend is the world's, which its
    caller named."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run it in a "
                           "parallel.launch world or init_process_group "
                           "first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if not 1 <= n_devices <= world:
        raise ValueError(f"n_devices {n_devices} outside 1..{world}")
    if dp is None:
        if n_devices % sp:
            raise ValueError(f"sp={sp} does not divide {n_devices}")
        dp = n_devices // sp
    if dp * sp != n_devices:
        raise ValueError(f"dp({dp}) * sp({sp}) != {n_devices}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (n_devices, dp, sp, str(dev))
    if key in _MESHES:
        return _MESHES[key]
    rank = dist.get_rank()
    groups = {"dp": None, "sp": None}
    for d in range(dp):
        g = dist.new_group([d * sp + s for s in range(sp)])
        if rank < n_devices and rank // sp == d:
            groups["sp"] = g
    for s in range(sp):
        g = dist.new_group([d * sp + s for d in range(dp)])
        if rank < n_devices and rank % sp == s:
            groups["dp"] = g
    mesh = Mesh(n_devices=n_devices, dp=dp, sp=sp, rank=rank, device=dev,
                backend=dist.get_backend(), groups=groups)
    _MESHES[key] = mesh
    return mesh


# -- placing documents and op streams ---------------------------------------


def _slice(n: int, parts: int, at: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} of {n} does not split into {parts} "
                         f"equal slices")
    k = n // parts
    return slice(at * k, (at + 1) * k)


def shard_docs(docs: FlatDoc, mesh: Mesh, batched: bool = True) -> FlatDoc:
    """This rank's slice of a document batch (``batched``: columns
    ``[B, N]`` -> ``[B/dp, N/sp]``, counts ``[B]`` -> ``[B/dp]``) or of one
    document (columns ``[N]`` -> ``[N/sp]``, counts kept), on the mesh's
    device. Every rank passes the same whole documents."""
    sp_i = mesh.index("sp")

    def col(t: torch.Tensor, name: str) -> torch.Tensor:
        cs = _slice(t.shape[-1], mesh.sp, sp_i, name)
        if batched:
            bs = _slice(t.shape[0], mesh.dp, mesh.index("dp"), "batch")
            t = t[bs]
        return t[..., cs].to(mesh.device).clone()

    def count(v):
        if not batched:
            return v
        bs = _slice(v.shape[0], mesh.dp, mesh.index("dp"), "batch")
        return v[bs].to(mesh.device).clone()

    return FlatDoc(**{c: col(getattr(docs, c), c) for c in _COLUMNS},
                   n=count(docs.n), next_order=count(docs.next_order))


def shard_ops(ops: OpTensors, mesh: Mesh, batched: bool = True) -> OpTensors:
    """This rank's slice of a time-major op stream: the doc axis (axis 1)
    over ``dp``; an unbatched stream is every rank's whole."""
    if not batched:
        return ops
    bs = _slice(np.asarray(ops.kind).shape[1], mesh.dp, mesh.index("dp"),
                "batch")
    return _map_fields(lambda a: np.asarray(a)[:, bs], ops)


def _gather_capacity(doc: FlatDoc, mesh: Mesh) -> FlatDoc:
    """Whole documents from the ``sp`` group's capacity slices: one
    all-gather of the five columns side by side."""
    if mesh.sp == 1:
        return doc
    widths = [getattr(doc, c).shape[-1] for c in _COLUMNS]
    packed = torch.cat([getattr(doc, c) for c in _COLUMNS], dim=-1)
    g = mesh.all_gather(packed, "sp")          # [sp, ..., sum(widths)]
    cols, at = {}, 0
    for c, w in zip(_COLUMNS, widths):
        part = g[..., at:at + w]                # [sp, ..., w]
        cols[c] = torch.cat(list(part), dim=-1)
        at += w
    return FlatDoc(**cols, n=doc.n, next_order=doc.next_order)


def _own_slice(doc: FlatDoc, mesh: Mesh) -> FlatDoc:
    """This rank's capacity slice of whole documents."""
    if mesh.sp == 1:
        return doc
    sp_i = mesh.index("sp")
    cols = {c: getattr(doc, c)[..., _slice(getattr(doc, c).shape[-1],
                                           mesh.sp, sp_i, c)].clone()
            for c in _COLUMNS}
    return FlatDoc(**cols, n=doc.n, next_order=doc.next_order)


def gather_docs(doc: FlatDoc, mesh: Mesh, batched: bool = True) -> FlatDoc:
    """The whole batch (or document) from every rank's slice, on every
    rank: the inverse of ``shard_docs`` (a host read-back; every rank of
    the mesh must call it)."""
    whole = _gather_capacity(doc, mesh)
    if not batched or mesh.dp == 1:
        return whole
    cols = {c: torch.cat(list(mesh.all_gather(getattr(whole, c), "dp")))
            for c in _COLUMNS}
    counts = {k: torch.cat(list(mesh.all_gather(getattr(whole, k), "dp")))
              for k in ("n", "next_order")}
    return FlatDoc(**cols, **counts)


def make_sharded_apply(mesh: Mesh, prefill: bool = True):
    """The multi-rank apply of a document batch (the JAX package's one
    pjit over the mesh): returns ``apply(docs, ops) -> docs``, where
    ``docs`` is this rank's ``shard_docs`` slice and ``ops`` its
    ``shard_ops`` slice (time-major ``[S, B/dp, ...]``).

    The ``sp`` group gathers whole documents (the module docstring), checks
    the capacity contract (``ops.flat._check_capacity``), prefills the
    by-order logs with ``batch.prefill_logs`` when ``prefill`` (a fresh
    ``make_flat_doc`` applied without them gives wrong results, not a
    crash; pass ``prefill=False`` only for docs already prefilled for this
    stream), runs ``ops.flat.apply_ops_batch`` (one launch of F1 on the
    card) and returns this rank's slice of the result."""
    def apply(docs: FlatDoc, ops: OpTensors) -> FlatDoc:
        whole = _gather_capacity(docs, mesh)
        _check_capacity(whole, ops)
        if prefill:
            whole = prefill_logs(whole, ops)
        return _own_slice(apply_ops_batch(whole, ops, prefill=False), mesh)

    return apply


def make_sharded_apply_1doc(mesh: Mesh, prefill: bool = True):
    """The apply of ONE document whose capacity axis is sharded over
    ``sp`` (``shard_docs(..., batched=False)``), replicated over ``dp``;
    ``prefill`` as in ``make_sharded_apply``. Returns ``apply(doc, ops)``
    with ``ops`` unbatched ``[S, ...]``; the result's counts are ints."""
    def apply(doc: FlatDoc, ops: OpTensors) -> FlatDoc:
        whole = _gather_capacity(doc, mesh)
        _check_capacity(whole, ops)
        if prefill:
            whole = prefill_logs(whole, ops)
        return _own_slice(apply_ops(whole, ops, prefill=False), mesh)

    return apply


__all__ = ["Mesh", "gather_docs", "make_mesh", "make_sharded_apply",
           "make_sharded_apply_1doc", "shard_docs", "shard_ops"]
