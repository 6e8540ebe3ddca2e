"""Jobs that the port's parallel tests run on every rank of a
``parallel.launch`` world. They import torch and the port only (the ranks
never import JAX), and return numpy results from rank 0.

Each job takes the rank's ``ctx`` first and builds its mesh over the first
``n`` ranks of the world; ranks past the mesh return ``None``.
"""
from __future__ import annotations

import numpy as np

from text_crdt_rust_tpu_torch import convert
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA
from text_crdt_rust_tpu_torch.parallel.mesh import (
    gather_docs,
    make_mesh,
    make_sharded_apply,
    make_sharded_apply_1doc,
    shard_docs,
    shard_ops,
)
from text_crdt_rust_tpu_torch.parallel.sp_apply import SpDoc
from text_crdt_rust_tpu_torch.parallel.sp_runs import make_sp_ops, shard_runs

FIELDS = ("signed", "ol_log", "or_log", "rank_log", "chars_log", "n",
          "next_order")


def doc_to_numpy(doc) -> dict:
    out = {}
    for f in FIELDS:
        v = getattr(doc, f)
        out[f] = (v.cpu().numpy() if hasattr(v, "cpu")
                  else np.asarray(v, np.int64))
    return out


def doc_from_numpy(cols: dict, batched: bool) -> TSA.FlatDoc:
    """A CPU ``FlatDoc`` from numpy columns (u32 columns as their int32
    bits); a single document's counts become ints."""
    import torch

    def t(a):
        a = np.array(a)                 # a writable copy
        if not batched and a.ndim == 0:
            return int(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a.astype(np.int32))

    return TSA.FlatDoc(**{f: t(cols[f]) for f in FIELDS})


def sp_doc_job(ctx, nsp, shard_rows, order_rows, auto_reshard, script):
    """Run ``script`` on a fresh ``SpDoc`` over an ``sp = nsp`` mesh. Each
    entry: ``("load", ordp, lenp)``, ``("tables", oll, orl, rkl)``,
    ``("planes", planes, ol_log, or_log)`` (a JAX ``SpDoc``'s gathered
    state, ``convert.sp_doc_from_numpy``), ``("apply", ops)`` (a
    ``RuntimeError`` is kept as ``("error", msg)``
    and ends the script), ``("read",)`` (planes, expand and origin logs)
    or ``("text",)`` (the content of the streams applied so far). Returns
    the list of each entry's result."""
    mesh = make_mesh(n_devices=nsp, dp=1, sp=nsp, device=ctx.device)
    if not mesh.member:
        return None
    doc = SpDoc(mesh, shard_rows, order_rows, auto_reshard=auto_reshard)
    out, applied = [], []
    for entry in script:
        kind = entry[0]
        if kind == "load":
            doc.load(entry[1], entry[2])
            out.append(None)
        elif kind == "tables":
            doc.load_tables(*entry[1:])
            out.append(None)
        elif kind == "planes":
            convert.sp_doc_from_numpy(doc, *entry[1:])
            out.append(None)
        elif kind == "apply":
            try:
                doc.apply_stream(entry[1])
            except RuntimeError as e:
                out.append(("error", str(e)))
                break
            applied.append(entry[1])
            out.append(("ok", doc.last.steps, doc.last.collectives,
                        doc.reshards))
        elif kind == "text":
            out.append(doc.to_string(applied))
        elif kind == "read":
            out.append({"planes": doc.planes(), "expand": doc.expand(),
                        "dtypes": sorted({str(getattr(doc, k).dtype) for k
                                          in ("ordp", "lenp", "rows", "oll",
                                              "orl", "rkl")}),
                        "ol_log": dict(doc.ol_log),
                        "or_log": dict(doc.or_log)})
        else:
            raise ValueError(kind)
    return out


def sp_runs_job(ctx, nsp, ordp, lenp, ranks, orders):
    """The three ``sp_runs`` lookups over an ``sp = nsp`` mesh: (the
    gathered live prefix, the total, [(row, off) per rank], [position per
    order])."""
    mesh = make_mesh(n_devices=nsp, dp=1, sp=nsp, device=ctx.device)
    if not mesh.member:
        return None
    ops = make_sp_ops(mesh)
    o, ln = shard_runs(ordp, lenp, mesh)
    prefix, total = ops.live_prefix(o, ln)
    prefix = mesh.all_gather(prefix).reshape(-1).cpu().numpy()
    pos = []
    for r in ranks:
        row, off = ops.position_of_live_rank(o, ln, r)
        pos.append((int(row), int(off)))
    return (prefix, int(total), pos,
            [int(ops.order_to_position(o, ln, x)) for x in orders])


def sharded_apply_job(ctx, dp, sp, docs, ops, batched, prefill):
    """``make_sharded_apply`` (or ``_1doc`` when not ``batched``) over a
    ``(dp, sp)`` mesh of the world's first ``dp * sp`` ranks on whole
    numpy ``docs``; returns the whole result as numpy columns."""
    mesh = make_mesh(n_devices=dp * sp, dp=dp, sp=sp, device=ctx.device)
    if not mesh.member:
        return None
    doc = doc_from_numpy(docs, batched)
    fn = (make_sharded_apply if batched else make_sharded_apply_1doc)(
        mesh, prefill=prefill)
    out = fn(shard_docs(doc, mesh, batched), shard_ops(ops, mesh, batched))
    return doc_to_numpy(gather_docs(out, mesh, batched))


def world_size_job(ctx):
    return ctx.world_size


def mesh_job(ctx, n, dp, sp):
    """Every rank's (rank, dp index, sp index, member, the sp group's
    gathered ranks, the dp group's summed ranks, an OR of rank bits)
    gathered to rank 0 (None for ranks past the mesh)."""
    import torch
    import torch.distributed as dist
    mesh = make_mesh(n_devices=n, dp=dp, sp=sp, device=ctx.device)
    me = None
    if mesh.member:
        r = torch.tensor([ctx.rank], dtype=torch.int32)
        me = (ctx.rank, mesh.index("dp"), mesh.index("sp"),
              mesh.all_gather(r, "sp").reshape(-1).tolist(),
              int(mesh.sum(r, "dp")[0]),
              int(mesh.bor(torch.tensor([1 << ctx.rank],
                                        dtype=torch.int32), "sp")[0]))
    out = [None] * ctx.world_size
    dist.all_gather_object(out, me)
    return out


def failing_job(ctx, rank):
    """Raises on ``rank`` only (the others return)."""
    if ctx.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return ctx.rank


def hanging_job(ctx):
    """Rank 0 waits in a collective that the other ranks never join."""
    import torch
    import torch.distributed as dist
    if ctx.rank == 0:
        dist.all_reduce(torch.zeros(1))
    return ctx.rank


def counted_sp_replay(ctx):
    """``sp.sp_replay`` under a dispatch counter: (steps, aten operations,
    host reads) on this rank, after ``sp.sp_prepare``."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    from text_crdt_rust_tpu_torch import sp

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    if "sp" not in ctx.store:           # a rank past the plan's mesh
        return None
    steps = ctx.store["sp"]["ops"].num_steps
    with Count() as c:
        sp.sp_replay(ctx)
    return steps, sum(c.n.values()), c.n["aten._local_scalar_dense"]


SP_OUTPUTS = ("ordp", "lenp", "rows", "oll", "orl", "rkl", "ols", "ors",
              "err")


def sp_kernel_job(ctx, nsp, shard_rows, order_rows, runs, streams,
                  stale=None, reshard=False, tables=None):
    """S1 against the plain version on one ``SpDoc``'s state over an
    ``sp = nsp`` mesh on the card: for each op-column block of
    ``streams`` (int32 ``[9, S]``), ``SpReplay`` (S1: one launch at sp = 1,
    one a segment at sp > 1) and ``SpReplay.plain`` from the same state;
    the plain result is committed when clean (``reshard``: then an even
    reload, so later streams cross shards). ``runs`` loads a document
    first; ``stale`` = (row, ordp, lenp) writes nonzero rows past
    ``rows``; ``tables`` = (oll, orl, rkl) loads by-order tables. Returns
    per stream (error bits, rows a shard, outputs that differ on any rank,
    S1's launches on this rank)."""
    import torch

    from text_crdt_rust_tpu_torch.ops import _kernels

    mesh = make_mesh(n_devices=nsp, dp=1, sp=nsp, device=ctx.device)
    if not mesh.member:
        return None
    doc = SpDoc(mesh, shard_rows, order_rows)
    if runs is not None:
        doc.load(*runs)
    if tables is not None:
        doc.load_tables(*tables)
    if stale is not None:
        at, o, ln = stale
        doc.ordp[at:at + len(o)] = torch.as_tensor(o, dtype=torch.int32)
        doc.lenp[at:at + len(o)] = torch.as_tensor(ln, dtype=torch.int32)
    rep = doc._replay
    out = []
    for cols in streams:
        state = (doc.ordp, doc.lenp, doc.rows, doc.oll, doc.orl, doc.rkl)
        _kernels.reset_launches()
        kern = rep(*state, *cols)
        torch.cuda.synchronize()
        launches = _kernels.launches.get("sp_replay", 0)
        plain = rep.plain(*state, cols)
        mask = sum(1 << i for i, (k, p) in enumerate(zip(kern, plain))
                   if not torch.equal(k.reshape(-1).cpu(),
                                      p.reshape(-1).cpu()))
        mask = int(mesh.bor(torch.tensor([mask], dtype=torch.int32,
                                         device=mesh.device))[0])
        bad = [n for i, n in enumerate(SP_OUTPUTS) if mask >> i & 1]
        rows = mesh.all_gather(plain[2]).reshape(-1).tolist()
        out.append((int(plain[-1]), rows, bad, launches))
        if int(plain[-1]):
            break
        doc.ordp, doc.lenp, doc.rows, doc.oll, doc.orl, doc.rkl = plain[:6]
        if reshard:
            doc.load(*doc.runs())
    return out
