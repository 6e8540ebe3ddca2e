"""The multi-rank dry run (counterpart of ``__graft_entry__.dryrun_multichip``
of the JAX package): the sharded flat apply and the two ``SpDoc`` streams
over a world of ``n`` ranks, each checked against the host oracle.

    python -m text_crdt_rust_tpu_torch.parallel.dryrun --n 4 --backend gloo
        --device cpu

1. ``make_sharded_apply`` on a ``(dp, sp)`` mesh (``sp`` the largest of 4,
   2, 1 dividing ``n``): a batch of ``max(2 dp, 4)`` documents, each
   applying a tiny insert/delete/overwrite stream (F1 on the card); every
   document must read ``"HeLLO, world"``.
2. ``SpDoc`` over ``sp = n``: a local stream (inserts at both ends, a
   delete, an overwrite spanning shards), then a peer's concurrent insert
   and remote delete on the same document.
3. ``SpDoc`` with 88 rows a shard, an order space of 512 split over the
   ``n`` table shards (the JAX dry run's 48 rows a shard hold its stream
   only at ``n`` = 8) and ``auto_reshard``: 120 local patches in chunks of
   20 steps, which overflow shard 0 and force a rebalance; an insert run
   whose table writes cross a table-shard boundary; and remote ops that
   read those entries — the expanded state must equal the oracle's.

``n`` must be at least 2 (one table shard has no boundary to cross).

``dryrun_job`` is the job each rank runs; ``dryrun_multichip`` starts the
world (the caller names the backend and the device, as ``launch`` asks),
runs it and prints rank 0's summary line.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..common import LocalOp, RemoteDel, RemoteId, RemoteIns, RemoteTxn
from ..models.oracle import ListCRDT
from ..ops import _kernels
from ..ops import batch as B
from ..ops import span_arrays as SA
from ..utils.testdata import TestPatch
from . import launch
from .mesh import gather_docs, make_mesh, make_sharded_apply, shard_docs, \
    shard_ops
from .sp_apply import SpDoc

ROOT = RemoteId("ROOT", 0xFFFFFFFF)
#: Orders the third phase's table holds, split over the ``n`` shards.
ORDER_SPACE = 512


def example(batch: int, capacity: int, lmax: int = 4):
    """A tiny but representative stream (inserts, a delete, an overwrite)
    and a batch of documents prefilled for it, on the host (``shard_docs``
    moves each rank's slice to its device)."""
    patches = [TestPatch(0, 0, "hello world"), TestPatch(5, 0, ","),
               TestPatch(2, 3, "LLO"), TestPatch(0, 1, "H")]
    ops, _ = B.compile_local_patches(patches, lmax=lmax)
    base = B.prefill_logs(SA.make_flat_doc(capacity, device="cpu"), ops)
    return SA.stack_docs(base, batch), B.tile_ops(ops, batch)


def _flat_phase(ctx, n: int) -> dict:
    sp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    dp = n // sp
    mesh = make_mesh(n_devices=n, dp=dp, sp=sp, device=ctx.device)
    if not mesh.member:
        return None
    batch = max(dp * 2, 4)
    capacity = max(sp * 16, 64)
    docs, ops = example(batch, capacity)
    # prefill=False: example() prefilled the documents' logs.
    apply = make_sharded_apply(mesh, prefill=False)
    out = gather_docs(apply(shard_docs(docs, mesh), shard_ops(ops, mesh)),
                      mesh)
    texts = {SA.to_string(SA.lane(out, b)) for b in range(batch)}
    if texts != {"HeLLO, world"}:
        raise AssertionError(f"sharded flat apply gave {texts}")
    return dict(dp=dp, sp=sp, batch=batch, capacity=capacity)


def _sp_phase(ctx, n: int) -> dict:
    mesh = make_mesh(n_devices=n, dp=1, sp=n, device=ctx.device)
    if not mesh.member:
        return None
    doc = SpDoc(mesh, shard_rows=32)
    patches = [TestPatch(0, 0, "sequence parallel"), TestPatch(8, 1, "-"),
               TestPatch(0, 0, "sp: "), TestPatch(4, 8, "SEQUENCE")]
    sp_ops, sp_next = B.compile_local_patches(patches, lmax=8, dmax=None)
    doc.apply_stream(sp_ops)
    got = doc.to_string([sp_ops])
    if got != "sp: SEQUENCE-parallel":
        raise AssertionError(f"sp local stream gave {got!r}")
    # The peer appends "!" after (local, 16), the final 'l' of
    # "parallel", then deletes (local, 13..16), "llel".
    table = B.AgentTable(["local"])
    assigner = B.OrderAssigner(table)
    assigner.assign(table.id_of("local"), 0, sp_next)
    table.add("peer")
    rtxns = [RemoteTxn(id=RemoteId("peer", 0), parents=[],
                       ops=[RemoteIns(RemoteId("local", 16), ROOT, "!"),
                            RemoteDel(RemoteId("local", 13), 4)])]
    r_ops, _ = B.compile_remote_txns(rtxns, table, assigner=assigner,
                                     lmax=8, dmax=None)
    doc.apply_stream(r_ops)
    got = doc.to_string([sp_ops, r_ops])
    if got != "sp: SEQUENCE-para!":
        raise AssertionError(f"sp remote stream gave {got!r}")
    return dict(collectives_per_step=doc.last.collectives_per_step)


def _reshard_phase(ctx, n: int) -> dict:
    mesh = make_mesh(n_devices=n, dp=1, sp=n, device=ctx.device)
    if not mesh.member:
        return None
    OTS = -(-ORDER_SPACE // n)
    big = SpDoc(mesh, shard_rows=88, order_rows=OTS, auto_reshard=True)
    oracle = ListCRDT()
    bulk = oracle.get_or_create_agent_id("bulk")
    patches, sim = [], ""
    for i in range(120):
        if i % 4 == 3 and len(sim) >= 3:
            pos = (i * 5) % (len(sim) - 1)
            patches.append(TestPatch(pos, 1, ""))
            sim = sim[:pos] + sim[pos + 1:]
        else:
            pos = (i * 7) % (len(sim) + 1)
            ins = "ab"[i % 2] + "cd"[(i // 2) % 2]
            patches.append(TestPatch(pos, 0, ins))
            sim = sim[:pos] + ins + sim[pos:]
    big_ops, big_next = B.compile_local_patches(patches, lmax=64, dmax=None)
    for p in patches:
        oracle.apply_local_txn(bulk, [LocalOp(pos=p.pos,
                                              ins_content=p.ins_content,
                                              del_span=p.del_len)])
    # 20 steps a chunk (one step a patch here): shard 0's 88 rows
    # overflow and force the rebalance; a failed one would raise.
    for i in range(0, big_ops.num_steps, 20):
        big.apply_stream(B._map_fields(lambda a: np.asarray(a)[i:i + 20],
                                       big_ops))
    rows_now = big.planes()["rows"].tolist()
    if sum(1 for r in rows_now if r > 0) <= 1:
        raise AssertionError(f"reshard never spread rows: {rows_now}")
    # One insert run across the next OTS multiple: its origin-chain
    # table writes land on two owner shards.
    boundary = (big_next // OTS + 1) * OTS
    span = boundary - big_next + 2
    bpos = len(sim) // 2
    b_ops, _ = B.compile_local_patches([TestPatch(bpos, 0, "x" * span)],
                                       lmax=64, dmax=None,
                                       start_order=big_next)
    first = int(b_ops.ins_order_start[0])
    if first // OTS == (first + span - 1) // OTS:
        raise AssertionError("the boundary patch does not cross a table "
                             "shard")
    oracle.apply_local_txn(bulk, [LocalOp(pos=bpos, ins_content="x" * span)])
    big.apply_stream(b_ops)
    # A peer insert whose origin is the char AT the boundary order, and an
    # interval delete across it (seq == order for the one local author).
    btable = B.AgentTable([cd.name for cd in oracle.client_data])
    bassigner = B.OrderAssigner.from_oracle(oracle, btable)
    btable.add("bperr")
    btxn = RemoteTxn(id=RemoteId("bperr", 0), parents=[],
                     ops=[RemoteIns(RemoteId("bulk", boundary), ROOT, "!"),
                          RemoteDel(RemoteId("bulk", boundary - 1), 2)])
    br_ops, _ = B.compile_remote_txns([btxn], btable, assigner=bassigner,
                                      lmax=8, dmax=None)
    oracle.apply_remote_txn(btxn)
    big.apply_stream(br_ops)
    want = [(-1 if oracle.deleted[i] else 1) * (int(oracle.order[i]) + 1)
            for i in range(oracle.n)]
    if big.expand().tolist() != want:
        raise AssertionError("sharded state diverged from the oracle")
    return dict(rows=rows_now, reshards=big.reshards, boundary=boundary,
                orders=(big_next, big_next + span), txns=len(patches) + 1,
                order_rows=OTS)


def dryrun_job(ctx, n: int) -> dict:
    """Every phase on this rank (the world's first ``n`` ranks take part;
    the others only join the process groups); rank 0's summary, with this
    rank's kernel launches and the mesh's collective calls."""
    _check_n(n)
    _kernels.reset_launches()
    flat = _flat_phase(ctx, n)
    sp = _sp_phase(ctx, n)
    big = _reshard_phase(ctx, n)
    mesh = make_mesh(n_devices=n, dp=1, sp=n, device=ctx.device)
    return dict(n=n, backend=ctx.backend, device=str(ctx.device),
                shared_card=ctx.shared_card, flat=flat, sp=sp, reshard=big,
                launches=dict(_kernels.launches),
                sp_calls=dict(mesh.calls))


def summary(out: dict) -> str:
    f, r = out["flat"], out["reshard"]
    return (f"dryrun_multichip OK: mesh(dp={f['dp']}, sp={f['sp']}) over "
            f"{out['n']} ranks ({out['backend']}, {out['device']}), "
            f"batch={f['batch']}, capacity={f['capacity']}; "
            f"sp_apply(sp={out['n']}) local+remote OK; capacity "
            f"{out['n']} x 88 rows: {r['txns']} txns + remote, forced "
            f"reshard OK (rows/shard {r['rows']}), table-shard boundary "
            f"insert OK (orders {r['orders'][0]}..{r['orders'][1]} cross "
            f"table shard {r['orders'][0] // r['order_rows']}->"
            f"{r['boundary'] // r['order_rows']})")


def _check_n(n: int) -> None:
    if n < 2:
        raise ValueError("the dry run needs at least 2 ranks")


def dryrun_multichip(n: int, backend: str, device=None,
                     timeout: float = launch.TIMEOUT) -> dict:
    """Start a world of ``n`` ranks (``backend`` and ``device`` as
    ``parallel.launch`` takes them), run the dry run, stop the world;
    rank 0's summary dict."""
    _check_n(n)
    return launch.run_world(dryrun_job, n, backend, device, n,
                            timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--backend", required=True, choices=("nccl", "gloo"))
    ap.add_argument("--device", default=None,
                    help="cpu, one card to share (cuda:0), or unset: one "
                         "card a rank")
    args = ap.parse_args(argv)
    print(summary(dryrun_multichip(args.n, args.backend, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
