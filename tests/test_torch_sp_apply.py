"""The port's ``SpDoc`` (``parallel/sp_apply.py`` on ``torch.distributed``)
against the JAX package's ``SpDoc`` (``shard_map`` on the virtual CPU
mesh), bit for bit, on ``tests/test_sp_apply.py``'s cases.

The JAX side runs in this process on the first ``nsp`` devices of the
8-device virtual mesh that ``tests/conftest.py`` sets; the port side runs in
a world of gloo CPU ranks from ``parallel/launch.py`` (one world for the
module, started once) at the same ``nsp``, ``R`` and ``OTS``. After every
step of each script the per-shard planes (``ordp``, ``lenp``, ``rows``,
``oll``, ``orl``, ``rkl``), the expanded order column, the origin logs and
a raised error's message must be equal. Tolerance: none (integers).
"""
import dataclasses
import random

import jax
import numpy as np
import pytest

from text_crdt_rust_tpu.common import (
    RemoteDel,
    RemoteId,
    RemoteIns,
    RemoteTxn,
)
from text_crdt_rust_tpu.models.oracle import ListCRDT
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.parallel import make_mesh as jax_make_mesh
from text_crdt_rust_tpu.parallel.sp_apply import SpDoc as JaxSpDoc
from text_crdt_rust_tpu.utils.randedit import random_patches
from text_crdt_rust_tpu.utils.testdata import TestPatch
from text_crdt_rust_tpu_torch import convert
from text_crdt_rust_tpu_torch.parallel.launch import World

import torch_world_jobs as jobs
from test_sp_apply import compile_remote, expected, oracle_signed, sim_runs

#: Ranks of the module's world (the largest nsp of the cases).
WORLD = 4
ROOT = RemoteId("ROOT", 0xFFFFFFFF)
PLANES = ("ordp", "lenp", "rows", "oll", "orl", "rkl")


@pytest.fixture(scope="module")
def world():
    with World(WORLD, "gloo", "cpu", timeout=120) as w:
        yield w


def port_ops(jops):
    return convert.ops_from_numpy(
        {f.name: np.asarray(getattr(jops, f.name))
         for f in dataclasses.fields(jops)})


def jax_script(nsp, R, OTS, auto, script):
    doc = JaxSpDoc(jax_make_mesh(n_devices=nsp, dp=1, sp=nsp), R, OTS,
                   auto_reshard=auto)
    out, applied = [], []
    for entry in script:
        kind = entry[0]
        if kind == "load":
            doc.load(entry[1], entry[2])
            out.append(None)
        elif kind == "tables":
            doc.load_tables(*entry[1:])
            out.append(None)
        elif kind == "apply":
            try:
                doc.apply_stream(entry[1])
            except RuntimeError as e:
                out.append(("error", str(e)))
                break
            applied.append(entry[1])
            out.append(("ok",))
        elif kind == "text":
            out.append(doc.to_string(applied))
        elif kind == "read":
            out.append({
                "planes": {k: np.asarray(getattr(doc, k)) for k in PLANES},
                "expand": doc.expand(), "ol_log": dict(doc.ol_log),
                "or_log": dict(doc.or_log)})
    return out


def padded(ops):
    """``ops`` padded with no-op steps to a multiple of 64 steps, so that
    cases of one geometry share the JAX side's compiled scan."""
    return JB.pad_ops(ops, -(-ops.num_steps // 64) * 64)


def run_both(world, nsp, R, script, OTS=1024, auto=False):
    """The script on both SpDocs (op streams padded, ``padded``); asserts
    every result equal and returns the port's results."""
    script = [(e[0], padded(e[1])) if e[0] == "apply" else e
              for e in script]
    want = jax_script(nsp, R, OTS, auto, script)
    port_script = [(e[0], port_ops(e[1])) if e[0] == "apply" else e
                   for e in script]
    got = world.run(jobs.sp_doc_job, nsp, R, OTS, auto, port_script)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            for k in PLANES:
                np.testing.assert_array_equal(
                    g["planes"][k].astype(np.int32),
                    w["planes"][k].astype(np.int32), err_msg=k)
            np.testing.assert_array_equal(g["expand"], w["expand"])
            assert g["ol_log"] == w["ol_log"]
            assert g["or_log"] == w["or_log"]
        elif isinstance(w, str):
            assert g == w
        elif w is not None:
            assert g[0] == w[0], (g, w)
            if w[0] == "error":
                assert g[1] == w[1]
    return got


def local_ops(patches, lmax=8, start_order=0):
    return JB.compile_local_patches(JB.merge_patches(patches), lmax=lmax,
                                    dmax=None, start_order=start_order)


def table_for(txns):
    table = JB.AgentTable()
    for t in txns:
        table.add(t.id.agent)
        for op in t.ops:
            if hasattr(op, "id"):
                table.add(op.id.agent)
    return table


# -- local edits (TestSpApply) ---------------------------------------------


def test_insert_only_prepends_fresh_doc(world):
    patches = [TestPatch(0, 0, "ab")] * 50
    ops, _ = local_ops(patches)
    got = run_both(world, 4, 128, [("apply", ops), ("read",), ("text",)])
    assert got[0][1] == padded(ops).num_steps
    assert got[2] == expected(patches)


@pytest.mark.parametrize("seed,nsp", [(7, 4), (23, 4), (41, 2)])
def test_loaded_doc_random_stream(world, seed, nsp):
    rng = random.Random(seed)
    p1, c1 = random_patches(rng, 80)
    o1, l1, nxt = sim_runs(p1)
    p2, content = [], c1
    for _ in range(60):
        if not content or rng.random() < 0.5:
            pos = rng.randint(0, len(content))
            ins = "".join(rng.choice("xyz")
                          for _ in range(rng.randint(1, 3)))
            p2.append(TestPatch(pos, 0, ins))
            content = content[:pos] + ins + content[pos:]
        else:
            pos = rng.randint(0, len(content) - 1)
            span = min(rng.randint(1, 3), len(content) - pos)
            p2.append(TestPatch(pos, span, ""))
            content = content[:pos] + content[pos + span:]
    ops2, _ = local_ops(p2, start_order=nxt)
    run_both(world, nsp, 64, [("load", o1, l1), ("read",), ("apply", ops2),
                              ("read",)])


def test_wide_delete_spans_shards(world):
    rng = random.Random(3)
    p1, c1 = random_patches(rng, 80)
    o1, l1, nxt = sim_runs(p1)
    p2 = [TestPatch(2, len(c1) - 4, ""), TestPatch(1, 0, "Q")]
    ops2, _ = local_ops(p2, start_order=nxt)
    got = run_both(world, 4, 64, [("load", o1, l1), ("apply", ops2),
                                  ("read",)])
    assert (got[2]["planes"]["rows"] > 0).sum() == 4


def test_origins_match_jax_and_the_run_replay(world):
    rng = random.Random(9)
    p1, _ = random_patches(rng, 50)
    o1, l1, nxt = sim_runs(p1)
    content = expected(p1)
    p2 = []
    for _ in range(40):
        pos = rng.randint(0, len(content))
        ins = rng.choice(["uv", "w"])
        p2.append(TestPatch(pos, 0, ins))
        content = content[:pos] + ins + content[pos:]
    ops2, _ = JB.compile_local_patches(JB.merge_patches(p2), lmax=8,
                                       dmax=None, start_order=nxt)
    got = run_both(world, 4, 64, [("load", o1, l1), ("apply", ops2),
                                  ("read",)])
    assert len(got[2]["ol_log"]) == int((np.asarray(ops2.ins_len) > 0)
                                        .sum())
    # ... and the single-device run replay's (the port's A1, plain
    # version) over the whole history.
    from text_crdt_rust_tpu_torch.ops import rle as TR
    ops1, _ = JB.compile_local_patches(JB.merge_patches(p1), lmax=8,
                                       dmax=None)
    combined = port_ops(jax.tree.map(
        lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)]),
        ops1, ops2))
    res = TR.replay_local_rle(combined, capacity=256, batch=2, block_k=8,
                              chunk=128, device="cpu")
    ol = res.ol[:, 0].numpy().view(np.uint32)
    orr = res.orr[:, 0].numpy().view(np.uint32)
    starts = np.asarray(combined.ins_order_start, np.int64)
    for s in range(ops1.num_steps, combined.num_steps):
        if combined.ins_len[s] > 0:
            assert got[2]["ol_log"][int(starts[s])] == int(ol[s]), s
            assert got[2]["or_log"][int(starts[s])] == int(orr[s]), s


def test_capacity_error_raises(world):
    patches = [TestPatch(0, 0, "ab"), TestPatch(0, 0, "xy")] * 25
    ops, _ = local_ops(patches)
    got = run_both(world, 4, 8, [("apply", ops)])
    assert got[0][0] == "error" and "capacity" in got[0][1]


def test_bad_delete_raises(world):
    ops, _ = local_ops([TestPatch(0, 0, "ab"), TestPatch(0, 5, "")])
    got = run_both(world, 4, 32, [("apply", ops)])
    assert got[0] == ("error", "delete ran past the end of the document")


def test_auto_reshard_on_capacity(world):
    p1, content = [], ""
    for k in range(6):
        pos = 0 if k % 2 else len(content)
        p1.append(TestPatch(pos, 0, "ab"))
        content = content[:pos] + "ab" + content[pos:]
    ops1, nxt = local_ops(p1)
    p2 = [TestPatch(pos, 0, "Q") for pos in (1, 3, 5, 7, 9, 11)]
    ops2, _ = local_ops(p2, start_order=nxt)
    # 12 rows a shard at sp = 4 (the JAX test's 8 at sp = 8): shard 0
    # overflows before the rebalance and every shard fits after it.
    got = run_both(world, 4, 12, [("apply", ops1), ("read",),
                                  ("apply", ops2), ("read",)], auto=True)
    assert got[1]["planes"]["rows"][0] >= 5
    assert got[2][3] == 1, "the second stream must reshard once"
    ops12, _ = local_ops(p1 + p2)
    got = run_both(world, 4, 12, [("apply", ops12)])
    assert got[0][0] == "error" and "capacity" in got[0][1]


# -- remote ops (TestSpRemote) ---------------------------------------------


def test_concurrent_root_inserts_tiebreak(world):
    txns = [RemoteTxn(id=RemoteId(n, 0), parents=[],
                      ops=[RemoteIns(ROOT, ROOT, t)])
            for n, t in [("zed", "zz"), ("amy", "aa"), ("mia", "mm")]]
    got = run_both(world, 4, 16, [("apply", compile_remote(txns)),
                                  ("read",)])
    oracle = ListCRDT()
    for t in txns:
        oracle.apply_remote_txn(t)
    assert got[1]["expand"].tolist() == oracle_signed(oracle)


def test_order_contiguous_unchained_no_merge(world):
    txns = [RemoteTxn(id=RemoteId(n, 0), parents=[],
                      ops=[RemoteIns(ROOT, ROOT, t)])
            for n, t in [("amy", "a"), ("zed", "z"), ("mid", "m")]]
    got = run_both(world, 2, 16, [("apply", compile_remote(txns)),
                                  ("read",)])
    oracle = ListCRDT()
    for t in txns:
        oracle.apply_remote_txn(t)
    assert oracle.to_string() == "amz"
    assert got[1]["expand"].tolist() == oracle_signed(oracle)


def test_fragmented_and_double_delete(world):
    txns = [
        RemoteTxn(id=RemoteId("amy", 0), parents=[],
                  ops=[RemoteIns(ROOT, ROOT, "abcdef")]),
        RemoteTxn(id=RemoteId("bob", 0), parents=[RemoteId("amy", 5)],
                  ops=[RemoteDel(RemoteId("amy", 1), 3)]),
        RemoteTxn(id=RemoteId("cat", 0), parents=[RemoteId("amy", 5)],
                  ops=[RemoteDel(RemoteId("amy", 2), 3)]),
        RemoteTxn(id=RemoteId("bob", 3), parents=[RemoteId("amy", 5)],
                  ops=[RemoteIns(RemoteId("amy", 2), RemoteId("amy", 3),
                                 "XY")]),
    ]
    run_both(world, 4, 16, [("apply", compile_remote(txns)), ("read",)])


@pytest.mark.parametrize("seed", [21])
def test_two_peer_merge_chunked(world, seed):
    """The two-peer merge streamed in 10-txn chunks with auto_reshard (a
    fresh SpDoc packs every rank into shard 0; the rebalance spreads the
    rows so later chunks' YATA probes cross shards)."""
    from text_crdt_rust_tpu.models.sync import export_txns_since
    from test_device_flat import oracle_from_patches
    from test_device_flat import random_patches as flat_patches

    rng = random.Random(seed)
    pa, _ = flat_patches(rng, 30)
    pb, _ = flat_patches(rng, 30)
    a = oracle_from_patches(pa, agent="peer-a")
    b = oracle_from_patches(pb, agent="peer-b")
    txns = export_txns_since(a, 0) + export_txns_since(b, 0)
    table = table_for(txns)
    chunks, assigner = [], None
    for at in range(0, len(txns), 10):
        ops_c, assigner = JB.compile_remote_txns(
            txns[at:at + 10], table, assigner=assigner, lmax=4, dmax=None)
        chunks.append(ops_c)
    script = [("apply", c) for c in chunks] + [("read",)]
    got = run_both(world, 4, 128, script, auto=True)
    oracle = ListCRDT()
    for t in txns:
        oracle.apply_remote_txn(t)
    assert got[-1]["expand"].tolist() == oracle_signed(oracle)


def test_mixed_local_then_remote_stream(world):
    oracle = ListCRDT()
    me = oracle.get_or_create_agent_id("me")
    oracle.local_insert(me, 0, "hello world")
    oracle.local_delete(me, 2, 3)
    txn = RemoteTxn(id=RemoteId("peer", 0), parents=[],
                    ops=[RemoteIns(ROOT, ROOT, "Q")])
    oracle.apply_remote_txn(txn)
    ops_local, nxt = JB.compile_local_patches(
        [TestPatch(0, 0, "hello world"), TestPatch(2, 3, "")], lmax=16,
        dmax=None)
    table = JB.AgentTable(["me", "peer"])
    assigner = JB.OrderAssigner(table)
    assigner.assign(table.id_of("me"), 0, nxt)
    ops_remote, _ = JB.compile_remote_txns([txn], table, assigner=assigner,
                                           lmax=16, dmax=None)
    combined = jax.tree.map(
        lambda x, y: np.concatenate([np.asarray(x), np.asarray(y)]),
        ops_local, ops_remote)
    got = run_both(world, 4, 32, [("apply", combined), ("read",)])
    assert got[1]["expand"].tolist() == oracle_signed(oracle)


def test_snapshot_load_tables_then_remote(world):
    base = [RemoteTxn(id=RemoteId("amy", 0), parents=[],
                      ops=[RemoteIns(ROOT, ROOT, "hello world")])]
    later = [RemoteTxn(id=RemoteId("bob", 0), parents=[RemoteId("amy", 10)],
                       ops=[RemoteIns(RemoteId("amy", 4),
                                      RemoteId("amy", 5), "XY"),
                            RemoteDel(RemoteId("amy", 0), 3)])]
    table = table_for(base + later)
    ops_base, assigner = JB.compile_remote_txns(base, table, lmax=16,
                                                dmax=None)
    src = run_both(world, 4, 32, [("apply", ops_base), ("read",)])[1]
    planes = src["planes"]
    o = np.concatenate([planes["ordp"].reshape(4, 32)[s, :r]
                        for s, r in enumerate(planes["rows"])])
    ln = np.concatenate([planes["lenp"].reshape(4, 32)[s, :r]
                         for s, r in enumerate(planes["rows"])])
    ops_later, _ = JB.compile_remote_txns(later, table, assigner=assigner,
                                          lmax=16, dmax=None)
    got = run_both(world, 4, 32, [
        ("load", o, ln), ("tables", planes["oll"], planes["orl"],
                          planes["rkl"]),
        ("apply", ops_later), ("read",)])
    oracle = ListCRDT()
    for t in base + later:
        oracle.apply_remote_txn(t)
    assert got[3]["expand"].tolist() == oracle_signed(oracle)


def test_missing_order_raises(world):
    txns = [RemoteTxn(id=RemoteId("a", 0), parents=[],
                      ops=[RemoteIns(ROOT, ROOT, "ab")]),
            RemoteTxn(id=RemoteId("a", 2), parents=[],
                      ops=[RemoteIns(RemoteId("a", 1), ROOT, "cd")])]
    ops = jax.tree.map(lambda a: np.asarray(a).copy(), compile_remote(txns))
    ops.origin_left[1] = 90  # absent order
    got = run_both(world, 4, 16, [("apply", ops)])
    assert got[0][0] == "error" and "order lookup missed" in got[0][1]


def test_remote_storm_with_conflicts(world):
    """A seeded 4-peer storm: concurrent inserts at shared origins, so the
    YATA scan probes past its first item and crosses shards."""
    from text_crdt_rust_tpu.utils.randedit import make_storm

    txns, receiver = make_storm(4, 8, 3, seed=5)
    table = JB.AgentTable(sorted({t.id.agent for t in txns}))
    ops, _ = JB.compile_remote_txns(txns, table, lmax=8, dmax=None)
    got = run_both(world, 4, 96, [("load", np.zeros(0, np.int32),
                                   np.zeros(0, np.int32)),
                                  ("apply", ops), ("read",)])
    assert got[2]["expand"].tolist() == oracle_signed(receiver)
