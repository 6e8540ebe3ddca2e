"""The port's parallel layer on ``torch.distributed`` against the JAX
package's on the virtual CPU mesh: ``launch`` (worlds, failures, time
limits), ``mesh`` (the ``(dp, sp)`` grid, its collectives, the sharded flat
apply), ``sp_runs`` (the sharded run lookups) and the dry run.

The JAX side runs in this process on the 8-device virtual mesh that
``tests/conftest.py`` sets; the port side in one world of 8 gloo CPU ranks
from ``parallel/launch.py`` (started once for the module), at the same
``(dp, sp)``. Results are compared bit for bit (u32 columns through their
bits). Tolerance: none (integers).
"""
import dataclasses
import random

import numpy as np
import pytest

from text_crdt_rust_tpu.models.oracle import ListCRDT
from text_crdt_rust_tpu.models.sync import export_txns_since
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import span_arrays as JSA
from text_crdt_rust_tpu.parallel import make_mesh as jax_make_mesh
from text_crdt_rust_tpu.parallel import make_sharded_apply as jax_apply
from text_crdt_rust_tpu.parallel import shard_docs as jax_shard_docs
from text_crdt_rust_tpu.parallel import shard_ops as jax_shard_ops
from text_crdt_rust_tpu.parallel.mesh import \
    make_sharded_apply_1doc as jax_apply_1doc
from text_crdt_rust_tpu.parallel.sp_runs import make_sp_ops as jax_sp_ops
from text_crdt_rust_tpu.parallel.sp_runs import shard_runs as jax_shard_runs
from text_crdt_rust_tpu.utils.testdata import (
    flatten_patches,
    load_testing_data,
    trace_path,
)
from text_crdt_rust_tpu_torch import convert
from text_crdt_rust_tpu_torch import sp as TSP
from text_crdt_rust_tpu_torch.config import MeshConfig
from text_crdt_rust_tpu_torch.parallel import dryrun
from text_crdt_rust_tpu_torch.parallel.launch import World, rank_device

import torch_world_jobs as jobs
from test_device_flat import oracle_from_patches, random_patches
from test_sp_runs import runs_from_patches

WORLD = 8
FIELDS = jobs.FIELDS


@pytest.fixture(scope="module")
def world():
    with World(WORLD, "gloo", "cpu", timeout=120) as w:
        yield w


def port_ops(jops):
    return convert.ops_from_numpy(
        {f.name: np.asarray(getattr(jops, f.name))
         for f in dataclasses.fields(jops)})


def doc_numpy(doc):
    return {f: np.asarray(getattr(doc, f)) for f in FIELDS}


def bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype in (np.int32, np.uint32) \
        else a.astype(np.int64)


def assert_docs_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(bits(got[f]), bits(want[f]),
                                      err_msg=f)


def sharded_both(world, dp, sp, docs, ops, batched=True, prefill=True):
    """The JAX sharded apply on a (dp, sp) mesh and the port's on the
    world's first dp * sp ranks; asserts them equal, returns the port's."""
    mesh = jax_make_mesh(n_devices=dp * sp, dp=dp, sp=sp)
    if batched:
        fn = jax_apply(mesh, donate=False, prefill=prefill)
    else:
        fn = jax_apply_1doc(mesh, prefill=prefill)
    want = doc_numpy(fn(jax_shard_docs(docs, mesh, batched),
                        jax_shard_ops(ops, mesh, batched)))
    got = world.run(jobs.sharded_apply_job, dp, sp, doc_numpy(docs),
                    port_ops(ops), batched, prefill)
    assert_docs_equal(got, want)
    return got


def text_of(cols, b=None):
    one = {f: (cols[f][b] if b is not None else cols[f]) for f in FIELDS}
    return JSA.to_string(JSA.FlatDoc(**one))


# -- launch ---------------------------------------------------------------------


def test_rank_devices_follow_the_caller():
    assert str(rank_device(3, 4, "nccl")) == "cuda:3"
    assert str(rank_device(2, 4, "gloo", "cpu")) == "cpu"
    assert str(rank_device(2, 4, "gloo", "cuda:0")) == "cuda:0"
    with pytest.raises(ValueError):
        rank_device(0, 2, "gloo")          # gloo needs a named device
    with pytest.raises(ValueError):
        rank_device(0, 2, "nccl", "cpu")   # NCCL takes no CPU ranks
    with pytest.raises(ValueError):
        rank_device(0, 2, "nccl", "cuda:0")  # two NCCL ranks, one card
    with pytest.raises(ValueError):
        rank_device(0, 1, "mpi", "cpu")


def test_world_refuses_cards_it_lacks():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        World(2, "nccl")


def test_world_failure_and_time_limit():
    with World(2, "gloo", "cpu", timeout=60) as w:
        with pytest.raises(RuntimeError, match="fails on purpose"):
            w.run(jobs.failing_job, 1)
        assert not w.alive
        # The next job starts a fresh world; a rank stuck in a collective
        # there: the world is killed at the limit.
        with pytest.raises(TimeoutError, match="every rank was killed"):
            w.run(jobs.hanging_job, timeout=3)
        assert not w.alive
        assert w.starts == 2


# -- mesh ------------------------------------------------------------------------


@pytest.mark.parametrize("n,dp,sp", [(8, 2, 4), (8, 8, 1), (6, 3, 2)])
def test_mesh_grid_and_collectives(world, n, dp, sp):
    out = world.run(jobs.mesh_job, n, dp, sp)
    jm = jax_make_mesh(n_devices=n, dp=dp, sp=sp)
    grid = np.vectorize(lambda d: d.id)(jm.devices)
    for rank, me in enumerate(out):
        if rank >= n:
            assert me is None
            continue
        r, d, s, sp_ranks, dp_sum, bor = me
        assert grid[d, s] == r
        assert sp_ranks == grid[d].tolist()
        assert dp_sum == int(grid[:, s].sum())
        assert bor == sum(1 << x for x in grid[d].tolist())


def test_mesh_config_resolves_as_jax():
    from text_crdt_rust_tpu.config import MeshConfig as JaxMeshConfig
    for kw in ({}, {"sp": 4}, {"n_devices": 6, "sp": 2},
               {"n_devices": 8, "dp": 2, "sp": 4}):
        assert MeshConfig(**kw).resolved() == JaxMeshConfig(**kw).resolved()


# -- the sharded flat apply ----------------------------------------------------------


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 4)])
def test_sharded_batch_matches_jax(world, dp, sp):
    rng = random.Random(31)
    patches, content = random_patches(rng, 40)
    ops, _ = JB.compile_local_patches(patches, lmax=4)
    batch = 8
    docs = JSA.stack_docs(JB.prefill_logs(JSA.make_flat_doc(256), ops), batch)
    got = sharded_both(world, dp, sp, docs, JB.tile_ops(ops, batch))
    assert {text_of(got, b) for b in range(batch)} == {content}


def test_fresh_docs_without_manual_prefill(world):
    rng = random.Random(61)
    patches, content = random_patches(rng, 30)
    ops, _ = JB.compile_local_patches(patches, lmax=4)
    docs = JSA.stack_docs(JSA.make_flat_doc(256), 8)
    got = sharded_both(world, 4, 2, docs, JB.tile_ops(ops, 8))
    assert text_of(got, 0) == content


def test_seq_parallel_one_doc(world):
    rng = random.Random(41)
    patches, content = random_patches(rng, 60)
    ops, _ = JB.compile_local_patches(patches, lmax=4)
    doc = JB.prefill_logs(JSA.make_flat_doc(512), ops)
    got = sharded_both(world, 1, 8, doc, ops, batched=False)
    assert text_of(got) == content


def test_sp_doc_items_span_shards(world):
    rng = random.Random(73)
    patches, content = random_patches(rng, 400)
    assert len(content) > 1024 // 8
    ops, _ = JB.compile_local_patches(patches, lmax=4)
    doc = JB.prefill_logs(JSA.make_flat_doc(1024, 4096), ops)
    got = sharded_both(world, 1, 8, doc, ops, batched=False)
    oracle = oracle_from_patches(patches)
    assert text_of(got) == content == oracle.to_string()


def test_remote_ops_sharded(world):
    rng = random.Random(51)
    pa, _ = random_patches(rng, 30)
    pb, _ = random_patches(rng, 30)
    a = oracle_from_patches(pa, agent="peer-a")
    b = oracle_from_patches(pb, agent="peer-b")
    txns = export_txns_since(a, 0) + export_txns_since(b, 0)
    oracle = ListCRDT()
    for t in txns:
        oracle.apply_remote_txn(t)
    ops, _ = JB.compile_remote_txns(txns, JB.AgentTable(["peer-a", "peer-b"]),
                                    lmax=4)
    docs = JSA.stack_docs(JB.prefill_logs(JSA.make_flat_doc(512), ops), 4)
    got = sharded_both(world, 4, 2, docs, JB.tile_ops(ops, 4))
    assert {text_of(got, i) for i in range(4)} == {oracle.to_string()}


def test_sharded_remote_storm(world):
    from text_crdt_rust_tpu.utils.randedit import make_storm
    txns, receiver = make_storm(4, 20, 3, seed=11)
    table = JB.AgentTable(sorted({t.id.agent for t in txns}))
    ops, _ = JB.compile_remote_txns(txns, table, lmax=8)
    docs = JSA.stack_docs(JSA.make_flat_doc(1024), 4)
    got = sharded_both(world, 4, 2, docs, JB.tile_ops(ops, 4))
    assert {text_of(got, i) for i in range(4)} == {receiver.to_string()}


def test_sharded_trace_prefix(world):
    data = load_testing_data(trace_path("automerge-paper"))
    patches = flatten_patches(data)[:300]
    want = ""
    for p in patches:
        want = want[:p.pos] + p.ins_content + want[p.pos + p.del_len:]
    ops, _ = JB.compile_local_patches(patches, lmax=8)
    docs = JSA.stack_docs(JSA.make_flat_doc(1024), 4)
    got = sharded_both(world, 2, 4, docs, JB.tile_ops(ops, 4))
    assert {text_of(got, i) for i in range(4)} == {want}


# -- sp_runs --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def svelte_runs():
    data = load_testing_data(trace_path("sveltecomponent"))
    return runs_from_patches(flatten_patches(data)[:1200])


@pytest.mark.parametrize("nsp", [8, 3])
def test_sp_runs_match_jax(world, svelte_runs, nsp):
    ordp, lenp = svelte_runs
    total = int(np.where(ordp > 0, lenp, 0).sum())
    rng = random.Random(3)
    ranks = sorted(rng.sample(range(1, total + 1), 40)) + [1, total,
                                                          total + 1]
    starts = np.abs(ordp.astype(np.int64)) - 1
    orders = rng.sample(range(int((starts + lenp).max())), 40) \
        + [10 ** 8, int(starts[0])]
    mesh = jax_make_mesh(n_devices=nsp, dp=1, sp=nsp)
    ops = jax_sp_ops(mesh)
    o_dev, l_dev = jax_shard_runs(ordp, lenp, mesh)
    prefix, jtotal = ops.live_prefix(o_dev, l_dev)
    want_pos = [tuple(int(x) for x in ops.position_of_live_rank(
        o_dev, l_dev, r)) for r in ranks]
    want_ord = [int(ops.order_to_position(o_dev, l_dev, x)) for x in orders]

    got_prefix, got_total, got_pos, got_ord = world.run(
        jobs.sp_runs_job, nsp, ordp, lenp, ranks, orders)
    assert got_total == int(jtotal) == total
    np.testing.assert_array_equal(got_prefix, np.asarray(prefix))
    assert got_pos == want_pos
    assert got_ord == want_ord
    assert got_pos[-1] == (0, 0)          # out of range: the (0, 0) sentinel
    assert got_ord[-2] == -1              # unknown order


# -- config sp and the dry run -----------------------------------------------------


def test_dry_run_on_the_world(world):
    out = world.run(dryrun.dryrun_job, 8)
    assert out["flat"] == dict(dp=2, sp=4, batch=4, capacity=64)
    assert out["reshard"]["reshards"] >= 1
    assert "dryrun_multichip OK" in dryrun.summary(out)
    assert out["sp_calls"]["all_gather"] > 0


def test_dry_run_entry_point_needs_two_ranks():
    with pytest.raises(ValueError, match="at least 2 ranks"):
        dryrun.dryrun_multichip(1, "gloo", "cpu")


def test_config_sp_run_on_the_world(world):
    """``sp.run_sp`` on a trace prefix at sp = 4 sized to reshard, in the
    module's world: the text, the native engine and the run replay (A1's
    plain version here) agree, and so does a run at sp = 1."""
    plan4 = TSP.plan_sp(1500, 4, slack=1.0)
    run4 = TSP.run_sp(backend="gloo", device="cpu", world=world, plan=plan4)
    assert run4.ok and run4.parity_ok, run4.summary()
    assert run4.replay["reshards"] >= 1
    run1 = TSP.run_sp(1500, 1, backend="gloo", device="cpu", parity=False,
                      world=world)
    assert run1.ok
    # A plan sets the world's size when run_sp starts its own world.
    run2 = TSP.run_sp(backend="gloo", device="cpu", parity=False,
                      plan=TSP.plan_sp(1500, 2))
    assert run2.ok and run2.shape is not None
    np.testing.assert_array_equal(run2.read["expand"], run4.read["expand"])
    np.testing.assert_array_equal(run1.read["expand"], run4.read["expand"])
    s = run4.summary()
    assert s["sp"] == 4 and s["collectives_per_step"] > 0


def test_sp_replay_reads_the_host_once_a_chunk(world):
    """The replay issues its operations without reading a value back to
    the host on any step (``x[i]`` with a tensor index would, on the card
    a synchronisation): one read a chunk, its error word. Prints the
    operations a step (a dispatch count, on one rank)."""
    plan = TSP.plan_sp(5000, 1)
    world.run(TSP.sp_prepare, plan)
    steps, ops, reads = world.run(jobs.counted_sp_replay)
    print(f"sp = 1, {plan.patches} patches: {steps} steps, "
          f"{ops / steps:.1f} aten operations a step, {reads} host reads")
    assert reads == plan.chunks
    assert ops / steps < 260
