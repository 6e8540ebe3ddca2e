"""The port's flat engine (plain PyTorch version, on the CPU) against the
JAX package's ``ops/flat.py`` (XLA on the CPU), bit for bit.

The JAX package builds every input (its op compiler, oracle and storm
generator, seeded); ``convert`` carries the streams across. Every
``FlatDoc`` column compares as u32 bit views (``signed`` as int32), with
``n`` and ``next_order``; tolerance none, the state is integers. Cases
mirror ``tests/test_device_flat.py``, ``tests/test_device_prefill.py``
and ``tests/test_serve_train.py``: a trace prefix, seeded local edits,
remote storms with concurrent inserts at one origin (the YATA scan
iterates and backtracks), remote deletes whose target range wraps, a
fuzzed step stream over garbage orders, trains of 1, 2, 4 and 8 ticks
with padded and idle steps, the overflow flag, rank remaps, the
device-prefill path and ``DeviceMirror``. The CUDA kernel's own check
against the plain version is ``tests/test_torch_cuda.py`` (card only).
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_device_flat import oracle_from_patches, random_patches
from text_crdt_rust_tpu.common import RemoteId, RemoteIns, RemoteTxn
from text_crdt_rust_tpu.models.oracle import ListCRDT
from text_crdt_rust_tpu.models.sync import export_txns_since
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import flat as JF
from text_crdt_rust_tpu.ops import span_arrays as JSA
from text_crdt_rust_tpu.utils.randedit import make_storm
from text_crdt_rust_tpu.utils.testdata import (
    flatten_patches,
    load_testing_data,
    trace_path,
)
from text_crdt_rust_tpu_torch import convert
from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch.ops import flat as TF
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA

LOGS = ("ol_log", "or_log", "rank_log", "chars_log")
ROOT = RemoteId("ROOT", 0xFFFFFFFF)


# -- bridges ------------------------------------------------------------------


def jax_cols(doc) -> dict:
    out = {"signed": np.asarray(doc.signed).astype(np.int32)}
    for f in LOGS:
        out[f] = np.asarray(doc.__dict__[f]).astype(np.uint32)
    out["n"] = np.asarray(doc.n).astype(np.int64)
    out["next_order"] = np.asarray(doc.next_order).astype(np.int64)
    return out


def port_cols(doc) -> dict:
    out = {"signed": doc.signed.cpu().numpy().astype(np.int32)}
    for f in LOGS:
        out[f] = getattr(doc, f).cpu().numpy().view(np.uint32)
    out["n"] = np.asarray(torch.as_tensor(doc.n)).astype(np.int64)
    out["next_order"] = (np.asarray(torch.as_tensor(doc.next_order))
                         .astype(np.int64) & 0xFFFF_FFFF)
    return out


def assert_docs_equal(tdoc, jdoc):
    t, j = port_cols(tdoc), jax_cols(jdoc)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def port_doc(jdoc):
    """The port's doc of a JAX doc (batched or not), same bits."""
    c = jax_cols(jdoc)

    def bits(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())

    if c["signed"].ndim == 1:
        return convert.flat_doc_from_numpy(
            {k: np.asarray(getattr(jdoc, k)) for k in
             ("signed",) + LOGS + ("n", "next_order")}, device="cpu")
    return TSA.FlatDoc(
        signed=torch.from_numpy(c["signed"].copy()),
        ol_log=bits(c["ol_log"]), or_log=bits(c["or_log"]),
        rank_log=bits(c["rank_log"]), chars_log=bits(c["chars_log"]),
        n=torch.from_numpy(c["n"].astype(np.int32)),
        next_order=bits(c["next_order"].astype(np.uint32)))


def port_ops(jops):
    return convert.ops_from_numpy(
        {f.name: np.asarray(getattr(jops, f.name))
         for f in dataclasses.fields(jops)})


def jax_batch(docs):
    return jax.tree.map(jnp.array, docs)


# -- streams ------------------------------------------------------------------


def trace_prefix_ops(patches: int = 1000, lmax: int = 16):
    data = load_testing_data(trace_path("sveltecomponent"))
    flat = flatten_patches(data)[:patches]
    ops, _ = JB.compile_local_patches(flat, lmax=lmax)
    return ops


def txns_ops(txns, lmax: int = 8):
    table = JB.AgentTable()
    for t in txns:
        table.add(t.id.agent)
        for op in t.ops:
            if hasattr(op, "id"):
                table.add(op.id.agent)
    ops, _ = JB.compile_remote_txns(txns, table, lmax=lmax)
    return ops


def same_origin_txns(peers: int = 6):
    """Concurrent inserts at one origin, twice: every peer inserts after
    the same item with the same right origin, then again between other
    peers' runs (names out of rank order, so the scan walks past runs and
    the scanning/scan_start backtrack decides)."""
    base = RemoteTxn(id=RemoteId("base", 0), parents=[],
                     ops=[RemoteIns(ROOT, ROOT, "xyz")])
    names = ["pia", "bo", "zed", "amy", "mo", "kai", "lu", "ed"][:peers]
    first = [RemoteTxn(id=RemoteId(nm, 0), parents=[RemoteId("base", 2)],
                       ops=[RemoteIns(RemoteId("base", 0),
                                      RemoteId("base", 1),
                                      nm.upper() * (i % 3 + 1))])
             for i, nm in enumerate(names)]
    seqs = {t.id.agent: len(t.ops[0].ins_content) for t in first}
    second = [RemoteTxn(id=RemoteId(nm, seqs[nm]),
                        parents=[RemoteId(nm, seqs[nm] - 1)],
                        ops=[RemoteIns(RemoteId("base", 0), ROOT,
                                       nm[:1] * 2)])
              for nm in names[::-1]]
    return [base] + first + second


def storm_ops(seed: int, lmax: int = 8):
    txns, _ = make_storm(n_peers=4, rounds=6, run_len=5, seed=seed,
                         del_prob=0.3)
    return txns_ops(txns, lmax=lmax)


def two_peer_ops(seed: int, lmax: int = 4):
    rng = random.Random(seed)
    pa, _ = random_patches(rng, 50)
    pb, _ = random_patches(rng, 50)
    a = oracle_from_patches(pa, agent="peer-a")
    b = oracle_from_patches(pb, agent="peer-b")
    return txns_ops(export_txns_since(a, 0) + export_txns_since(b, 0),
                    lmax=lmax)


def fuzz_stream(seed: int, steps: int, cap: int, lmax: int):
    """Op rows with arbitrary columns: garbage orders (lookups that find no
    row), wrapping delete ranges, ROOT origins, random ranks — the port
    must agree with the JAX program on inputs the compiler never makes."""
    rng = np.random.default_rng(seed)
    u = np.uint32

    def col(lo, hi):
        return rng.integers(lo, hi, steps, dtype=np.int64).astype(u)

    kind = col(0, 3)
    orders = np.where(rng.random(steps) < 0.2, 0xFFFF_FFFF,
                      rng.integers(0, 3 * cap, steps)).astype(u)
    orders2 = np.where(rng.random(steps) < 0.2, 0xFFFF_FFFF,
                       rng.integers(0, 3 * cap, steps)).astype(u)
    ins = col(0, lmax + 1)
    return JB.OpTensors(
        kind=kind, pos=col(0, cap // 4), del_len=col(0, 9),
        del_target=np.where(rng.random(steps) < 0.3,
                            col(0xFFFF_FFF0, 0x1_0000_0000),
                            col(0, 2 * cap)).astype(u),
        origin_left=orders, origin_right=orders2, ins_len=ins,
        ins_order_start=(np.arange(steps) * lmax).astype(u),
        order_advance=ins.copy(), rank=col(0, 5),
        rows_per_step=(ins > 0).astype(u),
        chars=rng.integers(97, 123, (steps, lmax)).astype(u))


# -- single documents ----------------------------------------------------------


def test_local_trace_prefix_apply_ops():
    ops = trace_prefix_ops()
    jdoc = JF.apply_ops(JSA.make_flat_doc(8192, 16384), ops)
    tdoc = TF.apply_ops(TSA.make_flat_doc(8192, 16384, device="cpu"),
                        port_ops(ops))
    assert_docs_equal(tdoc, jdoc)
    assert TSA.to_string(tdoc) == JSA.to_string(jdoc)
    assert TSA.doc_spans(tdoc) == JSA.doc_spans(jdoc)


@pytest.mark.parametrize("case", ["same-origin", "storm-3", "storm-8",
                                  "two-peer"])
def test_remote_streams_apply_ops(case):
    if case == "same-origin":
        ops = txns_ops(same_origin_txns())
    elif case == "two-peer":
        ops = two_peer_ops(3)
    else:
        ops = storm_ops(int(case.split("-")[1]))
    jdoc = JF.apply_ops(JSA.make_flat_doc(512, 1024), ops)
    tdoc = TF.apply_ops(TSA.make_flat_doc(512, 1024, device="cpu"),
                        port_ops(ops))
    assert_docs_equal(tdoc, jdoc)
    assert TSA.doc_spans(tdoc) == JSA.doc_spans(jdoc)


def test_same_origin_scan_backtracks():
    """The case's scan really iterates and sets ``scanning``: the JAX
    result differs from the plain origin cursor (no-scan) placement."""
    ops = txns_ops(same_origin_txns(8))
    jdoc = JF.apply_ops(JSA.make_flat_doc(256, 512), ops)
    oracle = ListCRDT()
    for t in same_origin_txns(8):
        oracle.apply_remote_txn(t)
    assert JSA.to_string(jdoc) == oracle.to_string()
    tdoc = TF.apply_ops(TSA.make_flat_doc(256, 512, device="cpu"),
                        port_ops(ops))
    assert TSA.to_string(tdoc) == oracle.to_string()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_step_by_step_fuzz(seed):
    """``step`` on every row of a fuzzed stream, one document, after every
    step; the doc starts from a real edited state."""
    cap, ocap, lmax = 96, 640, 8
    patches, _ = random_patches(random.Random(seed), 30)
    base_ops, _ = JB.compile_local_patches(patches, lmax=lmax)
    jdoc = JF.apply_ops(JSA.make_flat_doc(cap, ocap), base_ops)
    tdoc = port_doc(jdoc)
    ops = fuzz_stream(seed, 40, cap, lmax)
    ops = dataclasses.replace(
        ops, ins_order_start=(ops.ins_order_start
                              + np.uint32(int(jdoc.next_order))))
    jstep = jax.jit(JF.step)
    for s in range(ops.num_steps):
        row = jax.tree.map(lambda a: np.asarray(a)[s], ops)
        jdoc = jstep(jdoc, row)
        tdoc = TF.step(tdoc, port_ops(row))
        assert_docs_equal(tdoc, jdoc)


def test_remote_delete_target_wraps():
    """``(orders - del_target) < del_len`` is a wrapping u32 compare: a
    target near 2^32 with a long range tombstones the low orders."""
    patches, _ = random_patches(random.Random(9), 20)
    base_ops, _ = JB.compile_local_patches(patches, lmax=8)
    jdoc = JF.apply_ops(JSA.make_flat_doc(128, 256), base_ops)
    tdoc = port_doc(jdoc)
    row = jax.tree.map(lambda a: np.asarray(a)[0], base_ops)
    row = dataclasses.replace(
        row, kind=np.uint32(JB.KIND_REMOTE_DEL),
        del_target=np.uint32(0xFFFF_FFF8), del_len=np.uint32(20),
        ins_len=np.uint32(3), order_advance=np.uint32(1))
    jout = jax.jit(JF.step)(jdoc, row)
    tout = TF.step(tdoc, port_ops(row))
    assert_docs_equal(tout, jout)
    assert (np.asarray(jout.signed)[:12] < 0).sum() > 0


def test_upload_oracle_and_rank_remap():
    patches, _ = random_patches(random.Random(23), 60)
    oracle = oracle_from_patches(patches)
    table = JB.AgentTable(["oracle-agent"])
    jdoc = JSA.upload_oracle(oracle, 512, table.rank_of_agent())
    from text_crdt_rust_tpu_torch.models.oracle import ListCRDT as TList
    from text_crdt_rust_tpu_torch.utils.testdata import TestPatch as TPatch
    toracle = TList()
    a = toracle.get_or_create_agent_id("oracle-agent")
    for p in patches:
        q = TPatch(p.pos, p.del_len, p.ins_content)
        if q.del_len:
            toracle.local_delete(a, q.pos, q.del_len)
        if q.ins_content:
            toracle.local_insert(a, q.pos, q.ins_content)
    tdoc = TSA.upload_oracle(toracle, 512, table.rank_of_agent(),
                             device="cpu")
    assert_docs_equal(tdoc, jdoc)
    mapping = np.array([3, 7, 11], np.uint32)
    jr = JSA.remap_rank_log(jdoc, mapping)
    tr = TSA.remap_rank_log(tdoc, mapping)
    assert_docs_equal(tr, jr)
    # Ranks past the map (and u32 values past 2^31) pass through.
    big = dataclasses.replace(jdoc, rank_log=jdoc.rank_log.at[5].set(
        np.uint32(0x8000_0001)).at[6].set(np.uint32(2)))
    assert_docs_equal(TSA.remap_rank_log(port_doc(big), mapping[:2]),
                      JSA.remap_rank_log(big, mapping[:2]))


# -- batches and trains ----------------------------------------------------------


def ragged_streams(lmax: int = 8):
    streams = [storm_ops(11, lmax), two_peer_ops(4, lmax),
               txns_ops(same_origin_txns(5), lmax)]
    for k in (20, 45):
        patches, _ = random_patches(random.Random(100 + k), k)
        streams.append(JB.compile_local_patches(patches, lmax=lmax)[0])
    return streams


def test_apply_ops_batch_ragged_and_tiled():
    streams = ragged_streams()
    stacked = JB.stack_ops(streams)
    B = len(streams)
    jdocs = jax_batch(JSA.stack_docs(JSA.make_flat_doc(512, 1024), B))
    jout = JF.apply_ops_batch(jdocs, stacked)
    tdocs = TSA.stack_docs(TSA.make_flat_doc(512, 1024, device="cpu"), B)
    tout = TF.apply_ops_batch(tdocs, port_ops(stacked))
    assert_docs_equal(tout, jout)
    tiled = JB.tile_ops(streams[3], 3)
    assert np.array_equal(
        np.asarray(TB.tile_ops(port_ops(streams[3]), 3).chars),
        np.asarray(tiled.chars))
    jdocs3 = jax_batch(JSA.stack_docs(JSA.make_flat_doc(512, 1024), 3))
    tdocs3 = TSA.stack_docs(TSA.make_flat_doc(512, 1024, device="cpu"), 3)
    assert_docs_equal(
        TF.apply_ops_batch(tdocs3, TB.tile_ops(port_ops(streams[3]), 3)),
        JF.apply_ops_batch(jdocs3, tiled))


def _tick_streams(seed: int, ticks: int, lanes: int, lmax: int = 8):
    """Per-tick [S, B] streams cut from per-lane compiled streams, with
    idle lanes, idle ticks and ragged step counts (padded to a common
    bucket as the serve backend pads them)."""
    rng = random.Random(seed)
    per_lane = [storm_ops(seed + b, lmax) if b % 2 else
                JB.compile_local_patches(
                    random_patches(random.Random(seed * 7 + b), 40)[0],
                    lmax=lmax)[0]
                for b in range(lanes)]
    cursors = [0] * lanes
    ticks_out = []
    for t in range(ticks):
        cols = []
        for b in range(lanes):
            s = per_lane[b].num_steps
            take = 0 if rng.random() < 0.25 else rng.randint(1, 6)
            lo, hi = cursors[b], min(s, cursors[b] + take)
            cursors[b] = hi
            cols.append(jax.tree.map(lambda a: np.asarray(a)[lo:hi],
                                     per_lane[b]))
        s_max = max(1, max(c.num_steps for c in cols))
        ticks_out.append(JB.stack_ops([JB.pad_ops(c, s_max)
                                       if c.num_steps else
                                       JB.pad_ops(JB.empty_ops(lmax), s_max)
                                       for c in cols]))
    s_all = max(t.num_steps for t in ticks_out)
    return [JB.pad_ops(t, s_all) for t in ticks_out]


@pytest.mark.parametrize("T", [1, 2, 4, 8])
def test_apply_train_with_prefill_delta(T):
    lanes = 4
    ticks = _tick_streams(T, T, lanes)
    # Idle tail tick (all-zero) as the backend pads short trains.
    ticks.append(jax.tree.map(lambda a: np.zeros_like(np.asarray(a)),
                              ticks[0]))
    train = JB.stack_ticks(ticks)
    deltas = [JB.prefill_delta(t) for t in ticks]
    jd = JB.concat_deltas(deltas)
    td = TB.concat_deltas([TB.prefill_delta(port_ops(t)) for t in ticks])
    for f in TB._DELTA_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(td, f)),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    assert td.bucket == jd.bucket
    tt = TB.stack_ticks([port_ops(t) for t in ticks])
    for f in dataclasses.fields(train):
        np.testing.assert_array_equal(np.asarray(getattr(tt, f.name)),
                                      np.asarray(getattr(train, f.name)))
    jdocs = jax_batch(JSA.stack_docs(JSA.make_flat_doc(256, 1024), lanes))
    jdocs = JF.apply_prefill_delta(jdocs, jd)
    jout, jflag = JF.apply_train(jdocs, train)
    tdocs = TSA.stack_docs(TSA.make_flat_doc(256, 1024, device="cpu"),
                           lanes)
    tdocs = TF.apply_prefill_delta(tdocs, td)
    assert_docs_equal(tdocs, jdocs)
    tout, tflag = TF.apply_train(tdocs, tt)
    assert_docs_equal(tout, jout)
    assert bool(tflag) == bool(jflag) is False


def test_train_skips_steps_idle_on_every_lane():
    """A step idle on every lane is skipped, its ``order_advance``
    included; ``apply_ops_batch`` runs it."""
    tick = _tick_streams(5, 1, 2)[0]
    idle = jax.tree.map(lambda a: np.zeros_like(np.asarray(a)[:1]), tick)
    idle = dataclasses.replace(idle, order_advance=np.full_like(
        np.asarray(idle.order_advance), 5))
    ops = jax.tree.map(lambda a, b: np.concatenate(
        [np.asarray(a), np.asarray(b)]), tick, idle)
    jdocs = jax_batch(JSA.stack_docs(JSA.make_flat_doc(128, 512), 2))
    jdocs = JF.apply_prefill_delta(jdocs, JB.prefill_delta(ops))
    tdocs = port_doc(jdocs)
    jt, _ = JF.apply_train(jdocs, JB.stack_ticks([ops]))
    tt, _ = TF.apply_train(tdocs, TB.stack_ticks([port_ops(ops)]))
    assert_docs_equal(tt, jt)
    jb = JF.apply_ops_batch(jdocs, ops, prefill=False)
    tb = TF.apply_ops_batch(tdocs, port_ops(ops), prefill=False)
    assert_docs_equal(tb, jb)
    assert not np.array_equal(np.asarray(jt.next_order),
                              np.asarray(jb.next_order))


def _insert_tick(i: int, ins: int, lmax: int = 4):
    one = JB.pad_ops(JB.empty_ops(lmax), 1)
    one = dataclasses.replace(
        one, ins_len=np.full((1,), ins, np.uint32),
        order_advance=np.full((1,), ins, np.uint32),
        ins_order_start=np.full((1,), 1 + ins * i, np.uint32),
        rows_per_step=np.ones((1,), np.uint32))
    return JB.stack_ops([one])


@pytest.mark.parametrize("ticks,want", [(2, False), (3, True)])
def test_overflow_flag(ticks, want):
    train = JB.stack_ticks([_insert_tick(i, 4) for i in range(ticks)])
    jdocs = jax_batch(JSA.stack_docs(JSA.make_flat_doc(8, 64), 1))
    jout, jflag = JF.apply_train(jdocs, train)
    tdocs = TSA.stack_docs(TSA.make_flat_doc(8, 64, device="cpu"), 1)
    tout, tflag = TF.apply_train(tdocs, port_ops(train))
    assert bool(jflag) is want and bool(tflag) is want
    assert_docs_equal(tout, jout)


def test_prefill_delta_paths_equal_host_prefill():
    streams = ragged_streams()
    stacked = JB.stack_ops(streams)
    for ops in streams + [stacked]:
        tops = port_ops(ops)
        jd, td = JB.prefill_delta(ops), TB.prefill_delta(tops)
        for f in TB._DELTA_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(td, f)),
                                          np.asarray(getattr(jd, f)))
        assert td.nbytes() == jd.nbytes()
    B = len(streams)
    tdocs = TSA.stack_docs(TSA.make_flat_doc(512, 1024, device="cpu"), B)
    host = TB.prefill_logs(tdocs, port_ops(stacked))
    dev = TF.apply_prefill_delta(tdocs, TB.prefill_delta(port_ops(stacked)))
    jhost = JB.prefill_logs(
        jax_batch(JSA.stack_docs(JSA.make_flat_doc(512, 1024), B)), stacked)
    assert_docs_equal(host, jhost)
    assert_docs_equal(dev, jhost)
    # Unbatched delta broadcast over a batched doc.
    one = port_ops(streams[3])
    bc = TF.apply_prefill_delta(tdocs, TB.prefill_delta(one))
    jbc = JF.apply_prefill_delta(
        jax_batch(JSA.stack_docs(JSA.make_flat_doc(512, 1024), B)),
        JB.prefill_delta(streams[3]))
    assert_docs_equal(bc, jbc)
    assert TB.prefill_delta(port_ops(JB.pad_ops(JB.empty_ops(8), 3))) is None


def test_capacity_contract_refuses_like_the_jax_package():
    ops = trace_prefix_ops(200)
    with pytest.raises(AssertionError, match="capacity") as j:
        JF.apply_ops(JSA.make_flat_doc(32, 4096), ops)
    with pytest.raises(AssertionError, match="capacity") as t:
        TF.apply_ops(TSA.make_flat_doc(32, 4096, device="cpu"),
                     port_ops(ops))
    assert str(t.value) == str(j.value)


def test_kernel_wrapper_refuses_a_capacity_past_shared_memory():
    # One lane's column (the logs stay in device memory) past 227 KB.
    big = TF.SMEM_LIMIT // 4
    assert TF.kernel_smem_bytes(big, 1) > TF.SMEM_LIMIT
    assert TF.kernel_smem_bytes(512) == 4 * 4 * (640 + 512)
    assert TF.kernel_smem_bytes(512, 1) == 4 * (640 + 512)
    d = TSA.stack_docs(TSA.make_flat_doc(big, 64, device="cpu"), 1)
    z = torch.zeros((10, 1, 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"needs \d+ B"):
        TF.flat_replay_cuda(d.signed, d.ol_log, d.or_log, d.rank_log, d.n,
                            d.next_order, z, torch.ones((1, 1), dtype=torch.int32),
                            8)


@pytest.mark.parametrize("cap,lanes", [(512, 4), (16384, 2), (32768, 1)])
def test_kernel_launch_geometry(cap, lanes):
    """Four lanes a block where their columns fit, else two, else one; the
    shared-memory bytes of each; the refusal past one lane's fit."""
    geo = TF.launch_geometry(cap)
    assert geo == TF.Geometry(lanes, 4 * lanes * (640 + cap))
    assert geo.smem <= TF.SMEM_LIMIT
    if lanes < 4:
        assert TF.kernel_smem_bytes(cap, 2 * lanes) > TF.SMEM_LIMIT
    # Capacities round up to 128 rows.
    assert TF.kernel_smem_bytes(cap - 12, lanes) == geo.smem
    # The largest capacity one lane a block takes, and the next refused.
    top = TF.SMEM_LIMIT // 4 - 640
    assert TF.launch_geometry(top // 128 * 128).lanes_per_block == 1
    with pytest.raises(ValueError, match=r"needs \d+ B"):
        TF.launch_geometry(top // 128 * 128 + 1)
    # Past the geometry checks, CPU tensors are refused before any build.
    d = TSA.stack_docs(TSA.make_flat_doc(64, 128, device="cpu"), 2)
    z = torch.zeros((10, 1, 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TF.flat_replay_cuda(d.signed, d.ol_log, d.or_log, d.rank_log, d.n,
                            d.next_order, z,
                            torch.ones((1, 1), dtype=torch.int32), 8)


# -- the kernel's extent rule -------------------------------------------------


def extent_after(extent: torch.Tensor, cursor: torch.Tensor,
                 ilen: torch.Tensor, capacity: int) -> torch.Tensor:
    """``flat_replay.cu``'s rule for a lane's extent E (rows at or past it are
    zero) after a step's splice at ``cursor`` of ``ilen`` rows: unchanged
    when nothing moves (``ilen`` 0 or the cursor past the column); every
    row when ``ilen`` wraps (negative as int32, or ``cursor + ilen`` past
    2^31: the full circular roll); else ``min(CAP, max(E, cursor) +
    ilen)``."""
    run_end = TF._s32(cursor + ilen)
    grown = torch.clamp(torch.maximum(extent, cursor)
                        + torch.clamp(ilen, max=capacity), max=capacity)
    out = torch.where(run_end < cursor, torch.full_like(extent, capacity),
                      grown)
    return torch.where((ilen == 0) | (cursor >= capacity), extent, out)


def _extent_streams(kind: str, cap: int, lanes: int = 4, lmax: int = 16):
    """A ``[S, B]`` port stream of each kind the extent test replays."""
    from text_crdt_rust_tpu_torch.utils import randedit as TR

    if kind == "local":
        streams = [TB.compile_local_patches(TR.random_patches(
            np.random.default_rng(b), 120)[0], lmax=lmax)[0]
            for b in range(lanes)]
    elif kind == "storm":
        streams = []
        for b in range(lanes):
            txns, _ = TR.make_storm(4, 8, 5, seed=b, del_prob=0.3)
            table = TB.AgentTable(sorted({t.id.agent for t in txns}))
            streams.append(TB.compile_remote_txns(txns, table, lmax=lmax)[0])
    elif kind == "fuzz":
        # Garbage columns, every 7th ins_len negative as int32 (the
        # splice's wrapping roll over the whole column), every 11th above
        # lmax, alternately within and past the roll's mask.
        streams = [port_ops(fuzz_stream(b, 60, cap, lmax))
                   for b in range(lanes)]
        for b, o in enumerate(streams):
            o.ins_len = np.asarray(o.ins_len).copy()
            big = o.ins_len[3::11]
            big[:] = np.where(np.arange(big.size) % 2, lmax + 3,
                              3 * lmax + 5)
            o.ins_len[b::7] = np.uint32(0xFFFF_FFF0 + b)
    else:  # over-capacity: inserts past the column's end
        rng = np.random.default_rng(cap)
        steps = cap // lmax + 8
        ins = np.full(steps, lmax, np.uint32)
        streams = [TB.OpTensors(
            kind=np.zeros(steps, np.uint32),
            pos=(rng.integers(0, 3, steps) * (np.arange(steps) * lmax // 2)
                 ).astype(np.uint32),
            del_len=np.zeros(steps, np.uint32),
            del_target=np.zeros(steps, np.uint32),
            origin_left=np.zeros(steps, np.uint32),
            origin_right=np.zeros(steps, np.uint32), ins_len=ins,
            ins_order_start=(np.arange(steps) * lmax).astype(np.uint32),
            order_advance=ins.copy(), rank=np.zeros(steps, np.uint32),
            rows_per_step=np.ones(steps, np.uint32),
            chars=np.full((steps, lmax), 97, np.uint32))
            for _ in range(lanes)]
    s = max(o.num_steps for o in streams)
    return TB.stack_ops([TB.pad_ops(o, s) for o in streams])


@pytest.mark.parametrize("start", ["fresh", "rows-past-n"])
@pytest.mark.parametrize("cap", [256, 512, 4096])
@pytest.mark.parametrize("kind", ["local", "storm", "fuzz", "over-capacity"])
def test_rows_past_the_tracked_extent_stay_zero(kind, cap, start):
    """``flat_replay_plain`` step by step under the kernel's extent rule
    (``extent_after``: E starts as the nonzero extent and follows each
    splice): after every step, every row at or past E is zero, so the
    kernel's passes over [0, E) see every nonzero row. ``rows-past-n``
    starts from a played column with garbage rows written past ``n``."""
    ops = _extent_streams(kind, cap)
    lanes = np.asarray(ops.kind).shape[-1]
    docs = TSA.stack_docs(TSA.make_flat_doc(cap, 8 * cap, device="cpu"),
                          lanes)
    if start == "rows-past-n":
        TF.flat_replay(docs, _extent_streams("local", cap), skip_idle=False)
        rng = np.random.default_rng(cap + 1)
        for b in range(lanes):
            at = min(int(docs.n[b]), cap - 24)
            docs.signed[b, at:at + 24] = torch.from_numpy(
                rng.integers(-500, 500, 24).astype(np.int32))
            docs.n[b] = max(at - 3, 0)
    cols = TF.op_stack(ops)
    active = np.ones(cols.shape[1:3], bool)
    j = torch.arange(cap)[None, :]
    nz = docs.signed != 0
    extent = torch.where(nz.any(dim=1),
                         cap - torch.argmax(nz.flip(1).to(torch.int8), dim=1),
                         torch.zeros(lanes, dtype=torch.int64))
    seen = {"steps": 0, "max": int(extent.max()), "full": 0}

    def on_step(st):
        nonlocal extent
        extent = extent_after(extent, st["cursor"], st["ilen"], cap)
        assert not bool(((st["signed"] != 0) & (j >= extent[:, None])).any())
        seen["steps"] += 1
        seen["max"] = max(seen["max"], int(extent.max()))
        seen["full"] += int((extent == cap).sum())

    flags = TF.flat_replay_plain(docs.signed, docs.ol_log, docs.or_log,
                                 docs.rank_log, docs.n, docs.next_order,
                                 cols, active, ops.lmax, on_step=on_step)
    assert seen["steps"] == cols.shape[2]
    assert seen["max"] > 0
    if kind == "over-capacity":
        assert bool(flags.all()) and seen["full"] > 0


# -- DeviceMirror ---------------------------------------------------------------


def _session_pair(peer_name: str, steps: int, capacity: int,
                  agents=("alice",)):
    """The same peer history through each package's session and mirror,
    delivered four txns a frame as ``test_net_session.clean_sync`` does."""
    from test_net_session import editing_peer
    from text_crdt_rust_tpu.net import codec as JC
    from text_crdt_rust_tpu.net.session import DeviceMirror as JMirror
    from text_crdt_rust_tpu.net.session import ResyncSession as JSession
    from text_crdt_rust_tpu_torch.models.oracle import ListCRDT as TList
    from text_crdt_rust_tpu_torch.net import codec as TC
    from text_crdt_rust_tpu_torch.net.session import DeviceMirror as TMirror
    from text_crdt_rust_tpu_torch.net.session import ResyncSession as TSession

    peer = editing_peer(peer_name, steps=steps)
    jtx = export_txns_since(peer, 0)
    ttx = convert.txns_from_dicts([dataclasses.asdict(t) for t in jtx])
    jm = JMirror(capacity=capacity, agents=agents)
    js = JSession(ListCRDT(), mirror=jm)
    tm = TMirror(capacity=capacity, agents=agents, device="cpu")
    ts = TSession(TList(), mirror=tm)
    for i in range(0, len(jtx), 4):
        js.receive(JC.encode_txns(jtx[i:i + 4]))
        ts.receive(TC.encode_txns(ttx[i:i + 4]))
    assert ts.doc.to_string() == js.doc.to_string()
    return jm, tm, ts


@pytest.mark.parametrize("case", ["tracks", "overflow", "unregistered"])
def test_device_mirror_equals_the_jax_one(case):
    if case == "tracks":
        jm, tm, ts = _session_pair("alice", 10, 256)
        assert not tm.degraded and not jm.degraded
        assert_docs_equal(tm.doc, jm.doc)
        assert TSA.doc_spans(tm.doc) == JSA.doc_spans(jm.doc)
        assert ts.device_doc is tm.doc
        assert ts.counters.get("device_txns_applied") > 0
    else:
        jm, tm, ts = (_session_pair("alice", 10, 8) if case == "overflow"
                      else _session_pair("mallory", 4, 256))
        assert jm.degraded and tm.degraded
        assert tm.degrade_reason == jm.degrade_reason
        assert ts.counters.get("device_degraded") == 1
        assert ts.device_doc is ts.doc


# -- checkpoints and metrics of a FlatDoc --------------------------------------


@pytest.mark.parametrize("batched", [False, True])
def test_flat_checkpoints_cross_load(tmp_path, batched):
    """``save_flat_doc`` writes the JAX package's arrays, dtypes and
    header: each package loads the other's file to the same doc, and a
    corrupted file is refused."""
    from text_crdt_rust_tpu.utils import checkpoint as JCk
    from text_crdt_rust_tpu_torch.utils import checkpoint as TCk

    ops = storm_ops(2)
    jdoc = JF.apply_ops(JSA.make_flat_doc(256, 512), ops)
    if batched:
        jdoc = jax_batch(JSA.stack_docs(jdoc, 3))
    tdoc = port_doc(jdoc)
    TCk.save_flat_doc(tdoc, str(tmp_path / "t.npz"))
    JCk.save_flat_doc(jdoc, str(tmp_path / "j.npz"))
    assert_docs_equal(tdoc, JCk.load_flat_doc(str(tmp_path / "t.npz")))
    back = TCk.load_flat_doc(str(tmp_path / "j.npz"), device="cpu")
    assert_docs_equal(back, jdoc)
    assert isinstance(back.n, int) is not batched
    raw = bytearray((tmp_path / "t.npz").read_bytes())
    raw[len(raw) // 2] ^= 0x10
    (tmp_path / "bad.npz").write_bytes(bytes(raw))
    with pytest.raises(TCk.CheckpointError):
        TCk.load_flat_doc(str(tmp_path / "bad.npz"), device="cpu")


def test_doc_memory_and_run_stats_equal_the_jax_ones(capsys):
    from types import SimpleNamespace

    from text_crdt_rust_tpu.utils import metrics as JM
    from text_crdt_rust_tpu_torch.ops import rle as TR
    from text_crdt_rust_tpu_torch.utils import metrics as TM

    jdoc = JF.apply_ops(JSA.make_flat_doc(512, 1024), two_peer_ops(5))
    tdoc = port_doc(jdoc)
    assert TM.doc_stats(tdoc) == JM.doc_stats(jdoc)
    assert TM.memory_stats(tdoc) == JM.memory_stats(jdoc)
    TM.print_stats(tdoc, detailed=True)
    port_out = capsys.readouterr().out
    JM.print_stats(jdoc, detailed=True)
    assert port_out == capsys.readouterr().out
    patches, _ = random_patches(random.Random(4), 80)
    tops = port_ops(JB.compile_local_patches(patches, lmax=8)[0])
    res = TR.replay_local_rle(tops, 256, batch=2, block_k=16,
                              device="cpu")
    view = SimpleNamespace(block_k=res.block_k, **{
        f: res.__dict__[f].numpy() for f in ("ordp", "lenp", "rows",
                                             "meta", "blkord")})
    assert TM.run_stats(res, 1) == JM.run_stats(view, 1)
