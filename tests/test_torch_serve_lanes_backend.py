"""The port's serve lanes backend (A7's plain version on the CPU) against
the JAX package's (A7 in Pallas interpret mode), bit for bit.

Every scenario drives a JAX ``DocServer`` and a port ``DocServer`` with the
same calls (the JAX package's own cases of
``tests/test_serve_lanes_backend.py``: local and remote ticks, an
evict/restore mid-stream, block splits with a rank remap, a reseed after
splits, run-row overflow, replace steps), and after every ``apply`` of
every backend compares the carried 11-tuple, the host mirrors (rank
table, run-row bound, fresh-lane marks), every resident lane's
``lane_signed`` and every ``fits_doc``/``tick_fits`` answer given so far.
The direct cases drive the two backends through uploads, ticks, remaps
and clears, and carry a JAX backend's state into the port's.

One kernel geometry for the whole file (4 lanes, capacity 128, K = 8,
OCAP 512, buckets (8, 32)) keeps the JAX side to a few compiles.
"""
import dataclasses

import numpy as np
import pytest

from text_crdt_rust_tpu.common import RemoteId as JRid
from text_crdt_rust_tpu.common import RemoteIns as JIns
from text_crdt_rust_tpu.common import RemoteTxn as JTxn
from text_crdt_rust_tpu.config import ServeConfig as JServeConfig
from text_crdt_rust_tpu.models.oracle import ListCRDT as JListCRDT
from text_crdt_rust_tpu.models.sync import export_txns_since
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.serve.batcher import make_lane_backend as j_make
from text_crdt_rust_tpu.serve.server import DocServer as JDocServer
from text_crdt_rust_tpu.utils.testdata import TestPatch as JPatch
from text_crdt_rust_tpu_torch.config import ServeConfig as TServeConfig
from text_crdt_rust_tpu_torch.convert import (
    lane_backend_from_numpy,
    lane_backend_to_numpy,
    ops_from_numpy,
    txns_from_dicts,
)
from text_crdt_rust_tpu_torch.models.oracle import ListCRDT as TListCRDT
from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch.serve.batcher import make_lane_backend as t_make
from text_crdt_rust_tpu_torch.serve.batcher import oracle_signed
from text_crdt_rust_tpu_torch.serve.lanes_backend import LanesMixedLaneBackend
from text_crdt_rust_tpu_torch.serve.server import DocServer as TDocServer

GEOMETRY = dict(engine="rle-lanes-mixed", num_shards=1, lanes_per_shard=4,
                lane_capacity=128, lanes_block_k=8, order_capacity=512,
                step_buckets=(8, 32), max_txn_len=32)
BACKEND = dict(lanes=4, capacity=128, order_capacity=512, lmax=4, block_k=8)
ROOT = ("ROOT", 0xFFFFFFFF)


def _port_txns(txns):
    return txns_from_dicts([dataclasses.asdict(t) for t in txns])


def _snapshot(backend) -> dict:
    snap = lane_backend_to_numpy(backend)
    snap.pop("prev_rows", None)
    snap["lanes"] = {b: backend.lane_signed(b) for b in range(backend.lanes)}
    return snap


def _assert_same(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys(), what
    for k in a:
        if k == "lanes":
            for lane in a[k]:
                assert np.array_equal(a[k][lane], b[k][lane]), \
                    f"{what}: lane {lane} lane_signed"
        else:
            assert np.array_equal(a[k], b[k]), f"{what}: {k}"


def _record(backend, log: list) -> None:
    """Log every apply's resulting state and every capacity answer."""
    apply, tick_fits, fits_doc = (backend.apply, backend.tick_fits,
                                  backend.fits_doc)

    def rec_apply(stacked):
        apply(stacked)
        log.append(("apply", _snapshot(backend)))

    def rec_tick_fits(b, oracle, stream):
        out = tick_fits(b, oracle, stream)
        log.append(("tick_fits", b, out))
        return out

    def rec_fits_doc(oracle):
        out = fits_doc(oracle)
        log.append(("fits_doc", out))
        return out

    backend.apply = rec_apply
    backend.tick_fits = rec_tick_fits
    backend.fits_doc = rec_fits_doc


class Twin:
    """A JAX and a port ``DocServer`` driven alike; ``tick`` compares
    every apply and capacity answer since the last check."""

    def __init__(self, tmp_path, **kw):
        cfg = dict(GEOMETRY, **kw)
        self.j = JDocServer(JServeConfig(spool_dir=str(tmp_path / "j"),
                                         **cfg))
        self.t = TDocServer(TServeConfig(spool_dir=str(tmp_path / "t"),
                                         **cfg), device="cpu")
        self.logs = ([], [])
        for srv, log in zip((self.j, self.t), self.logs):
            for b in srv.residency.backends:
                _record(b, log)
        self.applies = 0

    def admit(self, doc_id):
        self.j.admit_doc(doc_id)
        self.t.admit_doc(doc_id)

    def local(self, doc_id, agent, pos, del_len=0, ins=""):
        self.j.submit_local(doc_id, agent, pos, del_len, ins)
        self.t.submit_local(doc_id, agent, pos, del_len, ins)

    def txns(self, doc_id, jtxns):
        for jt, tt in zip(jtxns, _port_txns(jtxns)):
            self.j.submit_txn(doc_id, jt)
            self.t.submit_txn(doc_id, tt)

    def evict(self, doc_id):
        for srv in (self.j, self.t):
            srv.residency.evict(srv.doc_state(doc_id))

    def check(self):
        jl, tl = self.logs
        assert len(jl) == len(tl)
        for i, (a, b) in enumerate(zip(jl, tl)):
            assert a[0] == b[0], i
            if a[0] == "apply":
                _assert_same(a[1], b[1], f"apply {self.applies}")
                self.applies += 1
            else:
                assert a == b, i
        jl.clear()
        tl.clear()
        for doc_id in self.t.router.docs:
            jd, td = self.j.doc_state(doc_id), self.t.doc_state(doc_id)
            assert (jd.lane, jd.resident, jd.degraded) == \
                (td.lane, td.resident, td.degraded), doc_id
            assert self.t.verify_doc(doc_id), doc_id

    def tick(self):
        self.j.tick()
        self.t.tick()
        self.check()

    def drain(self, max_ticks=64):
        self.j.drain(max_ticks)
        self.t.drain(max_ticks)
        self.check()

    def finish(self):
        self.drain()
        for doc_id in self.t.router.docs:
            assert self.t.doc_string(doc_id) == self.j.doc_string(doc_id)
            assert self.t.doc_digest(doc_id) == self.j.doc_digest(doc_id)
        tb = self.t.residency.backends[0]
        assert tb.shapes_seen == self.j.residency.backends[0].shapes_seen
        assert self.applies > 0


def _fragment(tw, doc_id, edits=14):
    """Single-char prepends (each its own run) until the lane's blocks
    split and the split forward pointers arm."""
    for i in range(edits):
        tw.local(doc_id, "ed", 0, ins="abcdefgh"[i % 8])
        tw.tick()


def scenario_mixed_local_remote(tw):
    for i in range(3):
        tw.admit(f"d{i}")
    peer = JListCRDT()
    pa = peer.get_or_create_agent_id("peer")
    mark = 0
    for step in range(6):
        for i in range(3):
            tw.local(f"d{i}", "ed", 0, ins=f"s{step}")
        peer.local_insert(pa, len(peer), "pq")
        if step % 2:
            peer.local_delete(pa, 0, 1)
        tw.txns("d0", export_txns_since(peer, mark))
        mark = peer.get_next_order()
        tw.tick()


def scenario_evict_restore_replay(tw):
    src = JListCRDT()
    a = src.get_or_create_agent_id("amy")
    mark, chunks = 0, []
    for i in range(8):
        src.local_insert(a, len(src) // 2, f"<{i}>")
        if i % 3 == 2 and len(src) > 4:
            src.local_delete(a, 1, 2)
        chunks.append(export_txns_since(src, mark))
        mark = src.get_next_order()
    tw.admit("d")
    for chunk in chunks[:4]:
        tw.txns("d", chunk)
        tw.tick()
    assert tw.t.doc_state("d").in_lane
    tw.evict("d")
    for chunk in chunks[4:]:
        tw.txns("d", chunk)
    tw.tick()
    assert tw.t.doc_state("d").resident
    tw.drain()
    assert tw.t.doc_string("d") == src.to_string()


def scenario_remap_after_splits(tw):
    tw.admit("d")
    tw.local("d", "mmm", 0, ins="base")
    tw.tick()
    _fragment(tw, "d")
    tb = tw.t.residency.backends[0]
    fwd = tb._state[10][:, tw.t.doc_state("d").lane].numpy()
    assert (fwd >= 0).any(), "no block ever split"
    ta = JTxn(id=JRid("aaa", 0), parents=[JRid(*ROOT)],
              ops=[JIns(JRid(*ROOT), JRid(*ROOT), "A")])
    tz = JTxn(id=JRid("zzz", 0), parents=[JRid(*ROOT)],
              ops=[JIns(JRid(*ROOT), JRid(*ROOT), "Z")])
    tw.txns("d", [ta])
    tw.tick()
    assert tw.t.counters.get("lane_rank_remaps") >= 1
    tw.txns("d", [tz])
    tw.local("d", "mmm", 0, ins="x")
    tw.tick()


def scenario_reseed_after_splits(tw):
    tw.admit("d")
    _fragment(tw, "d", edits=12)
    tw.evict("d")
    tw.local("d", "ed", 0, ins="Z")
    tw.tick()
    doc = tw.t.doc_state("d")
    assert doc.resident and doc.in_lane
    got = tw.t.residency.backends[0].lane_signed(doc.lane)
    assert np.array_equal(got, oracle_signed(doc.oracle))


def scenario_run_row_overflow(tw):
    tw.admit("d")
    budget = tw.t.residency.backends[0].row_budget
    for i in range(budget + 6):
        tw.local("d", "ed", 0, ins="x")
        if i % 8 == 7:
            tw.tick()
    tw.drain(max_ticks=128)
    doc = tw.t.doc_state("d")
    assert doc.degraded and not doc.in_lane
    tw.local("d", "ed", 0, ins="tail")
    tw.tick()


def scenario_replace_steps(tw):
    tw.admit("d")
    tw.local("d", "ed", 0, ins="abcdefgh")
    tw.tick()
    tw.local("d", "ed", 2, del_len=3, ins="XY")
    tw.local("d", "ed", 0, del_len=1, ins="z")
    tw.drain()
    assert tw.t.doc_string("d") == "zbXYfgh"


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_mixed_local_remote, scenario_evict_restore_replay,
    scenario_remap_after_splits, scenario_reseed_after_splits,
    scenario_run_row_overflow, scenario_replace_steps)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_server_scenario_bit_identical_after_every_apply(tmp_path, name):
    tw = Twin(tmp_path)
    SCENARIOS[name](tw)
    tw.finish()


def _jax_doc_txns(seed: int, agents=("ann", "bob"), edits=10):
    """A seeded two-agent JAX document and its exported history."""
    rng = np.random.default_rng(seed)
    doc = JListCRDT()
    ids = [doc.get_or_create_agent_id(a) for a in agents]
    for i in range(edits):
        n = len(doc)
        if n > 2 and rng.random() < 0.3:
            doc.local_delete(ids[i % 2], int(rng.integers(0, n - 1)), 1)
        else:
            doc.local_insert(ids[i % 2], int(rng.integers(0, n + 1)),
                             "xyz"[: 1 + i % 3])
    return doc, export_txns_since(doc, 0)


def _both_backends():
    return j_make("rle-lanes-mixed", **BACKEND), \
        t_make("rle-lanes-mixed", device="cpu", **BACKEND)


def _compare(jb, tb, what):
    _assert_same(_snapshot(jb), _snapshot(tb), what)


class _Lanes:
    """Per-lane JAX compiler state: each lane's stream continues its own
    history's order space."""

    def __init__(self, lanes=4):
        self.lanes = lanes
        self.state = {}

    def tick(self, per_lane: dict):
        """One stacked [S, B] tick (JAX ``OpTensors`` and the port's) from
        ``{lane: txns}``, padded to a bucket, and the per-lane streams."""
        streams = []
        for b in range(self.lanes):
            txns = per_lane.get(b, [])
            if txns:
                table, assigner = self.state.get(b, (None, None))
                if table is None:
                    table = JB.AgentTable()
                for t in txns:
                    table.add(t.id.agent)
                ops, assigner = JB.compile_remote_txns(
                    txns, table, assigner=assigner, lmax=4)
                self.state[b] = (table, assigner)
            else:
                ops = JB.empty_ops(4)
            streams.append(ops)
        s = max(o.num_steps for o in streams)
        bucket = 8 if s <= 8 else 32
        jstacked = JB.stack_ops([JB.pad_ops(o, bucket) for o in streams])
        fields = {f.name: np.asarray(getattr(jstacked, f.name))
                  for f in dataclasses.fields(jstacked)}
        return jstacked, ops_from_numpy(fields), streams


class _Orders:
    def __init__(self, n):
        self.n = n

    def get_next_order(self):
        return self.n


def test_direct_uploads_ticks_remaps_and_clears():
    jb, tb = _both_backends()
    assert isinstance(tb, LanesMixedLaneBackend)
    assert (tb.NB, tb.NBT, tb.row_budget, tb.max_fuse_w) == \
        (jb.NB, jb.NBT, jb.row_budget, jb.max_fuse_w)
    # Uploads: two lanes seeded from the same histories.
    for lane, seed in ((0, 1), (2, 2)):
        jdoc, txns = _jax_doc_txns(seed)
        tdoc = TListCRDT()
        for t in _port_txns(txns):
            tdoc.apply_remote_txn(t)
        names = [cd.name for cd in jdoc.client_data]
        assert jb.fits_doc(jdoc) == tb.fits_doc(tdoc)
        jb.upload_lane(lane, jdoc, JB.AgentTable(names).rank_of_agent())
        tb.upload_lane(lane, tdoc, TB.AgentTable(names).rank_of_agent())
        _compare(jb, tb, f"upload {lane}")
        assert np.array_equal(tb.lane_signed(lane), oracle_signed(tdoc))
    # Ticks on fresh lanes 1 and 3: many short runs split their blocks.
    lanes = _Lanes()
    _, h1 = _jax_doc_txns(3, agents=("cy", "di"), edits=40)
    _, h3 = _jax_doc_txns(13, agents=("ed", "fay"), edits=20)
    splits = 0
    for part in range(4):
        lo, hi = len(h1) * part // 4, len(h1) * (part + 1) // 4
        jst, tst, streams = lanes.tick({1: h1[lo:hi],
                                        3: h3 if part == 0 else []})
        for b, ops in enumerate(streams):
            orders = _Orders(int(np.asarray(ops.order_advance).sum()))
            port_ops = ops_from_numpy({f.name: np.asarray(getattr(ops,
                                                                  f.name))
                                       for f in dataclasses.fields(ops)})
            assert jb.tick_fits(b, orders, ops) == \
                tb.tick_fits(b, orders, port_ops)
        nlog0 = tb._state[2].clone()
        jb.apply(jst)
        tb.apply(tst)
        splits += int((tb._state[2] > nlog0).sum())
        _compare(jb, tb, f"tick {part}")
    assert splits > 0, "no block split"
    # A remap (a new agent sorting first) and a clear.
    m = np.asarray([1, 2, 3], np.uint32)
    jb.remap_lane_ranks(0, m)
    tb.remap_lane_ranks(0, m)
    jb.clear_lane(2)
    tb.clear_lane(2)
    _compare(jb, tb, "remap + clear")
    jst, tst, _ = lanes.tick({})
    jb.apply(jst)
    tb.apply(tst)
    _compare(jb, tb, "after clear")
    assert tb.lane_writes == 4


def test_jax_state_carries_into_the_port_backend():
    """A JAX backend's state after uploads and a tick, carried into a
    fresh port backend through ``convert``: the next tick of both is
    bit-identical."""
    jb, tb = _both_backends()
    jdoc, txns = _jax_doc_txns(7)
    jb.upload_lane(1, jdoc, JB.AgentTable(
        [cd.name for cd in jdoc.client_data]).rank_of_agent())
    lanes = _Lanes()
    _, t0 = _jax_doc_txns(8, agents=("g", "h"))
    jst, _, _ = lanes.tick({0: t0})
    jb.apply(jst)
    dumped = lane_backend_to_numpy(jb)
    assert dumped["prev_rows"].shape == (1, 4)
    lane_backend_from_numpy(tb, dumped)
    _compare(jb, tb, "carried")
    jb.clear_lane(0)   # fresh lanes keep their seeded count
    tb.clear_lane(0)
    _, t2 = _jax_doc_txns(9, agents=("i", "j"))
    jst, tst, _ = lanes.tick({2: t2})
    jb.apply(jst)
    tb.apply(tst)
    _compare(jb, tb, "tick after carry")


def test_replace_step_growth_counts_both_branches():
    ops, _ = TB.compile_local_patches([TB.TestPatch(2, 3, "xy")], lmax=4,
                                      start_order=10)
    jops, _ = JB.compile_local_patches([JPatch(2, 3, "xy")], lmax=4,
                                       start_order=10)
    assert ops.num_steps == 1
    jb, tb = _both_backends()
    assert int(tb._stream_growth(ops.del_len, ops.ins_len)) == 4 == \
        int(jb._stream_growth(jops.del_len, jops.ins_len))


def test_flat_engine_is_a_later_slice():
    """The flat slice is in: the registry builds its backend; an engine
    outside the registry still raises."""
    from text_crdt_rust_tpu_torch.serve.batcher import FlatLaneBackend

    flat = t_make("flat", device="cpu", **BACKEND)
    assert isinstance(flat, FlatLaneBackend) and flat.lanes == 4
    with pytest.raises(ValueError, match="unknown engine"):
        t_make("definitely-not-an-engine", device="cpu", **BACKEND)
    # ``rle`` is registered (configs northstar, 2 and 3) but serves no
    # lanes, as in the JAX package's registry.
    with pytest.raises(ValueError, match="no serve lane backend"):
        t_make("rle", device="cpu", **BACKEND)
