"""The port's un-blocked per-lane mixed replay (plain PyTorch version, on
the CPU) against the JAX package's Pallas kernel ``_mixed_lanes_kernel``
in interpret mode, bit for bit on all eight outputs.

The JAX package builds every input: remote txns from its oracle (the
cases of ``tests/test_rle_lanes_mixed.py``), compiled per lane by its
``compile_remote_txns`` and stacked by its ``stack_ops``;
``convert.ops_from_numpy`` carries the stream across. Origins compare as
uint32 bit views, state as int32, error flags and post-error state
included; lanes also equal the oracle. Tolerance: none, the state is
integers. Streams are padded to 8 lanes and replayed with chunk 128 and
256 table rows so the JAX package compiles its interpret kernel once per
capacity. The chains (warm start, growing capacity) compare every chunk.
The case builders here serve ``test_torch_lanes_mixed_blocked.py`` too.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest

from test_device_flat import oracle_from_patches, random_patches
from text_crdt_rust_tpu.common import RemoteDel, RemoteId, RemoteIns, RemoteTxn
from text_crdt_rust_tpu.models.oracle import ListCRDT
from text_crdt_rust_tpu.models.sync import export_txns_since
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import rle_lanes_mixed as JM
from text_crdt_rust_tpu.parallel.causal import CausalBuffer
from text_crdt_rust_tpu.utils.randedit import make_storm
from text_crdt_rust_tpu.utils.testdata import TestPatch as JPatch
from text_crdt_rust_tpu_torch import convert
from text_crdt_rust_tpu_torch.ops import rle_lanes as TL
from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as TM

ROOT = RemoteId("ROOT", 0xFFFFFFFF)
A6_FIELDS = ("ol", "orr", "ordp", "lenp", "rows", "oll", "orl", "err")
LANES = 8
OCAP = 256


# -- case builders (JAX package inputs) ------------------------------------------


def compile_txn_lanes(lane_txns, lmax=4, dmax=None):
    """Per-lane RemoteTxn lists -> stacked [S, B] op tensors (JAX)."""
    opses = []
    for txns in lane_txns:
        table = JB.AgentTable()
        for t in txns:
            table.add(t.id.agent)
            for op in t.ops:
                if hasattr(op, "id"):
                    table.add(op.id.agent)
        ops, _ = JB.compile_remote_txns(txns, table, lmax=lmax, dmax=dmax)
        opses.append(ops)
    return JB.stack_ops(opses)


def pad_lanes(stacked, lanes):
    """Idle no-op lanes appended up to ``lanes`` (an all-zero step is an
    exact no-op)."""
    b = np.asarray(stacked.kind).shape[1]

    def pad(a):
        a = np.asarray(a)
        return np.pad(a, [(0, 0), (0, lanes - b)] + [(0, 0)] * (a.ndim - 2))

    return jax.tree.map(pad, stacked)


def to_port(stacked):
    return convert.ops_from_numpy(
        {f.name: np.asarray(getattr(stacked, f.name))
         for f in dataclasses.fields(stacked)})


def oracle_txns(txns):
    doc = ListCRDT()
    for t in txns:
        doc.apply_remote_txn(t)
    return doc


def oracle_signed(doc):
    return [(-1 if doc.deleted[i] else 1) * (int(doc.order[i]) + 1)
            for i in range(doc.n)]


def _tiebreaks():
    return [
        [RemoteTxn(id=RemoteId(n, 0), parents=[],
                   ops=[RemoteIns(ROOT, ROOT, t)])
         for n, t in [("zed", "zz"), ("amy", "aa"), ("mia", "mm")]],
        [RemoteTxn(id=RemoteId(n, 0), parents=[],
                   ops=[RemoteIns(ROOT, ROOT, t)])
         for n, t in [("bob", "b"), ("eve", "ee"), ("cat", "c")]],
    ]


def _two_peer(seed, lanes=4, patches=25):
    rng = random.Random(seed)
    out = []
    for _ in range(lanes):
        pa, _ = random_patches(rng, patches)
        pb, _ = random_patches(rng, patches)
        out.append(export_txns_since(oracle_from_patches(pa, "peer-a"), 0)
                   + export_txns_since(oracle_from_patches(pb, "peer-b"), 0))
    return out


def _fragmented():
    l0 = [RemoteTxn(id=RemoteId("amy", 0), parents=[],
                    ops=[RemoteIns(ROOT, ROOT, "abcdef")]),
          RemoteTxn(id=RemoteId("bob", 0), parents=[RemoteId("amy", 5)],
                    ops=[RemoteDel(RemoteId("amy", 1), 3)]),
          RemoteTxn(id=RemoteId("cat", 0), parents=[RemoteId("amy", 5)],
                    ops=[RemoteDel(RemoteId("amy", 2), 3)])]
    l1 = [RemoteTxn(id=RemoteId("amy", 0), parents=[],
                    ops=[RemoteIns(ROOT, ROOT, "x" * 50)]),
          RemoteTxn(id=RemoteId("bob", 0), parents=[RemoteId("amy", 49)],
                    ops=[RemoteDel(RemoteId("amy", 5), 40)])]
    l2 = [RemoteTxn(id=RemoteId("amy", 0), parents=[],
                    ops=[RemoteIns(ROOT, ROOT, "abcdefgh")]),
          RemoteTxn(id=RemoteId("amy", 8), parents=[RemoteId("amy", 7)],
                    ops=[RemoteDel(RemoteId("amy", 2), 4)]),
          RemoteTxn(id=RemoteId("bob", 0), parents=[RemoteId("amy", 7)],
                    ops=[RemoteIns(RemoteId("amy", 3), RemoteId("amy", 4),
                                   "XY")])]
    return [l0, l1, l2]


def _long_delete():
    """A 40-char interval delete across several blocks plus a double
    delete, and a fragmented run deleted in one interval."""
    l0 = [RemoteTxn(id=RemoteId("amy", 0), parents=[],
                    ops=[RemoteIns(ROOT, ROOT, "x" * 50)]),
          RemoteTxn(id=RemoteId("bob", 0), parents=[RemoteId("amy", 49)],
                    ops=[RemoteDel(RemoteId("amy", 5), 40)]),
          RemoteTxn(id=RemoteId("cat", 0), parents=[RemoteId("amy", 49)],
                    ops=[RemoteDel(RemoteId("amy", 3), 10)])]
    l1 = [RemoteTxn(id=RemoteId("amy", 0), parents=[],
                    ops=[RemoteIns(ROOT, ROOT, "abcdefgh")])]
    for k, s in enumerate((1, 3, 5)):
        l1.append(RemoteTxn(id=RemoteId("bob", k), parents=[],
                            ops=[RemoteDel(RemoteId("amy", s), 1)]))
    l1.append(RemoteTxn(id=RemoteId("cat", 0), parents=[],
                        ops=[RemoteDel(RemoteId("amy", 1), 6)]))
    return [l0, l1]


def _mixed_local_remote(local_patches=30, remote_patches=20):
    """Lane 0 applies LOCAL ops while lane 1 applies REMOTE ops in the
    same steps."""
    rng = random.Random(11)
    patches, content = random_patches(rng, local_patches)
    local_ops, _ = JB.compile_local_patches(
        JB.merge_patches(patches), lmax=8, dmax=None)
    pa, _ = random_patches(rng, remote_patches)
    txns = export_txns_since(oracle_from_patches(pa, "peer-a"), 0)
    table = JB.AgentTable()
    for t in txns:
        table.add(t.id.agent)
    remote_ops, _ = JB.compile_remote_txns(txns, table, lmax=8, dmax=16)
    return JB.stack_ops([local_ops, remote_ops]), content, txns


def _local_lanes():
    rng = random.Random(7)
    streams = [random_patches(rng, 30 + rng.randint(0, 20))[0]
               for _ in range(8)]
    lmax = max(len(p.ins_content) for ps in streams for p in ps) or 1
    return JB.stack_ops([JB.compile_local_patches(ps, lmax=lmax,
                                                  dmax=None)[0]
                         for ps in streams])


def _fused_bursts():
    """Backwards insert bursts compiled into W-row fused steps (W > 2)."""
    opses = []
    for seed in (3, 4):
        rng = random.Random(seed)
        patches, content = [], ""
        for _ in range(6):
            if content and rng.random() < 0.3:
                pos = rng.randint(0, len(content) - 1)
                span = min(rng.randint(1, 3), len(content) - pos)
                patches.append(JPatch(pos, span, ""))
                content = content[:pos] + content[pos + span:]
            pos = rng.randint(0, len(content))
            for _ in range(rng.randint(3, 6)):
                patches.append(JPatch(pos, 0, "ab"))
                content = content[:pos] + "ab" + content[pos:]
        ops, _ = JB.compile_local_patches(patches, lmax=16, fuse_w=5)
        opses.append(ops)
    stacked = JB.stack_ops(opses)
    assert JB.fused_width(stacked) > 2
    return stacked


def _n_peer(seed):
    rng = random.Random(seed)
    streams = []
    for name in ("kim", "lou", "max"):
        patches, _ = random_patches(rng, 15)
        streams.append(export_txns_since(
            oracle_from_patches(patches, agent=name), 0))

    def interleave(order_rng):
        queues = [list(s) for s in streams]
        out = []
        while any(queues):
            live = [q for q in queues if q]
            out.append(order_rng.choice(live).pop(0))
        return out

    return [interleave(random.Random(seed * 100 + k)) for k in range(4)]


def _causal_released():
    rng = random.Random(404)
    lanes = []
    for _ in range(3):
        pa, _ = random_patches(rng, 20)
        pb, _ = random_patches(rng, 15)
        txns = (export_txns_since(oracle_from_patches(pa, "ann"), 0)
                + export_txns_since(oracle_from_patches(pb, "bob"), 0))
        shuffled = list(txns)
        rng.shuffle(shuffled)
        buf = CausalBuffer()
        lanes.append(buf.add_all(shuffled))
        assert buf.pending == 0
    return lanes


def _storm_lanes(seed, del_prob=0.3):
    return [make_storm(3, 5, 2, seed=seed * 10 + k, del_prob=del_prob)[0]
            for k in range(3)]


def _capacity_overflow():
    l1 = []
    for k in range(30):
        l1.append(RemoteTxn(id=RemoteId("a", 2 * k), parents=[],
                            ops=[RemoteIns(ROOT if k == 0
                                           else RemoteId("a", 2 * k - 1),
                                           ROOT, "ab")]))
        if k % 2 == 0:
            l1.append(RemoteTxn(id=RemoteId("b", k // 2), parents=[],
                                ops=[RemoteDel(RemoteId("a", 2 * k), 1)]))
    l0 = [RemoteTxn(id=RemoteId("a", 0), parents=[],
                    ops=[RemoteIns(ROOT, ROOT, "ab")])]
    return [l0, l1]


def _delete_overflow():
    txns = [RemoteTxn(id=RemoteId("amy", 0), parents=[],
                      ops=[RemoteIns(ROOT, ROOT, "aaaaaaaa")])]
    for k, s in enumerate((1, 3, 5, 6)):
        txns.append(RemoteTxn(id=RemoteId("bob", k), parents=[],
                              ops=[RemoteDel(RemoteId("amy", s), 1)]))
    return [txns]


def _corrupt(stacked, **cells):
    """A copy of ``stacked`` with single cells overwritten:
    ``field=(step, lane, value)``."""
    out = jax.tree.map(lambda a: np.asarray(a).copy(), stacked)
    for field, (s, b, v) in cells.items():
        getattr(out, field)[s, b] = v
    return out


def _missing_target():
    st = compile_txn_lanes([[RemoteTxn(id=RemoteId("a", 0), parents=[],
                                       ops=[RemoteIns(ROOT, ROOT, "ab")])]])
    return _corrupt(st, kind=(0, 0, JB.KIND_REMOTE_DEL),
                    del_target=(0, 0, 90), del_len=(0, 0, 1),
                    ins_len=(0, 0, 0))


def _missing_origin():
    st = compile_txn_lanes([[
        RemoteTxn(id=RemoteId("a", 0), parents=[],
                  ops=[RemoteIns(ROOT, ROOT, "ab")]),
        RemoteTxn(id=RemoteId("a", 2), parents=[],
                  ops=[RemoteIns(RemoteId("a", 1), ROOT, "cd")])]])
    return _corrupt(st, origin_left=(1, 0, 90))


# name -> (stacked, capacity, lane txns for the oracle or None, err row)
CASES = {
    "tiebreaks": lambda: (compile_txn_lanes(_tiebreaks()), 512,
                          _tiebreaks(), None),
    "two-peer-3": lambda: (compile_txn_lanes(_two_peer(3)), 512,
                           _two_peer(3), None),
    "two-peer-21": lambda: (compile_txn_lanes(_two_peer(21)), 512,
                            _two_peer(21), None),
    "fragmented-double-delete": lambda: (
        compile_txn_lanes(_fragmented(), lmax=16), 128, _fragmented(),
        None),
    "long-delete": lambda: (compile_txn_lanes(_long_delete(), lmax=50),
                            128, _long_delete(), None),
    "mixed-local-remote": lambda: (_mixed_local_remote()[0], 256, None,
                                   None),
    "local-lanes": lambda: (_local_lanes(), 256, None, None),
    "fused-bursts": lambda: (_fused_bursts(), 256, None, None),
    "n-peer-1": lambda: (compile_txn_lanes(_n_peer(1)), 512, _n_peer(1),
                         None),
    "n-peer-17": lambda: (compile_txn_lanes(_n_peer(17)), 512, _n_peer(17),
                          None),
    "causal-buffer": lambda: (compile_txn_lanes(_causal_released()), 512,
                              _causal_released(), None),
    "storm-fuzz-5": lambda: (compile_txn_lanes(_storm_lanes(5)), 512,
                             _storm_lanes(5), None),
    "storm-fuzz-29": lambda: (compile_txn_lanes(_storm_lanes(29)), 512,
                              _storm_lanes(29), None),
    "capacity-flag": lambda: (compile_txn_lanes(_capacity_overflow()), 8,
                              None, 0),
    "delete-capacity-flag": lambda: (
        compile_txn_lanes(_delete_overflow(), lmax=8), 8, None, 0),
    "missing-target": lambda: (_missing_target(), 16, None, 1),
    "missing-origin": lambda: (_missing_origin(), 16, None, 2),
}


def assert_same(jres, tres, fields):
    """Every field equal as numpy arrays (u32 fields as uint32 views)."""
    for f in fields:
        j = np.asarray(getattr(jres, f))
        t = getattr(tres, f).cpu().numpy()
        if j.dtype == np.uint32:
            t = t.view(np.uint32)
        assert j.dtype == t.dtype and j.shape == t.shape, f
        assert np.array_equal(j, t), f


def lanes_equal_oracle(tres, lane_txns):
    for d, txns in enumerate(lane_txns):
        assert TL.expand_lane(tres, d).tolist() == \
            oracle_signed(oracle_txns(txns)), f"lane {d}"


# -- tests -----------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_matches_jax(name):
    stacked, capacity, lane_txns, err_row = CASES[name]()
    stacked = pad_lanes(stacked, LANES)
    kw = dict(capacity=capacity, order_capacity=OCAP, chunk=128)
    jres = JM.replay_lanes_mixed(stacked, interpret=True, **kw)
    tres = TM.replay_lanes_mixed(to_port(stacked), device="cpu", **kw)
    assert_same(jres, tres, A6_FIELDS)
    if err_row is None:
        tres.check()
        if lane_txns is not None:
            lanes_equal_oracle(tres, lane_txns)
    else:
        assert tres.err[err_row].max() == 1
        with pytest.raises(RuntimeError):
            tres.check()


def test_mixed_lanes_reproduce_text():
    stacked, content, txns = _mixed_local_remote()
    res = TM.replay_lanes_mixed(to_port(stacked), capacity=256, chunk=16,
                                device="cpu")
    res.check()
    chars = {}
    for s in np.nonzero(np.asarray(stacked.ins_len)[:, 0])[0]:
        st = int(np.asarray(stacked.ins_order_start)[s, 0])
        for j in range(int(np.asarray(stacked.ins_len)[s, 0])):
            chars[st + j] = chr(int(np.asarray(stacked.chars)[s, 0, j]))
    got = "".join(chars[int(o) - 1] for o in TL.expand_lane(res, 0) if o > 0)
    assert got == content
    assert TL.expand_lane(res, 1).tolist() == \
        oracle_signed(oracle_txns(txns))


def _warm_chunks():
    rng = random.Random(42)
    docs = 4
    lane_txns = [export_txns_since(oracle_from_patches(
        random_patches(rng, 40)[0], agent=f"peer{d}"), 0)
        for d in range(docs)]
    halves = [(t[: len(t) // 2], t[len(t) // 2:]) for t in lane_txns]
    tables = [JB.AgentTable() for _ in range(docs)]
    assigners = [None] * docs
    chunks = []
    for which in (0, 1):
        opses = []
        for d in range(docs):
            txns = halves[d][which]
            for t in txns:
                tables[d].add(t.id.agent)
            ops, assigners[d] = JB.compile_remote_txns(
                txns, tables[d], assigner=assigners[d], lmax=4, dmax=16)
            opses.append(ops)
        chunks.append(JB.stack_ops(opses))
    return chunks, lane_txns


def test_warm_start_chain_matches_jax():
    """Chunk 2 resumes from chunk 1's state (tables carried through the
    sentinel merge, ranks accumulated on the host), in both packages."""
    (c0, c1), lane_txns = _warm_chunks()
    kw = dict(capacity=256, order_capacity=512, chunk=128)
    j0 = JM.make_replayer_lanes_mixed(c0, interpret=True, **kw)()
    t0 = TM.make_replayer_lanes_mixed(to_port(c0), device="cpu", **kw)()
    assert_same(j0, t0, A6_FIELDS)
    _, _, rkl0 = JM.lane_tables(c0, 512)
    _, _, rkl1 = JM.lane_tables(c1, 512)
    rkl = np.where(rkl1 != 0, rkl1, rkl0)
    j1 = JM.make_replayer_lanes_mixed(c1, init=j0.state(), rkl=rkl,
                                      interpret=True, **kw)()
    t1 = TM.make_replayer_lanes_mixed(to_port(c1), init=t0.state(), rkl=rkl,
                                      device="cpu", **kw)()
    assert_same(j1, t1, A6_FIELDS)
    t1.check()
    lanes_equal_oracle(t1, lane_txns)


def test_growing_capacity_chain_matches_jax():
    """Chunks with growing row and order capacities (the streaming lever):
    the port pads the carried state on its device as the JAX package
    does, and both equal the flat-capacity chain."""
    rng = random.Random(77)
    docs = 3
    lane_txns = [export_txns_since(oracle_from_patches(
        random_patches(rng, 30)[0], agent=f"p{d}"), 0) for d in range(docs)]
    halves = [(t[: len(t) // 2], t[len(t) // 2:]) for t in lane_txns]

    def chunks():
        tables = [JB.AgentTable() for _ in range(docs)]
        assigners = [None] * docs
        out = []
        for which in (0, 1):
            opses = []
            for d in range(docs):
                for t in halves[d][which]:
                    tables[d].add(t.id.agent)
                ops, assigners[d] = JB.compile_remote_txns(
                    halves[d][which], tables[d], assigner=assigners[d],
                    lmax=4, dmax=None)
                opses.append(ops)
            out.append(JB.stack_ops(opses))
        return out

    c0, c1 = chunks()
    jstate = tstate = None
    for c, cap in ((c0, 64), (c1, 128)):
        kw = dict(capacity=cap, order_capacity=cap, chunk=128)
        jres = JM.make_replayer_lanes_mixed(c, init=jstate, interpret=True,
                                            **kw)()
        tres = TM.make_replayer_lanes_mixed(to_port(c), init=tstate,
                                            device="cpu", **kw)()
        assert_same(jres, tres, A6_FIELDS)
        jstate, tstate = jres.state(), tres.state()
    flat = None
    for c in (c0, c1):
        flat = TM.make_replayer_lanes_mixed(
            to_port(c), capacity=128, order_capacity=128, chunk=16,
            init=None if flat is None else flat.state(), device="cpu")()
    for f in ("ordp", "lenp", "rows"):
        assert np.array_equal(getattr(tres, f).numpy(),
                              getattr(flat, f).numpy()), f
    lanes_equal_oracle(tres, lane_txns)


@pytest.mark.parametrize("name", ["two-peer-3", "storm-fuzz-5",
                                  "capacity-flag"])
def test_lanes_are_independent(name):
    """A replay of B lanes equals B one-lane replays on every output: the
    tile-wide gates of the Pallas body never change a lane's bits, which
    is what lets the CUDA kernel run each document alone."""
    stacked, capacity, _, _ = CASES[name]()
    ops = to_port(stacked)
    kw = dict(capacity=capacity, order_capacity=OCAP, chunk=16, device="cpu")
    whole = TM.replay_lanes_mixed(ops, **kw)
    B = ops.kind.shape[1]
    for b in range(B):
        one = TM.replay_lanes_mixed(dataclasses.replace(
            ops, **{f.name: getattr(ops, f.name)[:, b:b + 1]
                    for f in dataclasses.fields(ops)}), **kw)
        S = one.ol.shape[0]
        for f in A6_FIELDS:
            w = getattr(whole, f)[:, b:b + 1]
            if f in ("ol", "orr"):
                w = w[:S]
            assert np.array_equal(w.numpy(), getattr(one, f).numpy()), \
                (b, f)


def test_lane_tables_match_jax():
    stacked = compile_txn_lanes(_two_peer(3))
    for j, t in zip(JM.lane_tables(stacked, 300),
                    TM.lane_tables(to_port(stacked), 300)):
        assert j.dtype == t.dtype and np.array_equal(j, t)


def test_wrappers_refuse_other_devices():
    col = TM.torch.zeros(4, 2, dtype=TM.I32, device="meta")
    for replay in (TM.lanes_mixed_replay, TM.lanes_mixed_blocked_replay):
        with pytest.raises(ValueError, match="no replay for device"):
            replay(*[col] * 18)
