"""The port's un-blocked per-lane local replay (plain PyTorch version, on
the CPU) against the JAX package's Pallas kernel ``_rle_lanes_kernel`` in
interpret mode, bit for bit on all six outputs (``ol, orr, ordp, lenp,
rows, err``).

The JAX package builds every input: local patch streams per lane (the
cases of ``tests/test_rle_lanes.py``), compiled by its
``compile_local_patches`` and stacked by its ``stack_ops``;
``convert.ops_from_numpy`` carries the stream across. Origins compare as
uint32 bit views, state as int32, error flags and post-error state
included; lanes also reproduce their text. Tolerance: none, the state is
integers. Replays run with chunk 128 so the JAX package compiles its
interpret kernel once per capacity and stream shape. The case helpers
here serve ``test_torch_lanes_blocked.py`` too.
"""
import dataclasses
import random

import numpy as np
import pytest

from test_device_flat import random_patches
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import rle_lanes as JL
from text_crdt_rust_tpu.utils.testdata import TestPatch as JPatch
from text_crdt_rust_tpu_torch import convert
from text_crdt_rust_tpu_torch.ops import rle_lanes as TL
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA
from text_crdt_rust_tpu_torch.utils.randedit import continue_patches

A4_FIELDS = ("ol", "orr", "ordp", "lenp", "rows", "err")


# -- case helpers (JAX package inputs) -------------------------------------------


def compile_stack(streams, lmax=None, start_orders=None, fuse_w=1):
    """Per-lane patch lists -> stacked [S, B] op tensors (JAX) and each
    lane's next order. Fused streams get room for a W-row burst."""
    if lmax is None:
        lmax = max([len(p.ins_content) for ps in streams for p in ps] + [1])
        if fuse_w > 1:
            lmax = 16
    starts = start_orders or [0] * len(streams)
    opses, nexts = [], []
    for ps, so in zip(streams, starts):
        ops, nxt = JB.compile_local_patches(ps, lmax=lmax, dmax=None,
                                            start_order=so, fuse_w=fuse_w)
        opses.append(ops)
        nexts.append(nxt)
    return JB.stack_ops(opses), nexts


def to_port(stacked):
    return convert.ops_from_numpy(
        {f.name: np.asarray(getattr(stacked, f.name))
         for f in dataclasses.fields(stacked)})


def assert_same(jres, tres, fields):
    """Every field equal as numpy arrays (u32 fields as uint32 views)."""
    for f in fields:
        j = np.asarray(getattr(jres, f))
        t = getattr(tres, f).cpu().numpy()
        if j.dtype == np.uint32:
            t = t.view(np.uint32)
        assert j.dtype == t.dtype and j.shape == t.shape, f
        assert np.array_equal(j, t), f


def lane_text(stacks, res, d):
    """Lane ``d``'s live chars in document order, looked up by order in the
    chars of every chunk's stream."""
    chars = {}
    for st in stacks:
        ilens = np.asarray(st.ins_len)[:, d]
        starts = np.asarray(st.ins_order_start)[:, d]
        cps = np.asarray(st.chars)[:, d]
        for s in np.nonzero(ilens)[0]:
            for j in range(int(ilens[s])):
                chars[int(starts[s]) + j] = chr(int(cps[s, j]))
    return "".join(chars[int(o) - 1] for o in TL.expand_lane(res, d) if o > 0)


def divergent(seed, docs=16, base=30):
    rng = random.Random(seed)
    streams, contents = [], []
    for _ in range(docs):
        patches, content = random_patches(rng, base + rng.randint(0, 30))
        streams.append(patches)
        contents.append(content)
    return streams, contents


def merged(seed=5, docs=8):
    rng = random.Random(seed)
    streams, contents = [], []
    for _ in range(docs):
        patches, content = random_patches(rng, 40)
        streams.append(JB.merge_patches(patches))
        contents.append(content)
    return streams, contents


def config5_like(seed=1000, docs=8, steps=120):
    """Pure inserts and pure deletes (``continue_patches``), more real steps
    than padding: the stream shape whose replayer hoists one live prefix
    per step (SHARED_CUM on)."""
    streams, contents = [], []
    for d in range(docs):
        patches, content = continue_patches(random.Random(seed + d), "",
                                            steps, ins_prob=0.45)
        streams.append(patches)
        contents.append(content)
    return streams, contents


def fused_bursts():
    """Backwards insert bursts compiled into W-row fused steps (W > 2)."""
    streams, contents = [], []
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
        streams.append(patches)
        contents.append(content)
    return streams, contents


def busy_lane():
    """Lane 1 outgrows a tiny capacity (inserts interleaved with deletes so
    runs cannot merge); lane 0 stays legal."""
    busy = []
    for k in range(24):
        busy.append(JPatch(0, 0, "ab"))
        if k % 2:
            busy.append(JPatch(1, 1, ""))
    return [[JPatch(0, 0, "ab")], busy]


def bad_delete():
    return [[JPatch(0, 0, "abc"), JPatch(0, 10, "")],
            [JPatch(0, 0, "abcdefgh"), JPatch(2, 3, "")]]


def two_docs():
    return [[JPatch(0, 0, "hello"), JPatch(5, 0, " world"),
             JPatch(0, 1, "H")],
            [JPatch(0, 0, "abc"), JPatch(1, 1, "XY"), JPatch(0, 0, "z")]]


# name -> (streams, texts or None, capacity, fuse_w, err row or None)
CASES = {
    "two-divergent-docs": lambda: (two_docs(), ["Hello world", "zaXYc"],
                                   32, 1, None),
    "divergent-seed-7": lambda: (*divergent(7), 256, 1, None),
    "divergent-seed-42": lambda: (*divergent(42), 256, 1, None),
    "merged-streams": lambda: (*merged(), 256, 1, None),
    "config5-like-shared-cum": lambda: (*config5_like(), 256, 1, None),
    "fused-bursts": lambda: (*fused_bursts(), 256, 5, None),
    "capacity-flag": lambda: (busy_lane(), None, 8, 1, 0),
    "bad-delete": lambda: (bad_delete(), None, 16, 1, 1),
}


def replay_both(stacked, capacity, init=None, jinit=None):
    jres = JL.make_replayer_lanes(stacked, capacity=capacity, chunk=128,
                                  init=jinit, interpret=True)()
    rep = TL.make_replayer_lanes(to_port(stacked), capacity=capacity,
                                 chunk=128, init=init, device="cpu")
    return jres, rep(), rep


# -- tests -----------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_matches_jax(name):
    streams, texts, capacity, fuse_w, err_row = CASES[name]()
    stacked, _ = compile_stack(streams, fuse_w=fuse_w)
    if fuse_w > 1:
        assert JB.fused_width(stacked) > 2
    jres, tres, _ = replay_both(stacked, capacity)
    assert_same(jres, tres, A4_FIELDS)
    if err_row is None:
        tres.check()
        for d, want in enumerate(texts):
            assert TSA.to_string(TL.lanes_to_flat(to_port(stacked), tres,
                                                  d)) == want, d
    else:
        assert tres.err[err_row].max() == 1
        with pytest.raises(RuntimeError):
            tres.check()


@pytest.mark.parametrize("name,shared", [("config5-like-shared-cum", True),
                                         ("divergent-seed-7", False)])
def test_shared_cum_gate_on_and_off(name, shared):
    """The replayer hoists one live prefix per step on the pure-insert/
    pure-delete stream and not on the stream with replace patches; both
    replays equal the JAX kernel (checked above) and the lanes' texts."""
    streams, texts, capacity, _, _ = CASES[name]()
    stacked, _ = compile_stack(streams)
    rep = TL.make_replayer_lanes(to_port(stacked), capacity=capacity,
                                 chunk=128, device="cpu")
    assert rep.shape["shared_cum"] is shared
    res = rep()
    res.check()
    for d, want in enumerate(texts):
        assert lane_text([stacked], res, d) == want, d


def warm_chunks(seed=9, docs=8, chunks=2, steps=20):
    rng = random.Random(seed)
    contents = [""] * docs
    out = []
    for _ in range(chunks):
        streams = []
        for d in range(docs):
            patches = []
            for _ in range(steps):
                if not contents[d] or rng.random() < 0.6:
                    pos = rng.randint(0, len(contents[d]))
                    ins = rng.choice("abcd") * rng.randint(1, 3)
                    patches.append(JPatch(pos, 0, ins))
                    contents[d] = contents[d][:pos] + ins + contents[d][pos:]
                else:
                    pos = rng.randint(0, len(contents[d]) - 1)
                    span = min(rng.randint(1, 3), len(contents[d]) - pos)
                    patches.append(JPatch(pos, span, ""))
                    contents[d] = (contents[d][:pos]
                                   + contents[d][pos + span:])
            streams.append(patches)
        out.append(streams)
    return out, contents


def test_warm_start_chain_matches_jax():
    """Chunk 2 resumes from chunk 1's state in both packages; the port's
    state after each chunk equals the JAX package's."""
    chunk_streams, contents = warm_chunks()
    nexts = None
    jstate = tstate = None
    stacks = []
    for streams in chunk_streams:
        stacked, nexts = compile_stack(streams, lmax=4, start_orders=nexts)
        stacks.append(stacked)
        jres, tres, _ = replay_both(stacked, 128, init=tstate, jinit=jstate)
        assert_same(jres, tres, A4_FIELDS)
        tres.check()
        jstate, tstate = jres.state(), tres.state()
    for d, want in enumerate(contents):
        assert lane_text(stacks, tres, d) == want, d


def test_capacity_growth_matches_jax_and_flat_chain():
    """Chunk 2 at a larger capacity zero-pads chunk 1's planes on the
    device, as the JAX package does, and equals the flat-capacity chain."""
    rng = random.Random(31)
    s1 = [random_patches(rng, 15)[0] for _ in range(4)]
    s2 = [random_patches(rng, 15)[0] for _ in range(4)]
    c1, nexts = compile_stack(s1, lmax=16)
    c2, _ = compile_stack(s2, lmax=16, start_orders=nexts)
    j1, t1, _ = replay_both(c1, 64)
    j2, t2, _ = replay_both(c2, 128, init=t1.state(), jinit=j1.state())
    assert_same(j1, t1, A4_FIELDS)
    assert_same(j2, t2, A4_FIELDS)
    flat1 = TL.replay_lanes(to_port(c1), 128, device="cpu")
    flat2 = TL.make_replayer_lanes(to_port(c2), 128, init=flat1.state(),
                                   device="cpu")()
    for f in ("ordp", "lenp", "rows", "ol", "orr"):
        assert np.array_equal(getattr(t2, f).numpy(),
                              getattr(flat2, f).numpy()), f


@pytest.mark.parametrize("name", ["divergent-seed-42", "capacity-flag",
                                  "fused-bursts"])
def test_lanes_are_independent(name):
    """A replay of B lanes equals B one-lane replays on every output: the
    tile-wide gates of the Pallas body never change a lane's bits, which
    is what lets the CUDA kernel run each document alone."""
    streams, _, capacity, fuse_w, _ = CASES[name]()
    ops = to_port(compile_stack(streams, fuse_w=fuse_w)[0])
    whole = TL.replay_lanes(ops, capacity, chunk=16, device="cpu")
    for b in range(ops.kind.shape[1]):
        one = TL.replay_lanes(dataclasses.replace(
            ops, **{f.name: getattr(ops, f.name)[:, b:b + 1]
                    for f in dataclasses.fields(ops)}),
            capacity, chunk=16, device="cpu")
        S = one.ol.shape[0]
        for f in A4_FIELDS:
            w = getattr(whole, f)[:, b:b + 1]
            if f in ("ol", "orr"):
                w = w[:S]
            assert np.array_equal(w.numpy(), getattr(one, f).numpy()), \
                (b, f)


def test_replayer_refuses_remote_and_unstacked_streams():
    stacked, _ = compile_stack(two_docs())
    ops = to_port(stacked)
    with pytest.raises(ValueError, match="stacked"):
        TL.make_replayer_lanes(dataclasses.replace(
            ops, **{f.name: getattr(ops, f.name)[:, 0]
                    for f in dataclasses.fields(ops)}), 32, device="cpu")
    remote = dataclasses.replace(ops, kind=np.ones_like(ops.kind))
    with pytest.raises(ValueError, match="local streams"):
        TL.make_replayer_lanes(remote, 32, device="cpu")
    with pytest.raises(ValueError, match="local streams"):
        TL.make_replayer_lanes_blocked(remote, 64, block_k=8, device="cpu")


def test_wrappers_refuse_other_devices():
    col = TL.torch.zeros(4, 2, dtype=TL.I32, device="meta")
    for replay in (TL.lanes_replay, TL.lanes_blocked_replay):
        with pytest.raises(ValueError, match="no replay for device"):
            replay(*[col] * 11)
