"""The port's BLOCKED per-lane local replay (plain PyTorch version, on the
CPU) against the JAX package's Pallas kernel ``_lanes_blocked_kernel`` in
interpret mode, bit for bit on all nine outputs (``ol, orr, ordp, lenp,
nlog, blkord, rws, liv, err``), and against the port's un-blocked replay.

The inputs are the JAX package's, built as in ``tests/test_lanes_blocked.py``
(case helpers shared with ``test_torch_rle_lanes.py``). Tiny blocks (K =
8 and 16) force splits; a warm-start chain grows the capacity between
chunks; two cases raise the two error rows (out of blocks, a delete run
off the end of its document after 2 * NBT + 1 walk iterations), and their
post-error tables are compared too. ``lanes_to_flat`` and the state
bridges of ``convert`` are held against the JAX package's. Tolerance:
none, the state is integers.
"""
import dataclasses
import random

import numpy as np
import pytest

from test_device_flat import random_patches
from test_torch_rle_lanes import (
    CASES,
    assert_same,
    compile_stack,
    lane_text,
    to_port,
)
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import rle_lanes as JL
from text_crdt_rust_tpu.utils.testdata import TestPatch as JPatch
from text_crdt_rust_tpu_torch import convert
from text_crdt_rust_tpu_torch.ops import rle_lanes as TL

A5_FIELDS = ("ol", "orr", "ordp", "lenp", "nlog", "blkord", "rws", "liv",
             "err")


def run_off_the_end():
    """Lane 0 deletes 10 chars of a 3-char document (the walk runs 2 * NBT
    + 1 iterations); lane 1 deletes inside its document."""
    return [[JPatch(0, 0, "abc"), JPatch(0, 10, "")],
            [JPatch(0, 0, "abcdefgh"), JPatch(2, 3, "")]]


def out_of_blocks():
    """Lane 1 outgrows a 2-block capacity (inserts interleaved with deletes
    so runs cannot merge); lane 0 stays legal."""
    busy = []
    for k in range(24):
        busy.append(JPatch(0, 0, "ab"))
        if k % 2:
            busy.append(JPatch(1, 1, ""))
    return [[JPatch(0, 0, "ab")], busy]


# name -> (streams, texts or None, capacity, block_k, fuse_w, err row)
BCASES = {
    "divergent-seed-7-k16": lambda: (*CASES["divergent-seed-7"]()[:2], 256,
                                     16, 1, None),
    "divergent-seed-42-k8": lambda: (*CASES["divergent-seed-42"]()[:2], 256,
                                     8, 1, None),
    "merged-k8": lambda: (*CASES["merged-streams"]()[:2], 256, 8, 1, None),
    "config5-like-k16": lambda: (*CASES["config5-like-shared-cum"]()[:2],
                                 256, 16, 1, None),
    "fused-bursts-k16": lambda: (*CASES["fused-bursts"]()[:2], 256, 16, 5,
                                 None),
    "out-of-blocks": lambda: (out_of_blocks(), None, 16, 8, 1, 0),
    "delete-off-the-end": lambda: (run_off_the_end(), None, 16, 8, 1, 1),
}


def replay_both(stacked, capacity, block_k, init=None, jinit=None):
    jres = JL.make_replayer_lanes_blocked(
        stacked, capacity=capacity, block_k=block_k, chunk=128, init=jinit,
        interpret=True)()
    tres = TL.make_replayer_lanes_blocked(
        to_port(stacked), capacity=capacity, block_k=block_k, chunk=128,
        init=init, device="cpu")()
    return jres, tres


@pytest.mark.parametrize("name", sorted(BCASES))
def test_blocked_replay_matches_jax(name):
    streams, texts, capacity, block_k, fuse_w, err_row = BCASES[name]()
    stacked, _ = compile_stack(streams, fuse_w=fuse_w)
    jres, tres = replay_both(stacked, capacity, block_k)
    assert_same(jres, tres, A5_FIELDS)
    if err_row is None:
        tres.check()
        # Tiny K must split blocks, or the comparison is vacuous.
        assert int(tres.nlog.max()) > 1
        for d, want in enumerate(texts):
            assert lane_text([stacked], tres, d) == want, d
    else:
        assert tres.err[err_row].tolist() == (
            [0, 1] if err_row == 0 else [1, 0])
        with pytest.raises(RuntimeError):
            tres.check()


@pytest.mark.parametrize("name", ["divergent-seed-42-k8", "merged-k8",
                                  "fused-bursts-k16", "config5-like-k16"])
def test_blocked_equals_unblocked(name):
    """Block splits move rows, never runs: the blocked and un-blocked plain
    versions give the same documents and origins."""
    streams, _, capacity, block_k, fuse_w, _ = BCASES[name]()
    ops = to_port(compile_stack(streams, fuse_w=fuse_w)[0])
    blk = TL.make_replayer_lanes_blocked(ops, capacity=capacity,
                                         block_k=block_k, chunk=16,
                                         device="cpu")()
    ref = TL.replay_lanes(ops, capacity, chunk=16, device="cpu")
    blk.check()
    ref.check()
    for d in range(ops.kind.shape[1]):
        assert TL.expand_lane(blk, d).tolist() == \
            TL.expand_lane(ref, d).tolist(), d
    for f in ("ol", "orr", "rows"):
        assert np.array_equal(getattr(blk, f).numpy(),
                              getattr(ref, f).numpy()), f


def test_warm_start_growing_capacity_matches_jax():
    """Three chunks with the state carried and the capacity growing 64 ->
    128 -> 192 at K = 16: equal to the JAX chain after every chunk, and to
    the un-blocked chain at the end."""
    rng = random.Random(31)
    nexts = None
    jstate = tstate = ustate = None
    for cap in (64, 128, 192):
        streams = [random_patches(rng, 15)[0] for _ in range(4)]
        stacked, nexts = compile_stack(streams, lmax=8, start_orders=nexts)
        jres, tres = replay_both(stacked, cap, 16, init=tstate,
                                 jinit=jstate)
        assert_same(jres, tres, A5_FIELDS)
        tres.check()
        jstate, tstate = jres.state(), tres.state()
        ures = TL.make_replayer_lanes(to_port(stacked), cap, chunk=16,
                                      init=ustate, device="cpu")()
        ustate = ures.state()
    for d in range(4):
        assert TL.expand_lane(tres, d).tolist() == \
            TL.expand_lane(ures, d).tolist(), d


@pytest.mark.parametrize("name", ["divergent-seed-7-k16", "out-of-blocks",
                                  "delete-off-the-end"])
def test_blocked_lanes_are_independent(name):
    """A replay of B lanes equals B one-lane replays on every output."""
    streams, _, capacity, block_k, fuse_w, _ = BCASES[name]()
    ops = to_port(compile_stack(streams, fuse_w=fuse_w)[0])
    kw = dict(capacity=capacity, block_k=block_k, chunk=16, device="cpu")
    whole = TL.make_replayer_lanes_blocked(ops, **kw)()
    for b in range(ops.kind.shape[1]):
        one = TL.make_replayer_lanes_blocked(dataclasses.replace(
            ops, **{f.name: getattr(ops, f.name)[:, b:b + 1]
                    for f in dataclasses.fields(ops)}), **kw)()
        S = one.ol.shape[0]
        for f in A5_FIELDS:
            w = getattr(whole, f)[:, b:b + 1]
            if f in ("ol", "orr"):
                w = w[:S]
            assert np.array_equal(w.numpy(), getattr(one, f).numpy()), \
                (b, f)


@pytest.mark.parametrize("blocked", [False, True])
def test_lanes_to_flat_matches_jax(blocked):
    """One lane as a ``FlatDoc`` (prefilled logs, merged fused origins)
    equals the JAX package's ``lanes_to_flat`` field for field."""
    streams, _ = CASES["fused-bursts"]()[:2]
    stacked, _ = compile_stack(streams, fuse_w=5)
    if blocked:
        jres, tres = replay_both(stacked, 256, 16)
    else:
        jres = JL.replay_lanes(stacked, 256, chunk=128, interpret=True)
        tres = TL.replay_lanes(to_port(stacked), 256, device="cpu")
    for d in range(2):
        j = JL.lanes_to_flat(stacked, jres, d)
        t = TL.lanes_to_flat(to_port(stacked), tres, d)
        for f in ("signed", "ol_log", "or_log", "rank_log", "chars_log"):
            a = np.asarray(getattr(j, f))
            b = getattr(t, f).numpy()
            if a.dtype == np.uint32:
                b = b.view(np.uint32)
            assert a.dtype == b.dtype and np.array_equal(a, b), (d, f)
        assert int(j.n) == t.n and int(j.next_order) == t.next_order


@pytest.mark.parametrize("blocked", [False, True])
def test_jax_state_warm_starts_the_port(blocked):
    """A state the JAX package left crosses to the port through
    ``convert`` (3- or 6-tuple) and back unchanged; the port continues
    from it to the same result as the JAX package's continuation."""
    rng = random.Random(77)
    s1 = [random_patches(rng, 20)[0] for _ in range(4)]
    s2 = [random_patches(rng, 20)[0] for _ in range(4)]
    c1, nexts = compile_stack(s1, lmax=16)
    c2, _ = compile_stack(s2, lmax=16, start_orders=nexts)
    if blocked:
        def jrun(c, cap, init):
            return JL.make_replayer_lanes_blocked(
                c, capacity=cap, block_k=16, chunk=128, init=init,
                interpret=True)()

        def trun(c, cap, init):
            return TL.make_replayer_lanes_blocked(
                to_port(c), capacity=cap, block_k=16, chunk=128, init=init,
                device="cpu")()
        keys, fields = TL.BlockedLanesResult.STATE_KEYS, A5_FIELDS
    else:
        def jrun(c, cap, init):
            return JL.make_replayer_lanes(c, capacity=cap, chunk=128,
                                          init=init, interpret=True)()

        def trun(c, cap, init):
            return TL.make_replayer_lanes(to_port(c), capacity=cap,
                                          chunk=128, init=init,
                                          device="cpu")()
        keys, fields = TL.LanesResult.STATE_KEYS, \
            ("ol", "orr", "ordp", "lenp", "rows", "err")
    j1 = jrun(c1, 128, None)
    fields1 = convert.lanes_state_to_numpy(j1.state())
    assert list(fields1) == list(keys)
    tstate = convert.lanes_state_from_numpy(fields1, device="cpu")
    back = convert.lanes_state_to_numpy(tstate)
    for k in keys:
        assert np.array_equal(fields1[k], back[k]), k
    j2 = jrun(c2, 256, j1.state())
    t2 = trun(c2, 256, tstate)
    assert_same(j2, t2, fields)
    t2.check()


def test_blocked_replayer_refuses_bad_geometry():
    ops = to_port(compile_stack(CASES["two-divergent-docs"]()[0])[0])
    with pytest.raises(ValueError, match="multiple of block_k"):
        TL.make_replayer_lanes_blocked(ops, capacity=100, block_k=16,
                                       device="cpu")
    fused = to_port(compile_stack(CASES["fused-bursts"]()[0], fuse_w=5)[0])
    assert JB.fused_width(fused) > 3
    with pytest.raises(ValueError, match="one-split headroom"):
        TL.make_replayer_lanes_blocked(fused, capacity=64, block_k=8,
                                       device="cpu")
