"""The port's BLOCKED per-lane mixed replay (plain PyTorch version, on the
CPU) against the JAX package's Pallas kernel
``_mixed_lanes_blocked_kernel`` in interpret mode, bit for bit on all
fourteen outputs (``ol, orr, ordp, lenp, nlog, blkord, rws, liv, raw,
oll, orl, ordblk, fwd, err``), and against the port's un-blocked replay.

The inputs are the JAX package's, built as in
``tests/test_lanes_blocked.py`` and ``tests/test_rle_lanes_mixed.py``
(case builders shared with ``test_torch_rle_lanes_mixed.py``). Tiny
blocks (K = 8 and 16) force splits, stale hints, forward-pointer hops and
the plane fallback; a warm-start chain grows the capacity between chunks;
three cases raise the three error rows. Tolerance: none, the state is
integers. Cases share three compile shapes (4 lanes, chunk 128, 256 table
rows; capacity 128 at K = 8, 256 at K = 16, 8 at K = 8) so the JAX
package compiles its interpret kernel once per shape.
"""
import random

import numpy as np
import pytest

from test_device_flat import oracle_from_patches, random_patches
from test_torch_rle_lanes_mixed import (
    _delete_overflow,
    _fragmented,
    _fused_bursts,
    _long_delete,
    _missing_origin,
    _missing_target,
    _mixed_local_remote,
    _n_peer,
    _storm_lanes,
    _tiebreaks,
    _two_peer,
    assert_same,
    compile_txn_lanes,
    lanes_equal_oracle,
    pad_lanes,
    to_port,
)
from text_crdt_rust_tpu.models.sync import export_txns_since
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import rle_lanes_mixed as JM
from text_crdt_rust_tpu.utils.testdata import TestPatch as JPatch
from text_crdt_rust_tpu_torch.ops import rle_lanes as TL
from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as TM

A7_FIELDS = ("ol", "orr", "ordp", "lenp", "nlog", "blkord", "rws", "liv",
             "raw", "oll", "orl", "ordblk", "fwd", "err")
LANES = 4
OCAP = 256
SHAPE_A = dict(capacity=128, block_k=8)
SHAPE_B = dict(capacity=256, block_k=16)
SHAPE_C = dict(capacity=8, block_k=8)


def _busy_local():
    """Lane 1 outgrows a tiny capacity (inserts interleaved with deletes so
    runs cannot merge); lane 0 stays legal."""
    busy = []
    for k in range(24):
        busy.append(JPatch(0, 0, "ab"))
        if k % 2:
            busy.append(JPatch(1, 1, ""))
    return JB.stack_ops([
        JB.compile_local_patches([JPatch(0, 0, "ab")], lmax=2)[0],
        JB.compile_local_patches(busy, lmax=2)[0]])


def _bad_local_delete():
    return JB.stack_ops([JB.compile_local_patches(
        [JPatch(0, 0, "abc"), JPatch(0, 10, "")], lmax=4)[0]])


# name -> (stacked, shape, lane txns for the oracle or None, err row)
CASES = {
    "storms-with-deletes-k8": lambda: (
        compile_txn_lanes(_storm_lanes(5, 0.35)), SHAPE_A,
        _storm_lanes(5, 0.35), None),
    "long-delete-k8": lambda: (compile_txn_lanes(_long_delete(), lmax=50),
                               SHAPE_A, _long_delete(), None),
    "tiebreaks-k8": lambda: (compile_txn_lanes(_tiebreaks()), SHAPE_A,
                             _tiebreaks(), None),
    "fragmented-k8": lambda: (compile_txn_lanes(_fragmented(), lmax=16),
                              SHAPE_A, _fragmented(), None),
    "two-peer-3-k16": lambda: (compile_txn_lanes(_two_peer(3, 3, 20)),
                               SHAPE_B, _two_peer(3, 3, 20), None),
    "two-peer-21-k16": lambda: (compile_txn_lanes(_two_peer(21, 3, 20)),
                                SHAPE_B, _two_peer(21, 3, 20), None),
    "mixed-local-remote-k16": lambda: (_mixed_local_remote(25, 18)[0],
                                       SHAPE_B, None, None),
    "fused-bursts-k16": lambda: (_fused_bursts(), SHAPE_B, None, None),
    "n-peer-1-k16": lambda: (compile_txn_lanes(_n_peer(1)), SHAPE_B,
                             _n_peer(1), None),
    "delete-out-of-blocks": lambda: (
        compile_txn_lanes(_delete_overflow(), lmax=8), SHAPE_C, None, 0),
    "local-out-of-blocks": lambda: (_busy_local(), SHAPE_C, None, 0),
    "bad-local-delete": lambda: (_bad_local_delete(), SHAPE_C, None, 1),
    "missing-target": lambda: (_missing_target(), SHAPE_C, None, 1),
    "missing-origin": lambda: (_missing_origin(), SHAPE_C, None, 2),
}


def _replay_both(stacked, shape, **kw):
    stacked = pad_lanes(stacked, LANES)
    kw = dict(order_capacity=OCAP, chunk=128, **shape, **kw)
    jres = JM.make_replayer_lanes_mixed_blocked(stacked, interpret=True,
                                                **kw)()
    tres = TM.make_replayer_lanes_mixed_blocked(to_port(stacked),
                                                device="cpu", **kw)()
    return jres, tres


@pytest.mark.parametrize("name", sorted(CASES))
def test_blocked_replay_matches_jax(name):
    stacked, shape, lane_txns, err_row = CASES[name]()
    jres, tres = _replay_both(stacked, shape)
    assert_same(jres, tres, A7_FIELDS)
    if err_row is None:
        tres.check()
        if lane_txns is not None:
            lanes_equal_oracle(tres, lane_txns)
    else:
        assert tres.err[err_row].max() == 1
        with pytest.raises(RuntimeError):
            tres.check()


def test_small_blocks_exercise_splits_and_hints():
    """K = 8 must split blocks, leave hints stale and walk the forward
    pointers, or the comparisons above would be vacuous."""
    stacked = compile_txn_lanes(_storm_lanes(5, 0.35))
    res = TM.replay_lanes_mixed_blocked(
        to_port(stacked), device="cpu", order_capacity=OCAP, chunk=16,
        **SHAPE_A)
    res.check()
    assert int(res.nlog.max()) > 2
    assert int((res.fwd >= 0).sum()) > 0
    live = res.ordp.numpy()
    ordblk = res.ordblk.numpy()
    stale = 0
    for b in range(res.batch):
        for o in range(ordblk.shape[0]):
            blk = ordblk[o, b]
            if blk < 0:
                continue
            rows = live[blk * 8:(blk + 1) * 8, b]
            lens = res.lenp.numpy()[blk * 8:(blk + 1) * 8, b]
            so = np.abs(rows) - 1
            stale += not np.any((rows != 0) & (so <= o) & (o < so + lens))
    assert stale > 0, "no stale hint left: the hop paths went untested"


@pytest.mark.parametrize("name", ["storms-with-deletes-k8", "two-peer-3-k16",
                                  "mixed-local-remote-k16",
                                  "fused-bursts-k16", "long-delete-k8"])
def test_blocked_equals_unblocked(name):
    """Block splits move rows, never runs: the blocked and un-blocked
    plain versions give the same documents, origins and tables."""
    stacked, shape, _, _ = CASES[name]()
    ops = to_port(stacked)
    blk = TM.make_replayer_lanes_mixed_blocked(
        ops, device="cpu", order_capacity=OCAP, chunk=16, **shape)()
    ref = TM.make_replayer_lanes_mixed(
        ops, capacity=shape["capacity"], order_capacity=OCAP, chunk=16,
        device="cpu")()
    blk.check()
    ref.check()
    for d in range(ops.kind.shape[1]):
        assert TL.expand_lane(blk, d).tolist() == \
            TL.expand_lane(ref, d).tolist(), d
    for f in ("ol", "orr", "oll", "orl"):
        assert np.array_equal(getattr(blk, f).numpy(),
                              getattr(ref, f).numpy()), f


def test_warm_start_chain_grows_capacity():
    """Two chunks with the state carried on the device, the capacity
    growing from 64 to 128 rows at K = 8 (hints and forward pointers ride
    along), the host-accumulated rank table passed in: equal to the JAX
    chain after each chunk, and to the oracle at the end."""
    rng = random.Random(42)
    docs = 3
    lane_txns = [export_txns_since(oracle_from_patches(
        random_patches(rng, 30)[0], agent=f"p{d}"), 0) for d in range(docs)]
    halves = [(t[: len(t) // 2], t[len(t) // 2:]) for t in lane_txns]
    tables = [JB.AgentTable() for _ in range(docs)]
    assigners = [None] * docs
    chunks = []
    for which in (0, 1):
        opses = []
        for d in range(docs):
            for t in halves[d][which]:
                tables[d].add(t.id.agent)
            ops, assigners[d] = JB.compile_remote_txns(
                halves[d][which], tables[d], assigner=assigners[d], lmax=4,
                dmax=None)
            opses.append(ops)
        chunks.append(pad_lanes(JB.stack_ops(opses), LANES))
    _, _, rkl0 = JM.lane_tables(chunks[0], OCAP)
    _, _, rkl1 = JM.lane_tables(chunks[1], OCAP)
    rkls = (None, np.where(rkl1 != 0, rkl1, rkl0))
    jstate = tstate = None
    for c, cap, rkl in zip(chunks, (64, 128), rkls):
        kw = dict(capacity=cap, block_k=8, order_capacity=OCAP, chunk=128,
                  rkl=rkl)
        jres = JM.make_replayer_lanes_mixed_blocked(c, init=jstate,
                                                    interpret=True, **kw)()
        tres = TM.make_replayer_lanes_mixed_blocked(to_port(c), init=tstate,
                                                    device="cpu", **kw)()
        assert_same(jres, tres, A7_FIELDS)
        tres.check()
        jstate, tstate = jres.state(), tres.state()
    lanes_equal_oracle(tres, lane_txns)


def test_state_converts_both_ways():
    """A blocked state the JAX package left crosses to the port through
    ``convert`` and back unchanged, and equals the port's own state; the
    un-blocked 5-tuple crosses too."""
    from text_crdt_rust_tpu_torch import convert

    stacked = pad_lanes(compile_txn_lanes(_two_peer(3, 3, 20)), LANES)
    kw = dict(capacity=256, block_k=16, order_capacity=OCAP, chunk=128)
    jres = JM.make_replayer_lanes_mixed_blocked(stacked, interpret=True,
                                                **kw)()
    fields = convert.lanes_state_to_numpy(jres.state())
    assert list(fields) == list(TM.BlockedLanesMixedResult.STATE_KEYS)
    tstate = convert.lanes_state_from_numpy(fields, device="cpu")
    back = convert.lanes_state_to_numpy(tstate)
    ops = to_port(stacked)
    own = TM.make_replayer_lanes_mixed_blocked(ops, device="cpu", **kw)()
    for k, a in zip(fields, tstate):
        assert np.array_equal(fields[k], back[k]), k
        assert np.array_equal(a.numpy(), getattr(own, k).numpy()), k
    un = TM.make_replayer_lanes_mixed(ops, capacity=256,
                                      order_capacity=OCAP, device="cpu")()
    five = convert.lanes_state_to_numpy(un.state())
    assert list(five) == ["ordp", "lenp", "rows", "oll", "orl"]
    for k, a in zip(five, convert.lanes_state_from_numpy(five, device="cpu")):
        assert np.array_equal(a.numpy(), five[k]), k


@pytest.mark.parametrize("name", ["two-peer-3-k16", "local-out-of-blocks",
                                  "missing-origin"])
def test_blocked_lanes_are_independent(name):
    """A replay of B lanes equals B one-lane replays on every output."""
    import dataclasses

    stacked, shape, _, _ = CASES[name]()
    ops = to_port(stacked)
    kw = dict(order_capacity=OCAP, chunk=16, device="cpu", **shape)
    whole = TM.make_replayer_lanes_mixed_blocked(ops, **kw)()
    for b in range(ops.kind.shape[1]):
        one = TM.make_replayer_lanes_mixed_blocked(dataclasses.replace(
            ops, **{f.name: getattr(ops, f.name)[:, b:b + 1]
                    for f in dataclasses.fields(ops)}), **kw)()
        for f in A7_FIELDS:
            assert np.array_equal(getattr(whole, f)[:, b:b + 1].numpy(),
                                  getattr(one, f).numpy()), (b, f)
