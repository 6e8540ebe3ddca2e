"""The port's device-memory blocked replay (A9, plain PyTorch version, on
the CPU) against the JAX package's Pallas kernel ``_hbm_replay_kernel`` in
interpret mode, bit for bit, and against the port's A8 on valid streams.

The cases are those of ``tests/test_blocked_hbm.py`` (capacity 64-1,024,
K = 8-16, batch 8, chunk 128): window churn, far-jump edits, rebalances,
four divergent doc groups and ragged lengths; each group's ``signed``,
``rows``, ``ol``, ``orr`` and the shared ``err`` compare in full.
Tolerance: none, the state is integers. The north star on
``engine="hbm"`` runs at smoke size against ``apply_patches``.
"""
import random

import numpy as np
import pytest

from text_crdt_rust_tpu.ops import blocked_hbm as JBH
from text_crdt_rust_tpu.utils.testdata import TestPatch as JPatch
from text_crdt_rust_tpu_torch import northstar
from text_crdt_rust_tpu_torch.ops import blocked as TBL
from text_crdt_rust_tpu_torch.ops import blocked_hbm as TBH
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA

from test_device_flat import random_patches
from test_torch_blocked import (
    assert_blocked_equal,
    assert_flat_equal,
    compile_local,
    port_ops,
)

GEOM = dict(batch=8, chunk=128)


def _both(jops_list, capacity, block_k):
    """Replay the same groups in both packages; returns the results."""
    jres = JBH.make_replayer_hbm(jops_list, capacity=capacity,
                                 block_k=block_k, interpret=True, **GEOM)()
    tres = TBH.make_replayer_hbm([port_ops(o) for o in jops_list],
                                 capacity=capacity, block_k=block_k,
                                 device="cpu", **GEOM)()
    assert len(jres) == len(tres) == len(jops_list)
    for j, t in zip(jres, tres):
        assert_blocked_equal(j, t)
    return jres, tres


def _far_jump():
    p = [JPatch(0, 0, "abcdefgh")]
    for k in range(12):
        p += [JPatch(0, 0, "xy"), JPatch(8 + 2 * k, 0, "pq")]
    return p


def _random(seed):
    return random_patches(random.Random(seed), 80)[0]


CASES = {
    "smoke": lambda: ([JPatch(0, 0, "hello world"), JPatch(5, 0, ","),
                       JPatch(2, 3, "LLO"), JPatch(0, 1, "H")], 64, 8),
    "random-s7": lambda: (_random(7), 512, 16),
    "random-s11": lambda: (_random(11), 512, 16),
    "random-s99": lambda: (_random(99), 512, 16),
    "delete-spanning-blocks": lambda: (
        [JPatch(0, 0, "abcdefghijklmnopqrstuvwxyz"), JPatch(2, 20, "")],
        64, 8),
    "prepend-heavy": lambda: ([JPatch(0, 0, "ab") for _ in range(40)], 256,
                              8),
    "far-jump-edits": lambda: (_far_jump(), 128, 8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_matches_jax(name):
    patches, capacity, block_k = CASES[name]()
    jops = compile_local(patches)
    jres, tres = _both([jops], capacity, block_k)
    assert not np.asarray(jres[0].err).any()
    td = assert_flat_equal(jops, jres[0], tres[0])
    assert TSA.to_string(td) == northstar.apply_patches(patches)


def test_four_divergent_groups():
    rng = random.Random(404)
    opses, contents = [], []
    for gi in range(4):
        patches, content = random_patches(rng, 40 + 10 * gi)
        opses.append(compile_local(patches))
        contents.append(content)
    jres, tres = _both(opses, 512, 16)
    for jops, j, t, c in zip(opses, jres, tres, contents):
        assert TSA.to_string(assert_flat_equal(jops, j, t)) == c


def test_ragged_lengths_and_rebalances():
    short = [JPatch(0, 0, "hi"), JPatch(1, 1, "ey"), JPatch(0, 0, "O"),
             JPatch(2, 1, "")]
    long_p, long_content = random_patches(random.Random(77), 120)
    opses = [compile_local(short), compile_local(long_p)]
    jres, tres = _both(opses, 1024, 16)
    assert TSA.to_string(assert_flat_equal(opses[1], jres[1],
                                           tres[1])) == long_content
    assert TSA.to_string(assert_flat_equal(
        opses[0], jres[0], tres[0])) == northstar.apply_patches(short)


def test_two_level_descent_past_one_segment():
    """NB = 256 blocks (four 64-block segments) at K = 8: the level-2
    index is exercised, against JAX and A8."""
    jops = compile_local(random_patches(random.Random(5), 400)[0])
    jres, tres = _both([jops], 2048, 8)
    a8 = TBL.replay_local(port_ops(jops), capacity=2048, block_k=8,
                          device="cpu", **GEOM)
    for f in ("signed", "ol", "orr", "err"):
        assert np.array_equal(getattr(a8, f).numpy(),
                              getattr(tres[0], f).numpy()), f
    assert np.array_equal(a8.rows.numpy(), tres[0].rows[:256].numpy())


def test_delete_past_the_end_flags_err1():
    jops = compile_local([JPatch(0, 0, "abc"), JPatch(0, 10, "")])
    jres, tres = _both([jops], 64, 8)
    err = tres[0].err.numpy()
    assert err[1].all() and not err[0].any()
    with pytest.raises(RuntimeError, match="past the end"):
        tres[0].check()


def test_capacity_exhaustion_rejected_as_jax_does():
    jops = compile_local([JPatch(0, 0, "x" * 4) for _ in range(20)])
    kw = dict(capacity=32, batch=8, block_k=8, chunk=128)
    with pytest.raises(ValueError, match="raise capacity") as jerr:
        JBH.replay_local_hbm(jops, interpret=True, **kw)
    with pytest.raises(ValueError, match="raise capacity") as terr:
        TBH.replay_local_hbm(port_ops(jops), device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_odd_block_count_rejected():
    ops = port_ops(compile_local([JPatch(0, 0, "ab")]))
    with pytest.raises(ValueError, match="even number of blocks"):
        TBH.make_replayer_hbm(ops, capacity=24, block_k=8, device="cpu")


@pytest.mark.parametrize("seed", [3, 21])
def test_equal_to_a8_on_valid_streams(seed):
    """A9's arithmetic differs from A8's only past the end of the
    document: on valid streams the two give the same outputs."""
    ops = port_ops(compile_local(random_patches(random.Random(seed),
                                                150)[0]))
    kw = dict(capacity=1024, block_k=8, device="cpu", **GEOM)
    a8 = TBL.replay_local(ops, **kw)
    a9 = TBH.replay_local_hbm(ops, **kw)
    for f in ("signed", "ol", "orr", "err"):
        assert np.array_equal(getattr(a8, f).numpy(),
                              getattr(a9, f).numpy()), f
    assert np.array_equal(a8.rows.numpy(), a9.rows[:128].numpy())


def test_run_northstar_hbm_prefix():
    """The north star on the hbm engine at smoke size: the prefix's text,
    two doc groups, and the JAX replay of the same stream."""
    run = northstar.run_northstar(engine="hbm", patches=400, batch=8,
                                  groups=2, device="cpu")
    assert run.ok and len(run.results) == 2
    jres = JBH.make_replayer_hbm(run.stream.ops, capacity=1024, batch=8,
                                 block_k=512, chunk=1024, interpret=True)()
    for res in run.results:
        assert_blocked_equal(jres, res)
