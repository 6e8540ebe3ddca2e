"""The port's per-character blocked replay (A8, plain PyTorch version, on
the CPU) against the JAX package's Pallas kernel ``_replay_kernel`` in
interpret mode, bit for bit.

Every case compiles one stream with the JAX package, carries the same
``OpTensors`` across with ``convert.ops_from_numpy`` and replays it in both
packages at the shapes of ``tests/test_blocked.py`` (capacity 64-512,
K = 8-16, batch 8, chunk 128): ``signed``, ``rows``, ``ol``, ``orr`` and
``err`` compare in full, and ``blocked_to_flat``'s ``FlatDoc`` compares
on ``signed``, the origin logs, ``n`` and ``next_order``. Tolerance: none,
the state is integers. The north star on ``engine="blocked"`` runs at
smoke size against ``apply_patches``.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import blocked as JBL
from text_crdt_rust_tpu.utils.testdata import TestPatch as JPatch
from text_crdt_rust_tpu_torch import convert, northstar
from text_crdt_rust_tpu_torch.ops import blocked as TBL
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA

from test_device_flat import random_patches

GEOM = dict(batch=8, chunk=128)


def port_ops(jops):
    return convert.ops_from_numpy(
        {f.name: np.asarray(getattr(jops, f.name))
         for f in dataclasses.fields(jops)})


def compile_local(patches, lmax=4):
    return JB.compile_local_patches(patches, lmax=lmax, dmax=lmax)[0]


def assert_blocked_equal(jres, tres):
    """Bit-equality of every output of one replay."""
    got = convert.blocked_result_to_numpy(tres)
    for f in ("signed", "rows", "ol", "orr", "err"):
        want = np.asarray(getattr(jres, f))
        assert got[f].dtype == want.dtype, f
        assert got[f].shape == want.shape, f
        assert np.array_equal(got[f], want), f
    assert (tres.block_k, tres.num_blocks, tres.batch) == (
        jres.block_k, jres.num_blocks, jres.batch)


def assert_flat_equal(jops, jres, tres):
    """``blocked_to_flat`` of both packages: the same document."""
    jd = JBL.blocked_to_flat(jops, jres)
    td = TBL.blocked_to_flat(port_ops(jops), tres)
    assert np.array_equal(td.signed.numpy(), np.asarray(jd.signed))
    for f in ("ol_log", "or_log"):
        assert np.array_equal(getattr(td, f).numpy().view(np.uint32),
                              np.asarray(getattr(jd, f))), f
    assert td.n == int(jd.n)
    assert td.next_order == int(jd.next_order)
    return td


def _random(seed):
    return random_patches(random.Random(seed), 80)


CASES = {
    "smoke": lambda: ([JPatch(0, 0, "hello world"), JPatch(5, 0, ","),
                       JPatch(2, 3, "LLO"), JPatch(0, 1, "H")], 64, 8,
                      "HeLLO, world"),
    "random-s7": lambda: (*_random(7)[:1], 512, 16, _random(7)[1]),
    "random-s11": lambda: (*_random(11)[:1], 512, 16, _random(11)[1]),
    "random-s99": lambda: (*_random(99)[:1], 512, 16, _random(99)[1]),
    "delete-spanning-blocks": lambda: (
        [JPatch(0, 0, "abcdefghijklmnopqrstuvwxyz"), JPatch(2, 20, "")],
        64, 8, "abwxyz"),
    "prepend-heavy": lambda: ([JPatch(0, 0, "ab") for _ in range(40)], 256,
                              8, "ab" * 40),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_matches_jax(name):
    patches, capacity, block_k, content = CASES[name]()
    jops = compile_local(patches)
    jres = JBL.replay_local(jops, capacity=capacity, block_k=block_k,
                            interpret=True, **GEOM)
    tres = TBL.replay_local(port_ops(jops), capacity=capacity,
                            block_k=block_k, device="cpu", **GEOM)
    assert_blocked_equal(jres, tres)
    assert not np.asarray(jres.err).any()
    assert TBL.lanes_equal(tres)
    td = assert_flat_equal(jops, jres, tres)
    assert TSA.to_string(td) == content


def test_delete_past_the_end_flags_err1():
    jops = compile_local([JPatch(0, 0, "abc"), JPatch(0, 10, "")])
    jres = JBL.replay_local(jops, capacity=64, block_k=8, interpret=True,
                            **GEOM)
    tres = TBL.replay_local(port_ops(jops), capacity=64, block_k=8,
                            device="cpu", **GEOM)
    assert_blocked_equal(jres, tres)
    err = tres.err.numpy()
    assert err[1].all() and not err[0].any() and not err[2].any()
    with pytest.raises(RuntimeError, match="past the end"):
        TBL.blocked_to_flat(port_ops(jops), tres)


def test_capacity_exhaustion_rejected_as_jax_does():
    jops = compile_local([JPatch(0, 0, "x" * 4) for _ in range(20)])
    kw = dict(capacity=32, batch=8, block_k=8, chunk=128)
    with pytest.raises(ValueError, match="raise capacity") as jerr:
        JBL.replay_local(jops, interpret=True, **kw)
    with pytest.raises(ValueError, match="raise capacity") as terr:
        TBL.replay_local(port_ops(jops), device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw, match", [
    (dict(capacity=60, block_k=8), "multiple of block_k"),
    (dict(capacity=8, block_k=8), "two blocks"),
    (dict(capacity=64, block_k=4), "must exceed the insert chunk"),
])
def test_geometry_checks(kw, match):
    ops = port_ops(compile_local([JPatch(0, 0, "abcd")]))
    with pytest.raises(ValueError, match=match):
        TBL.make_replayer(ops, device="cpu", **kw)


def test_kernel_refuses_a_document_past_shared_memory():
    """The kernel keeps a document in one thread block's shared memory:
    a capacity past it is refused before any launch, naming the
    device-memory engine."""
    col = torch.zeros(4, dtype=torch.int32)
    shape = dict(steps=4, batch=8, capacity=65536, block_k=512, lmax=16)
    with pytest.raises(ValueError, match="'hbm' engine"):
        TBL.blocked_replay_cuda(col, col, col, col, **shape)
    assert TBL.kernel_smem_bytes(32768, 64) <= TBL.SMEM_LIMIT


def test_run_northstar_blocked_prefix():
    """The north star on the blocked engine at smoke size: bench.py's
    per-character geometry, the prefix's text, and the JAX replay of the
    same stream."""
    run = northstar.run_northstar(engine="blocked", patches=400, batch=8,
                                  device="cpu")
    assert run.ok and TSA.to_string(run.doc) == run.stream.want
    assert run.stream.steps == 400 and run.stream.fuse is None
    res = run.results[0]
    assert (res.signed.shape[0], res.block_k) == (1024, 512)
    jres = JBL.replay_local(run.stream.ops, capacity=1024, batch=8,
                            block_k=512, chunk=1024, interpret=True)
    assert_blocked_equal(jres, res)


def test_char_geometry_is_bench_rule():
    assert northstar.char_geometry(182315) == (524288, 512)
    assert northstar.char_geometry(16384) == (32768, 512)
    assert northstar.char_geometry(10) == (128, 64)
