"""The port's HBM-plane run replay (plain PyTorch version, on the CPU)
against the JAX package's Pallas kernel ``_rle_hbm_kernel`` in interpret
mode, bit for bit; kevin and the north star on the engine at smoke size.

Every case compiles one stream with the JAX package, carries the same
``OpTensors`` across with ``convert.ops_from_numpy`` and replays it in both
packages at the shapes ``tests/test_rle_hbm.py`` uses (K = 8-64, batch
4-8), most cases sharing one compile shape (capacity 256, K = 8, batch 8,
chunk 128). Which rows count: ``blkord``, ``rows``, ``meta``, ``err`` and
the origins in full; the planes on the rows of the blocks each group used
(``meta[g, 0] * K``), since the JAX kernel never writes the rows of unused
blocks (interpret mode leaves them uninitialised; the port zeroes them).
Error flags and post-error state included. Tolerance: none, the state is
integers.
"""
import dataclasses
import random

import numpy as np
import pytest

from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import rle as JR
from text_crdt_rust_tpu.ops import rle_hbm as JH
from text_crdt_rust_tpu.ops import span_arrays as JSA
from text_crdt_rust_tpu.utils.testdata import TestPatch as JPatch
from text_crdt_rust_tpu_torch import convert, kevin, northstar
from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch.ops import rle as TR
from text_crdt_rust_tpu_torch.ops import rle_hbm as TH
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA
from text_crdt_rust_tpu_torch.utils import randedit

TABLES = ("blkord", "rows", "meta", "ol", "orr", "err")
GEOM = dict(capacity=256, block_k=8, batch=8, chunk=128)


def _jax_patches(patches):
    return [JPatch(p.pos, p.del_len, p.ins_content) for p in patches]


def _compile(patches, merge=True, fuse_w=1, lmax=None):
    plist = JB.merge_patches(patches) if merge else patches
    if lmax is None:
        lmax = max([len(p.ins_content) for p in plist] + [1])
    ops, _ = JB.compile_local_patches(plist, lmax=lmax, dmax=None,
                                      fuse_w=fuse_w)
    return ops


def _port_ops(jops):
    return convert.ops_from_numpy(
        {f.name: np.asarray(getattr(jops, f.name))
         for f in dataclasses.fields(jops)})


def _random(seed, steps=80, merge=True):
    p, c = randedit.random_patches(random.Random(seed), steps)
    return _compile(_jax_patches(p), merge=merge), c


def assert_results_equal(jres, tres, block_k):
    """Bit-equality of one group's results on the rows that are outputs."""
    got = convert.rle_result_to_numpy(tres)
    for f in TABLES:
        want = np.asarray(getattr(jres, f))
        assert got[f].dtype == want.dtype, f
        assert np.array_equal(got[f], want), f
    used = int(np.asarray(jres.meta)[0, 0]) * block_k
    assert used == TH.used_rows(tres)
    for f in ("ordp", "lenp"):
        want = np.asarray(getattr(jres, f))
        assert got[f].shape == want.shape, f
        assert np.array_equal(got[f][:used], want[:used]), f


def _both(jops_list, **kw):
    """Replay the same streams in both packages; returns the results."""
    jres = JH.make_replayer_rle_hbm(jops_list, interpret=True, **kw)()
    tres = TH.make_replayer_rle_hbm([_port_ops(o) for o in jops_list],
                                    device="cpu", **kw)()
    assert len(jres) == len(tres) == len(jops_list)
    for j, t in zip(jres, tres):
        assert_results_equal(j, t, kw["block_k"])
    return jres, tres


def _far_jump():
    p = [JPatch(0, 0, "abcdefgh")]
    for k in range(12):
        p += [JPatch(0, 0, "xy"), JPatch(8 + 2 * k, 0, "pq")]
    return _compile(p, merge=False), None


def _spanning():
    p = [JPatch(0, 0, "ab") for _ in range(24)] + [JPatch(2, 40, "")]
    text = "ab" * 24
    return _compile(p, merge=False), text[:2] + text[42:]


CASES = {
    "smoke": lambda: (_compile([JPatch(0, 0, "hello world"),
                                JPatch(5, 0, ","), JPatch(2, 3, "LLO"),
                                JPatch(0, 1, "H")]), "HeLLO, world"),
    "random-s7-merged": lambda: _random(7),
    "random-s7-raw": lambda: _random(7, merge=False),
    "random-s11-merged": lambda: _random(11),
    "random-s11-raw": lambda: _random(11, merge=False),
    "random-s99-merged": lambda: _random(99),
    "random-s99-raw": lambda: _random(99, merge=False),
    "kevin-shape-prepends": lambda: (
        _compile([JPatch(0, 0, "ab") for _ in range(60)], merge=False),
        "ab" * 60),
    "far-jump-window-churn": _far_jump,
    "delete-spanning-blocks": _spanning,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_matches_jax(name):
    jops, content = CASES[name]()
    jres, tres = _both([jops], **GEOM)
    assert not np.asarray(jres[0].err).any()
    td = TR.rle_to_flat(_port_ops(jops), tres[0])
    jd = JSA.download(JR.rle_to_flat(jops, jres[0]))
    tdd = TSA.download(td)
    assert jd.keys() == tdd.keys()
    for k in jd:
        assert np.array_equal(jd[k], tdd[k]), k
    if content is not None:
        assert TSA.to_string(td) == content


def test_block_exhaustion_flags_err0_with_post_error_state():
    jops = _compile([JPatch(0, 0, "ab") for _ in range(40)], merge=False,
                    lmax=2)
    jres, tres = _both([jops], capacity=16, block_k=8, batch=8, chunk=128)
    err = np.asarray(jres[0].err)
    assert err[0].all() and not err[1].any()
    with pytest.raises(RuntimeError, match="out of blocks"):
        tres[0].check()


def test_delete_past_the_end_flags_err1():
    jops = _compile([JPatch(0, 0, "abc"), JPatch(0, 10, "")])
    jres, tres = _both([jops], **GEOM)
    err = np.asarray(jres[0].err)
    assert err[1].all() and not err[0].any()
    with pytest.raises(RuntimeError, match="past the end"):
        tres[0].check()


def test_three_divergent_groups():
    rng = random.Random(404)
    opses, contents = [], []
    for gi in range(3):
        p, c = randedit.random_patches(rng, 40 + 10 * gi)
        opses.append(_compile(_jax_patches(p)))
        contents.append(c)
    jres, tres = _both(opses, **GEOM)
    for jops, t, c in zip(opses, tres, contents):
        assert TSA.to_string(TR.rle_to_flat(_port_ops(jops), t)) == c


def test_store_origins_false_against_true():
    jops, content = _random(3, steps=120)
    kw = dict(capacity=256, batch=4, block_k=32, chunk=16)
    full_j, full_t = _both([jops], **kw)
    slim_j, slim_t = _both([jops], store_origins=False, **kw)
    slim = convert.rle_result_to_numpy(slim_t[0])
    assert slim["ol"].shape == (0, 4) and slim["ol"].dtype == np.uint32
    assert slim["orr"].shape == (0, 4)
    full = convert.rle_result_to_numpy(full_t[0])
    for f in ("ordp", "lenp", "blkord", "rows", "meta", "err"):
        assert np.array_equal(full[f], slim[f]), f
    assert np.array_equal(TR.expand_runs(full_t[0]),
                          TR.expand_runs(slim_t[0]))
    with pytest.raises(ValueError, match="per-op origins"):
        TR.rle_to_flat(_port_ops(jops), slim_t[0])
    assert TSA.to_string(TR.rle_to_flat(_port_ops(jops),
                                        full_t[0])) == content


# -- fused W-row prepend bursts (``tests/test_rle_fused.py:168-201``) ---------

KF, FW = 16, 6
FGEOM = dict(capacity=512, batch=8, block_k=KF, chunk=64)


@pytest.mark.parametrize("shape", ["kevin", "boundary"])
def test_fused_prepend_bursts_match_jax(shape):
    if shape == "kevin":
        n = 126
        patches = [JPatch(0, 0, "k")] * n
        content = "k" * n
    else:  # fill slot 0 to KF - FW rows, then one full-width burst
        pre = KF - FW
        patches = [JPatch(0, 0, "p")] * pre + [JPatch(0, 0, "b")] * FW \
            + [JPatch(0, 0, "t")]
        content = "t" + "b" * FW + "p" * pre
    ops_u = _compile(patches, merge=False, lmax=FW)
    ops_f = _compile(patches, merge=False, fuse_w=FW, lmax=FW)
    assert JB.fused_width(ops_f) == FW
    jres, tres = _both([ops_f], **FGEOM)
    plain_u = TH.replay_local_rle_hbm(_port_ops(ops_u), device="cpu",
                                      **FGEOM)
    assert np.array_equal(TR.expand_runs(tres[0]),
                          TR.expand_runs(plain_u))
    if shape == "kevin":
        assert np.array_equal(TR.expand_runs(tres[0]),
                              np.arange(len(patches), 0, -1, dtype=np.int32))
    else:
        assert int(tres[0].meta[0].max()) >= 2
    assert TSA.to_string(TR.rle_to_flat(_port_ops(ops_f),
                                        tres[0])) == content


# -- A2 against A1 (both plain versions) --------------------------------------


@pytest.mark.parametrize("seed", [3, 21])
def test_equal_state_to_the_rle_engine(seed):
    jops, _ = _random(seed, steps=100)
    tops = _port_ops(jops)
    kw = dict(capacity=256, batch=8, block_k=8, chunk=128, device="cpu")
    res_v = TR.replay_local_rle(tops, **kw)
    res_h = TH.replay_local_rle_hbm(tops, **kw)
    assert np.array_equal(TR.expand_runs(res_v), TR.expand_runs(res_h))
    assert np.array_equal(res_v.ol.numpy(), res_h.ol.numpy())
    assert np.array_equal(res_v.orr.numpy(), res_h.orr.numpy())


# -- the entry points at smoke size -------------------------------------------


def test_kevin_geometry():
    assert kevin.kevin_geometry(5_000_000) == (2048, 10_500_096, False)
    assert kevin.kevin_geometry(1_000_000) == (512, 2_100_224, True)
    ns = kevin.compile_kevin(1000, fuse_w=64)
    assert ns.steps == 16
    assert TB.fused_width(ns.ops) == 64


def test_run_kevin_smoke_matches_jax():
    """``bench.py --smoke``'s kevin geometry (K = 64, W = 8) on 512
    prepends, against the JAX replay of the same stream."""
    run = kevin.run_kevin(n=512, batch=8, fuse_w=8, block_k=64,
                          device="cpu")
    assert run.ok and run.order_ok and run.lanes_equal
    # The prepends on the native engine (bench.py:1563-1581).
    assert run.native_ok and run.native_text == " " * 512
    res = run.result
    assert res.ordp.shape == (1088, 8) and res.ol.shape == (64, 8)
    jops, _ = JB.compile_local_patches([JPatch(0, 0, " ")] * 512, lmax=8,
                                       fuse_w=8)
    tops = run.stream.ops
    for f in dataclasses.fields(jops):
        assert np.array_equal(np.asarray(getattr(jops, f.name)),
                              getattr(tops, f.name)), f.name
    jres = JH.make_replayer_rle_hbm(jops, capacity=1088, batch=8,
                                    block_k=64, chunk=128,
                                    interpret=True)()
    assert_results_equal(jres, res, 64)
    assert np.array_equal(JR.expand_runs(jres),
                          np.arange(512, 0, -1, dtype=np.int32))


def test_kevin_cli_prints_one_line(capsys):
    assert kevin.main(["--n", "96", "--batch", "2", "--fuse-w", "4",
                       "--block-k", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and '"ok": true' in out[0]
    assert '"steps": 24' in out[0]


def test_run_northstar_rle_hbm_prefix_matches_jax():
    """The north star on the HBM-plane engine, on a trace prefix: the
    port's entry point against the JAX engine on the same fused stream,
    and against the prefix's text."""
    kw = dict(batch=8, capacity=512, block_k=16)
    run = northstar.run_northstar(patches=600, engine="rle-hbm",
                                  device="cpu", **kw)
    assert run.ok
    assert TSA.to_string(run.doc) == run.stream.want
    res = run.results[0]
    assert res.block_k == 16 and int(res.meta[0].max()) >= 2
    jops = JB.fuse_steps(JB.compile_local_patches(
        JB.merge_patches(_jax_patches(_prefix(600))),
        lmax=_lmax(600), dmax=None)[0], fuse_w=8)[0]
    jres = JH.make_replayer_rle_hbm(jops, interpret=True, chunk=1024,
                                    **kw)()
    assert_results_equal(jres, res, 16)
    # The rle engine on the same stream: same document, same origins.
    a1 = northstar.run_northstar(patches=600, device="cpu", **kw)
    assert np.array_equal(TR.expand_runs(a1.results[0]),
                          TR.expand_runs(res))
    assert np.array_equal(a1.results[0].ol.numpy(), res.ol.numpy())
    assert np.array_equal(a1.results[0].orr.numpy(), res.orr.numpy())


def _prefix(n):
    from text_crdt_rust_tpu_torch.utils.testdata import (
        flatten_patches,
        load_testing_data,
        trace_path,
    )
    return flatten_patches(load_testing_data(trace_path(
        "automerge-paper")))[:n]


def _lmax(n):
    merged = JB.merge_patches(_jax_patches(_prefix(n)))
    return max([len(p.ins_content) for p in merged] + [1])


def test_northstar_rejects_unknown_engine():
    with pytest.raises(ValueError, match="unknown engine"):
        northstar.make_northstar_replayer(None, engine="flat",
                                          device="cpu")
