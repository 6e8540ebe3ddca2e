"""The port's op compiler against the JAX package's, field for field.

Same inputs through both: the three shipped traces and seeded synthetic
streams (numpy generators), compared as numpy arrays with exact equality
(the compiled columns are integers)."""
import dataclasses

import numpy as np
import pytest

from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import span_arrays as JSA
from text_crdt_rust_tpu.utils import testdata as JT
from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA
from text_crdt_rust_tpu_torch.utils import randedit
from text_crdt_rust_tpu_torch.utils import testdata as TT

TRACES = ("automerge-paper", "rustcode", "sveltecomponent")


def _load(name):
    return JT.load_testing_data(JT.trace_path(name)), \
        TT.load_testing_data(TT.trace_path(name))


def _as_tuples(patches):
    return [(p.pos, p.del_len, p.ins_content) for p in patches]


def _jax_patches(patches):
    return [JT.TestPatch(p.pos, p.del_len, p.ins_content) for p in patches]


def assert_ops_equal(jops, tops):
    for f in dataclasses.fields(JB.OpTensors):
        j = np.asarray(getattr(jops, f.name))
        t = getattr(tops, f.name)
        assert j.dtype == t.dtype and j.shape == t.shape, f.name
        assert np.array_equal(j, t), f.name


def _compile_both(jpatches, tpatches, **kw):
    jops, jnext = JB.compile_local_patches(jpatches, **kw)
    tops, tnext = TB.compile_local_patches(tpatches, **kw)
    assert jnext == tnext
    return jops, tops


@pytest.mark.parametrize("trace", TRACES)
def test_load_testing_data(trace):
    jd, td = _load(trace)
    assert jd.end_content == td.end_content
    assert jd.start_content == td.start_content
    assert jd.num_ops() == td.num_ops()
    assert _as_tuples(JT.flatten_patches(jd)) == \
        _as_tuples(TT.flatten_patches(td))


@pytest.mark.parametrize("trace", TRACES)
def test_merge_compile_fuse_equal(trace):
    jd, td = _load(trace)
    jm = JB.merge_patches(JT.flatten_patches(jd))
    tm = TB.merge_patches(TT.flatten_patches(td))
    assert _as_tuples(jm) == _as_tuples(tm)
    lmax = max(len(p.ins_content) for p in jm)
    jops, tops = _compile_both(jm, tm, lmax=lmax, dmax=None)
    assert_ops_equal(jops, tops)
    jf, js = JB.fuse_steps(jops, fuse_w=8)
    tf, ts = TB.fuse_steps(tops, fuse_w=8)
    assert_ops_equal(jf, tf)
    assert js.to_dict() == ts.to_dict()
    assert js.step_map == ts.step_map


def test_automerge_paper_step_counts():
    _, td = _load("automerge-paper")
    tm = TB.merge_patches(TT.flatten_patches(td))
    lmax = max(len(p.ins_content) for p in tm)
    ops, _ = TB.compile_local_patches(tm, lmax=lmax)
    fused, _ = TB.fuse_steps(ops, fuse_w=8)
    assert (len(tm), ops.num_steps, fused.num_steps) == (10712, 10712, 7352)
    assert TB.fused_width(fused) == 2 and lmax == 1396


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fuse_w", [1, 4, 8])
def test_prepend_bursts_compile_equal(seed, fuse_w):
    tp, _ = randedit.prepend_bursts(np.random.default_rng(seed), 40)
    jp = _jax_patches(tp)
    jops, tops = _compile_both(jp, tp, lmax=16, fuse_w=fuse_w)
    assert_ops_equal(jops, tops)
    if fuse_w > 1:
        assert TB.fused_width(tops) > 1
    jops, tops = _compile_both(jp, tp, lmax=16, fuse_w=fuse_w,
                               fuse_shapes="all")
    assert_ops_equal(jops, tops)


@pytest.mark.parametrize("dmax", [None, 1, 3])
def test_random_stream_compile_equal(dmax):
    tp, _ = randedit.random_patches(np.random.default_rng(5), 200)
    jp = _jax_patches(tp)
    jops, tops = _compile_both(jp, tp, lmax=3, dmax=dmax)
    assert_ops_equal(jops, tops)
    jf, _ = JB.fuse_steps(jops, fuse_w=4, dmax=dmax)
    tf, _ = TB.fuse_steps(tops, fuse_w=4, dmax=dmax)
    assert_ops_equal(jf, tf)


@pytest.mark.parametrize("block_k", [8, 16, 32])
def test_fused_width_checked_equal(block_k):
    tp, _ = randedit.prepend_bursts(np.random.default_rng(9), 30)
    jops, tops = _compile_both(_jax_patches(tp), tp, lmax=16, fuse_w=8)
    try:
        want = JB.fused_width_checked([jops], block_k)
    except ValueError:
        with pytest.raises(ValueError, match="one-split headroom"):
            TB.fused_width_checked([tops], block_k)
    else:
        assert TB.fused_width_checked([tops], block_k) == want


@pytest.mark.parametrize("fuse_w", [1, 8])
def test_require_unfused_agrees(fuse_w):
    tp, _ = randedit.prepend_bursts(np.random.default_rng(6), 20)
    jops, tops = _compile_both(_jax_patches(tp), tp, lmax=16, fuse_w=fuse_w)
    if JB.fused_width(jops) > 1:
        with pytest.raises(ValueError, match="no fused multi-row splice"):
            JB.require_unfused(jops, "flat")
        with pytest.raises(ValueError,
                           match="no fused multi-row splice") as ei:
            TB.require_unfused(tops, "flat")
        for name in TB.fused_engine_names():
            assert name in str(ei.value)
    else:
        JB.require_unfused(jops, "flat")
        TB.require_unfused(tops, "flat")
    assert "rle" in JB.fused_engine_names()
    assert "rle-hbm" in JB.fused_engine_names()
    assert TB.fused_engine_names() == ("rle", "rle-hbm")


@pytest.mark.parametrize("fuse_w", [1, 8])
def test_prefill_logs_equal(fuse_w):
    tp, _ = randedit.prepend_bursts(np.random.default_rng(4), 20)
    jops, tops = _compile_both(_jax_patches(tp), tp, lmax=16, fuse_w=fuse_w)
    jdoc = JB.prefill_logs(JSA.make_flat_doc(512), jops)
    tdoc = TB.prefill_logs(TSA.make_flat_doc(512, device="cpu"), tops)
    for name in ("ol_log", "or_log", "rank_log", "chars_log"):
        assert np.array_equal(
            np.asarray(getattr(jdoc, name)),
            getattr(tdoc, name).numpy().view(np.uint32)), name


def test_merge_fused_origins_equal():
    tp, _ = randedit.prepend_bursts(np.random.default_rng(8), 20)
    jops, tops = _compile_both(_jax_patches(tp), tp, lmax=16, fuse_w=8)
    rng = np.random.default_rng(1)
    ol = rng.integers(0, 1 << 32, tops.num_steps, dtype=np.uint32)
    orr = rng.integers(0, 1 << 32, tops.num_steps, dtype=np.uint32)
    logs = [np.zeros(1024, np.uint32) for _ in range(4)]
    JB.merge_fused_origins(logs[0], logs[1], jops, ol, orr)
    TB.merge_fused_origins(logs[2], logs[3], tops, ol, orr)
    assert np.array_equal(logs[0], logs[2])
    assert np.array_equal(logs[1], logs[3])


@pytest.mark.parametrize("fuse_w", [1, 4])
def test_row_growth_bound_ops_equal(fuse_w):
    """The JAX package's own cases (``tests/test_rle_fused.py``): eight
    single-char prepends, unfused and fused at W = 4."""
    tp = [TT.TestPatch(0, 0, "x")] * 8
    jops, tops = _compile_both(_jax_patches(tp), tp, lmax=8, fuse_w=fuse_w)
    assert TB.row_growth_bound_ops(tops) == JB.row_growth_bound_ops(jops)
    want = 1 + 2 * (4 + 1) if fuse_w == 4 else TB.row_growth_bound(8)
    assert TB.row_growth_bound_ops(tops) == want


def test_compile_trace_and_row_bound_on_automerge_paper():
    """``compile_trace`` bit for bit, and the row bound of the whole
    trace unfused and fused at W = 8, against the JAX package."""
    jd, td = _load("automerge-paper")
    jops, jnext = JB.compile_trace(jd)
    tops, tnext = TB.compile_trace(td)
    assert jnext == tnext
    assert_ops_equal(jops, tops)
    assert TB.row_growth_bound_ops(tops) == JB.row_growth_bound_ops(jops) \
        == TB.row_growth_bound(tops.num_steps)
    jops, jnext = JB.compile_trace(jd, rank=3, lmax=4)
    tops, tnext = TB.compile_trace(td, rank=3, lmax=4)
    assert jnext == tnext
    assert_ops_equal(jops, tops)
    jm = JB.merge_patches(JT.flatten_patches(jd))
    tm = TB.merge_patches(TT.flatten_patches(td))
    lmax = max(len(p.ins_content) for p in tm)
    jf, _ = JB.fuse_steps(JB.compile_local_patches(jm, lmax=lmax)[0],
                          fuse_w=8)
    tf, _ = TB.fuse_steps(TB.compile_local_patches(tm, lmax=lmax)[0],
                          fuse_w=8)
    assert TB.row_growth_bound_ops(tf) == JB.row_growth_bound_ops(jf)
    assert TB.row_growth_bound_ops(tf) > TB.row_growth_bound(tf.num_steps)
