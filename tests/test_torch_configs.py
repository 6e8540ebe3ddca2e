"""Configurations 1-3 of ``BASELINE.json`` on the port, at ``bench.py
--smoke``'s sizes, against the JAX package: config 2 (``random_edits``:
2,000 random patches, K = 256) and config 3 (``corpus``: 400-patch
prefixes of rustcode and sveltecomponent as two ragged doc groups,
rustcode's opening with a 42,493-character paste compiled into 83 chained
steps of at most 512 characters) on the plain A1 replay, bit for bit against the JAX package's
``make_replayer_rle`` in interpret mode on both planes, the block tables,
the origins and the error flag; a seeded two-group case with a long insert
in the middle of a document and groups of very different lengths;
``compile_rle`` against ``bench.py``'s ``_compile_rle`` rule restated;
config 1 (``baseline.run_cpu_baseline``) on sveltecomponent; the north
star's 20 doc groups equal to its one group; and the engine registry
equal to the JAX package's for every engine the port has."""
import dataclasses
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from text_crdt_rust_tpu import config as JC
from text_crdt_rust_tpu.models import native as JN
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import rle as JR
from text_crdt_rust_tpu.utils import testdata as JT
from text_crdt_rust_tpu.utils.randedit import random_patches as j_random
from text_crdt_rust_tpu_torch import baseline, config as TC, convert, \
    corpus, northstar, random_edits
from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch.ops import rle as TR
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA
from text_crdt_rust_tpu_torch.utils.randedit import continue_patches, \
    random_patches
from text_crdt_rust_tpu_torch.utils.testdata import TestPatch

REPO = Path(__file__).resolve().parent.parent
FIELDS = ("ordp", "lenp", "blkord", "rows", "meta", "ol", "orr", "err")
BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain replays are chains of small tensor operations: more
    threads only add overhead and contend with the suite's other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_patches(patches):
    return [JT.TestPatch(p.pos, p.del_len, p.ins_content) for p in patches]


def jax_ops(ops):
    return JB.OpTensors(**{f.name: getattr(ops, f.name)
                           for f in dataclasses.fields(JB.OpTensors)})


def bench_compile_rle(patches, lmax_cap=512):
    """``bench.py``'s ``_compile_rle`` (``bench.py:722-733``), restated on
    the JAX package: merge, compile at min(longest insert, 512), capacity
    2.5 x the dry run's peak in 256-row blocks, at least 512."""
    merged = JB.merge_patches(jax_patches(patches))
    lmax = min(max([len(p.ins_content) for p in merged] + [1]), lmax_cap)
    ops, _ = JB.compile_local_patches(merged, lmax=lmax, dmax=None)
    peak, _final = JR.simulate_run_rows(merged)
    capacity = ((int(peak * 2.5) + 255) // 256) * 256
    return ops, max(capacity, 512), peak


def assert_compiled_as_bench(patches, rs: corpus.RleStream):
    jops, jcap, jpeak = bench_compile_rle(patches)
    assert (rs.capacity, rs.peak_rows) == (jcap, jpeak)
    for f in dataclasses.fields(jops):
        assert np.array_equal(np.asarray(getattr(rs.ops, f.name)),
                              np.asarray(getattr(jops, f.name))), f.name


def assert_replays_equal(streams, capacity, chunk=128):
    """The port's plain A1 replay of ``streams`` (one group each) equals
    the JAX kernel in interpret mode on every output; returns the port's
    results."""
    kw = dict(capacity=capacity, batch=BATCH, block_k=corpus.BLOCK_K,
              chunk=chunk)
    jres = JR.make_replayer_rle([jax_ops(s) for s in streams],
                                interpret=True, **kw)()
    tres = TR.make_replayer_rle(list(streams), device="cpu", **kw)()
    for gi, (j, t) in enumerate(zip(jres, tres)):
        got = convert.rle_result_to_numpy(t)
        for f in FIELDS:
            want = np.asarray(getattr(j, f))
            assert got[f].dtype == want.dtype and \
                np.array_equal(got[f], want), (gi, f)
    assert not np.asarray(jres[0].err).any()
    return tres


def run_rows(res) -> int:
    """Run rows of lane 0 over the blocks in use."""
    nlog = int(res.meta[0, 0])
    return int(res.rows[:nlog, 0].sum())


# -- config 2 -------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_random():
    return random_edits.make_random_edits_stream(2000)


def test_config2_stream_is_the_jax_draw(smoke_random):
    jp, jcontent = j_random(random.Random(42), 2000)
    assert smoke_random.want == jcontent
    assert [(p.pos, p.del_len, p.ins_content)
            for p in smoke_random.patches] == \
        [(p.pos, p.del_len, p.ins_content) for p in jp]
    assert_compiled_as_bench(smoke_random.patches, smoke_random.rle)
    # Random edits barely merge, and fragment: K = 256 with 24 blocks.
    assert (smoke_random.steps, smoke_random.rle.capacity) == (1997, 6144)


def test_config2_replay_matches_jax(smoke_random):
    rs = smoke_random.rle
    (res,) = assert_replays_equal([rs.ops], rs.capacity)
    # Every step's runs, not only the text: the device's run rows are the
    # dry run's final count.
    merged = TB.merge_patches(smoke_random.patches)
    assert run_rows(res) == TR.simulate_run_rows(merged)[1]
    assert TSA.to_string(TR.rle_to_flat(rs.ops, res)) == smoke_random.want


def test_run_random_edits(smoke_random):
    run = random_edits.run_random_edits(batch=BATCH, device="cpu",
                                        stream=smoke_random)
    assert run.ok and run.text_ok and run.lanes_ok and run.native_ok
    assert run.native_text == smoke_random.want
    # Without a device the entry point refuses (the default is CUDA).
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        random_edits.run_random_edits(stream=smoke_random)


# -- config 3 -------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_corpus():
    return corpus.make_corpus_stream(prefix=400)


def test_config3_streams_compile_as_bench(smoke_corpus):
    assert smoke_corpus.names == ["rustcode", "sveltecomponent"]
    for p, rs in zip(smoke_corpus.patches, smoke_corpus.streams):
        assert_compiled_as_bench(p, rs)
    rust = smoke_corpus.streams[0]
    # Rustcode opens with a 42,493-character paste: 82 chained steps of
    # 512 characters and one of 509.
    assert len(smoke_corpus.patches[0][0].ins_content) == 42493
    assert rust.lmax == 512
    ilen = np.asarray(rust.ops.ins_len)
    assert ilen[:83].tolist() == [512] * 82 + [509]
    assert [s.steps for s in smoke_corpus.streams] == [107, 108]


def test_config3_replay_matches_jax(smoke_corpus):
    tres = assert_replays_equal([s.ops for s in smoke_corpus.streams],
                                smoke_corpus.capacity)
    for p, s, r, want in zip(smoke_corpus.patches, smoke_corpus.streams,
                             tres, smoke_corpus.wants):
        # The chained chunks fuse back into runs (the append-merge): the
        # run rows are the dry run's, which never chunks an insert.
        assert run_rows(r) == TR.simulate_run_rows(TB.merge_patches(p))[1]
        assert TSA.to_string(TR.rle_to_flat(s.ops, r)) == want


def test_ragged_groups_with_a_chained_insert_match_jax():
    """Two groups of very different lengths, the long one with a
    1,300-character insert in the middle of its document: the short
    group's padded no-op steps leave its planes and origins exactly as
    the JAX kernel leaves them, and the chained insert stays one run."""
    long_p, text = random_patches(random.Random(14), 300)
    long_p.append(TestPatch(len(text) // 2, 0, "q" * 1300))
    text = northstar.apply_patches(long_p)
    more, _ = continue_patches(random.Random(15), text, 100, 0.5)
    long_p += more
    short_p, _ = random_patches(random.Random(17), 40)
    streams = [corpus.compile_rle(long_p), corpus.compile_rle(short_p)]
    assert streams[0].lmax == 512 and streams[1].steps < \
        streams[0].steps // 4
    cap = max(s.capacity for s in streams)
    tres = assert_replays_equal([s.ops for s in streams], cap)
    for p, s, r in zip((long_p, short_p), streams, tres):
        assert run_rows(r) == TR.simulate_run_rows(TB.merge_patches(p))[1]
        assert TSA.to_string(TR.rle_to_flat(s.ops, r)) == \
            northstar.apply_patches(p)


def test_run_corpus(smoke_corpus):
    run = corpus.run_corpus(batch=BATCH, device="cpu", stream=smoke_corpus)
    assert run.ok and run.text_ok == run.lanes_ok == run.native_ok \
        == [True, True]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        corpus.run_corpus(stream=smoke_corpus)


# -- config 1 and the native checks --------------------------------------------


def test_config1_cpu_baseline():
    base = baseline.run_cpu_baseline("sveltecomponent")
    assert base.ok and base.native_ok and base.rope_ok
    assert len(base.patches) == 19749
    data = JT.load_testing_data(JT.trace_path("sveltecomponent"))
    jdoc = JN.NativeListCRDT()
    jdoc.replay_trace(jdoc.get_or_create_agent_id("bench"),
                      *baseline.patch_lists(base.patches))
    assert jdoc.to_string() == base.native_text == data.end_content
    assert (base.native_spans, base.native_memory_bytes) == \
        (jdoc.num_spans(), jdoc.memory_bytes())
    cols = baseline.patch_columns(base.patches)
    assert all(c.dtype == np.uint32 for c in cols)
    assert JN.rope_replay(*cols)[1] == base.rope_text


@pytest.mark.parametrize("module,args", [
    ("baseline", ["--trace", "sveltecomponent"]),
    ("random_edits", ["--steps", "600", "--batch", "2", "--device", "cpu"]),
    ("corpus", ["--prefix", "200", "--batch", "2", "--device", "cpu"]),
])
def test_cli_on_cpu(module, args):
    out = subprocess.run(
        [sys.executable, "-m", f"text_crdt_rust_tpu_torch.{module}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert '"ok": true' in out.stdout.splitlines()[-1]


# -- the north star at 20 doc groups ---------------------------------------------


def test_northstar_twenty_groups_equal_one():
    """``run_northstar(groups=20)`` on a trace prefix: every group equals
    the one-group run in every output, compared on the device, and the
    native engine reproduces the prefix."""
    stream = northstar.compile_northstar(patches=1500)
    one = northstar.run_northstar(batch=2, stream=stream, device="cpu")
    many = northstar.run_northstar(batch=2, groups=20, stream=stream,
                                   device="cpu")
    assert one.ok and many.ok and many.groups_equal and many.native_ok
    assert len(many.results) == 20
    want = convert.rle_result_to_numpy(one.results[0])
    for r in many.results:
        got = convert.rle_result_to_numpy(r)
        for f in FIELDS:
            assert np.array_equal(got[f], want[f]), f
    # A group that differs is seen.
    many.results[7].lenp[0, 1] += 1
    assert not northstar.groups_equal(many.results)


# -- the engine registry ------------------------------------------------------------

#: Engines of the JAX package the port does not have yet (none left).
MISSING = ()


def test_registry_equals_the_jax_package():
    assert set(TC.ENGINE_REGISTRY) == set(JC.ENGINE_REGISTRY) - set(MISSING)
    for name, spec in TC.ENGINE_REGISTRY.items():
        assert spec == JC.ENGINE_REGISTRY[name], name
    assert TC.ENGINE_ROW_ALIASES == JC.ENGINE_ROW_ALIASES
    keys = {k for spec in JC.ENGINE_REGISTRY.values()
            for k in spec["configs"]}
    for key in sorted(keys):
        want = tuple(e for e in JC.engines_for(key) if e not in MISSING)
        assert TC.engines_for(key) == want, key
    for name in list(JC.ENGINE_REGISTRY) + list(JC.ENGINE_ROW_ALIASES):
        if name not in MISSING:
            assert TC.supports_fused_steps(name) == \
                JC.supports_fused_steps(name), name
    assert TC.engines_for("sp") == ("sp-apply",)
    # Every registered module exists in the port.
    import importlib
    for spec in TC.ENGINE_REGISTRY.values():
        importlib.import_module(f"text_crdt_rust_tpu_torch.{spec['module']}")


def test_config_knobs_equal_the_jax_package():
    for cls in ("BatchConfig", "SoakConfig", "StatsConfig", "MeshConfig",
                "StreamConfig"):
        tj = dataclasses.asdict(getattr(JC, cls)())
        assert dataclasses.asdict(getattr(TC, cls)()) == tj, cls
    eng = dataclasses.asdict(JC.EngineConfig())
    del eng["interpret"]
    assert dataclasses.asdict(TC.EngineConfig()) == eng
    args = ["--edits", "500", "--seed", "3", "--oracle", "100"]
    assert TC.SoakConfig.from_args(args) == TC.SoakConfig(
        edits=500, seed=3, oracle_steps=100)
    assert TC.StatsConfig.from_args(["--trace", "rustcode"]).trace == \
        "rustcode"


def test_stream_config_sets_the_resync_cadence():
    """``run_stream_5``/``run_stream`` take ``StreamConfig`` where they
    took the bare cadence: the same run either way. The cadence has one
    source: giving ``resync_every`` beside ``config`` raises."""
    from text_crdt_rust_tpu_torch import stream as TS

    s5 = TS.make_stream_5(4, 3, 10, 1000)
    bare = TS.run_stream_5(stream=s5, block_k=64, resync_every=2,
                           device="cpu")
    run = TS.run_stream_5(stream=s5, block_k=64,
                          config=TC.StreamConfig(resync_every=2),
                          device="cpu")
    assert run.ok and bare.ok
    assert run.stats.resyncs == bare.stats.resyncs == 1
    for a, b in zip(run.result.state(), bare.result.state()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TS.run_stream_5(stream=s5, block_k=64, resync_every=2,
                        config=TC.StreamConfig(), device="cpu")
    s5r = TS.make_stream_5r(4, 3, 10, 7000)
    run = TS.run_stream(stream=s5r, config=TC.StreamConfig(), device="cpu")
    assert run.ok and run.stats.resyncs == 2
    assert TS.run_stream(stream=s5r, device="cpu").stats.resyncs == 0
