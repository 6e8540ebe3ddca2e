"""The config-5 path on the port (``stream.py``: divergent per-document local
streams on the blocked per-lane engine) against the JAX package, on the
CPU, at ``bench.py --smoke`` size: 16 documents x 3 chunks x 30 patches,
``resync_every`` 2, K = 64.

- The stream: ``make_stream_5`` generates and compiles the op columns
  ``bench.py`` ``cfg_5`` builds (``random.Random(1000 + d)``, its
  ``_continue_patches``, the JAX package's ``compile_local_patches`` with
  ``lmax`` over the stream and each chunk's orders following the last).
- The chain: ``run_stream_5(device="cpu")`` equals the JAX package's
  blocked chain in interpret mode, state tuple for state tuple, after
  every chunk, through the checkpoint round trip.
- The texts: every document's text, rebuilt from its runs and the staged
  chars, equals the string simulation; the un-blocked engine gives the
  same documents; the ``--config 5`` CLI works.

Tolerance: none, everything is integers and strings.
"""
import dataclasses
import json
import random

import numpy as np
import pytest

import bench
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import rle_lanes as JL
from text_crdt_rust_tpu_torch import convert, stream
from text_crdt_rust_tpu_torch.ops import rle_lanes as TL

SMOKE = dict(n_docs=16, chunks=3, steps_per_chunk=30)


def _jax_stream(n_docs, chunks, steps_per_chunk, seed_base=1000):
    """bench.py ``cfg_5``'s generation and compile on the JAX package:
    (stacked chunks, contents)."""
    rngs = [random.Random(seed_base + d) for d in range(n_docs)]
    contents = [""] * n_docs
    all_chunks = []
    for _ in range(chunks):
        per_doc = []
        for d in range(n_docs):
            patches, contents[d] = bench._continue_patches(
                rngs[d], contents[d], steps_per_chunk, ins_prob=0.45)
            per_doc.append(patches)
        all_chunks.append(per_doc)
    lmax = max((len(p.ins_content) for ch in all_chunks for ps in ch
                for p in ps), default=1) or 1
    next_orders = [0] * n_docs
    stacked = []
    for per_doc in all_chunks:
        opses = []
        for d, patches in enumerate(per_doc):
            ops, next_orders[d] = JB.compile_local_patches(
                patches, lmax=lmax, dmax=None, start_order=next_orders[d])
            opses.append(ops)
        stacked.append(JB.stack_ops(opses))
    return stacked, contents


@pytest.fixture(scope="module")
def smoke_stream():
    return stream.make_stream_5(**SMOKE)


def test_stream_compiles_as_bench(smoke_stream):
    jstacked, jcontents = _jax_stream(**SMOKE)
    assert smoke_stream.contents == jcontents
    assert smoke_stream.lmax == 4 and smoke_stream.n_patches == 16 * 3 * 30
    for t, j in zip(smoke_stream.stacked, jstacked):
        for f in dataclasses.fields(t):
            assert np.array_equal(getattr(t, f.name),
                                  np.asarray(getattr(j, f.name))), f.name
    assert stream.stream_capacities_5(smoke_stream, 64) == [256, 256, 256]


def test_full_size_capacities():
    """The capacities of ``bench.py`` ``cfg_5`` at full size: 256 run rows
    after chunk 0, growing by 3 blocks a chunk to 1,664 (NB 26)."""
    full = stream.Stream5(n_docs=1, steps_per_chunk=100, lmax=4,
                          contents=[""], stacked=[None] * 8, n_patches=0)
    assert stream.stream_capacities_5(full, 64) == [
        256, 448, 640, 832, 1024, 1216, 1408, 1664]


def test_run_stream_5_matches_the_jax_chain(smoke_stream):
    """The port's chain (checkpoint round trip after chunk 2 included)
    equals the JAX package's blocked chain after every chunk."""
    got = []
    run = stream.run_stream_5(
        resync_every=2, device="cpu", stream=smoke_stream,
        on_chunk=lambda ci, res: got.append(
            convert.lanes_state_to_numpy(res.state())
            | {"ol": res.ol.numpy(), "orr": res.orr.numpy(),
               "err": res.err.numpy()}))
    assert run.ok and run.stats.resyncs == 1 and run.stats.checked == 3
    caps = stream.stream_capacities_5(smoke_stream, 64)
    state = None
    for ci, (st, cap) in enumerate(zip(smoke_stream.stacked, caps)):
        jst = JB.OpTensors(**{f.name: getattr(st, f.name)
                              for f in dataclasses.fields(st)})
        jres = JL.make_replayer_lanes_blocked(
            jst, capacity=cap, block_k=64, chunk=128, interpret=True)(state)
        state = jres.state()
        for k, v in got[ci].items():
            j = np.asarray(getattr(jres, k))
            if j.dtype == np.uint32:
                j = j.view(np.int32)
            assert v.shape == j.shape and np.array_equal(v, j), (ci, k)
    for d in range(smoke_stream.n_docs):
        assert stream.lane_text(smoke_stream, run.result, d) == \
            smoke_stream.contents[d], d


def test_unblocked_engine_equals_blocked_on_the_stream(smoke_stream):
    blk = stream.run_stream_5(resync_every=2, device="cpu",
                              stream=smoke_stream)
    unb = stream.run_stream_5(resync_every=2, device="cpu",
                              stream=smoke_stream, engine="unblocked")
    assert blk.ok and unb.ok
    assert isinstance(unb.result, TL.LanesResult)
    for d in range(smoke_stream.n_docs):
        assert TL.expand_lane(blk.result, d).tolist() == \
            TL.expand_lane(unb.result, d).tolist(), d
    for f in ("ol", "orr", "rows"):
        assert np.array_equal(getattr(blk.result, f).numpy(),
                              getattr(unb.result, f).numpy()), f


def test_step_latency_5_counts_every_chunk():
    tiny = stream.make_stream_5(n_docs=2, chunks=3, steps_per_chunk=8)
    ticks = iter(range(1000))
    lat = stream.step_latency_5(stream.stream_replayers_5(tiny,
                                                          device="cpu"),
                                tiny.real_steps, clock=lambda: next(ticks))
    assert len(lat["samples_us"]) == 3
    assert lat["p50_us"] == lat["p99_us"] == 1e6 / 8
    with pytest.raises(ValueError, match="unknown engine"):
        stream.stream_replayers_5(tiny, engine="other", device="cpu")


def test_stream_cli_config_5(capsys):
    assert stream.main(["--config", "5", "--docs", "4", "--chunks", "2",
                        "--steps", "10", "--resync-every", "1",
                        "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["config"] == "5" and out["device"] == "cpu"
    assert out["resyncs"] == 1 and out["patches"] == 4 * 2 * 10
    assert out["real_steps"] == [10, 10] and out["device_steps"] == 256
