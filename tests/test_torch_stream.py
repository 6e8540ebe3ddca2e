"""The config-5r path on the port (``stream.py``) against the JAX
package, on the CPU.

- The generator: the port's ``continue_patches`` and ``PeerSynth`` give
  ``bench.py``'s ``_continue_patches`` and ``_PeerSynth`` patches and txns
  for the same seeds, and its ``random_patches`` draws the JAX package's
  patches from one ``random.Random`` seed.
- The compile: ``make_stream_5r`` stacks the same op columns as the JAX
  package's compiler on bench.py's txns.
- The chain: ``run_stream(device="cpu")`` at bench.py's ``--smoke`` size
  (16 documents x 3 chunks x 30 patches, ``resync_every`` 2, K = 64)
  equals the JAX package's blocked chain in interpret mode, state tuple
  for state tuple, after every chunk, through the checkpoint round trip;
  the sampled documents equal the oracle.

Tolerance: none, everything is integers and strings.
"""
import dataclasses
import json
import random

import numpy as np
import pytest

import bench
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import rle_lanes_mixed as JM
from text_crdt_rust_tpu.utils.randedit import random_patches as j_random
from text_crdt_rust_tpu_torch import convert, stream
from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as TM
from text_crdt_rust_tpu_torch.utils import randedit

SMOKE = dict(n_docs=16, chunks=3, steps_per_chunk=30)


def _patch_tuples(patches):
    return [(p.pos, p.del_len, p.ins_content) for p in patches]


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_patches_draw_as_the_jax_package(seed):
    t = randedit.random_patches(random.Random(seed), 80)
    j = j_random(random.Random(seed), 80)
    assert _patch_tuples(t[0]) == _patch_tuples(j[0]) and t[1] == j[1]


@pytest.mark.parametrize("seed", [7000, 7005, 7013])
def test_continue_patches_and_peer_synth_match_bench(seed):
    t_rng, j_rng = random.Random(seed), random.Random(seed)
    t_text = j_text = ""
    t_peer, j_peer = randedit.PeerSynth("peer5"), bench._PeerSynth("peer5")
    for _ in range(4):
        tp, t_text = randedit.continue_patches(t_rng, t_text, 40, 0.45)
        jp, j_text = bench._continue_patches(j_rng, j_text, 40, 0.45)
        assert _patch_tuples(tp) == _patch_tuples(jp) and t_text == j_text
        tt = [dataclasses.asdict(x) for x in t_peer.apply(tp)]
        jt = [dataclasses.asdict(x) for x in j_peer.apply(jp)]
        assert tt == jt


def _jax_stream(n_docs, chunks, steps_per_chunk, seed_base=7000, lmax=4):
    """bench.py ``cfg_5_remote``'s generation and compile, on the JAX
    package: (stacked chunks padded to the suite-wide step count, real
    steps)."""
    rngs = [random.Random(seed_base + d) for d in range(n_docs)]
    contents = [""] * n_docs
    synths = [bench._PeerSynth(f"peer{d}") for d in range(n_docs)]
    tables = [JB.AgentTable([f"peer{d}"]) for d in range(n_docs)]
    assigners = [None] * n_docs
    stacked = []
    for _ in range(chunks):
        opses = []
        for d in range(n_docs):
            patches, contents[d] = bench._continue_patches(
                rngs[d], contents[d], steps_per_chunk, ins_prob=0.45)
            ops, assigners[d] = JB.compile_remote_txns(
                synths[d].apply(patches), tables[d], assigner=assigners[d],
                lmax=lmax, dmax=None)
            opses.append(ops)
        stacked.append(JB.stack_ops(opses))
    real = [s.num_steps for s in stacked]
    smax = ((max(real) + 127) // 128) * 128
    return [JB.pad_ops(s, smax) for s in stacked], real, contents


@pytest.fixture(scope="module")
def smoke_stream():
    return stream.make_stream_5r(**SMOKE)


def test_stream_compiles_as_the_jax_package(smoke_stream):
    jstacked, jreal, jcontents = _jax_stream(**SMOKE)
    assert smoke_stream.real_steps == jreal
    assert smoke_stream.contents == jcontents
    for t, j in zip(smoke_stream.stacked, jstacked):
        for f in dataclasses.fields(t):
            assert np.array_equal(getattr(t, f.name),
                                  np.asarray(getattr(j, f.name))), f.name


def test_run_stream_matches_the_jax_chain(smoke_stream):
    """The port's chain (checkpoint round trip after chunk 2 included)
    equals the JAX package's blocked chain after every chunk."""
    caps, ocaps = stream.stream_capacities(smoke_stream, 64)
    got = []
    run = stream.run_stream(
        resync_every=2, device="cpu", stream=smoke_stream,
        on_chunk=lambda ci, res: got.append(
            convert.lanes_state_to_numpy(res.state())
            | {"ol": res.ol.numpy(), "orr": res.orr.numpy(),
               "err": res.err.numpy()}))
    assert run.ok and run.stats.resyncs == 1 and run.stats.checked == 3
    state = None
    for ci, (st, cap, ocap) in enumerate(zip(smoke_stream.stacked, caps,
                                             ocaps)):
        jst = JB.OpTensors(**{f.name: getattr(st, f.name)
                              for f in dataclasses.fields(st)})
        jres = JM.make_replayer_lanes_mixed_blocked(
            jst, capacity=cap, block_k=64, order_capacity=ocap, chunk=128,
            interpret=True)(state)
        state = jres.state()
        for k, v in got[ci].items():
            j = np.asarray(getattr(jres, k))
            if j.dtype == np.uint32:
                j = j.view(np.int32)
            assert v.shape == j.shape and np.array_equal(v, j), (ci, k)


def test_unblocked_engine_equals_blocked_on_the_stream(smoke_stream):
    blk = stream.run_stream(resync_every=2, device="cpu",
                            stream=smoke_stream)
    unb = stream.run_stream(resync_every=2, device="cpu",
                            stream=smoke_stream, engine="unblocked")
    assert blk.ok and unb.ok
    from text_crdt_rust_tpu_torch.ops.rle_lanes import expand_lane
    for d in range(smoke_stream.n_docs):
        assert expand_lane(blk.result, d).tolist() == \
            expand_lane(unb.result, d).tolist(), d
    for f in ("ol", "orr", "oll", "orl"):
        assert np.array_equal(getattr(blk.result, f).numpy(),
                              getattr(unb.result, f).numpy()), f


def test_stream_loop_times_only_with_a_clock(tmp_path):
    tiny = stream.compile_5r(*stream.generate_5r(2, 3, 8))
    assert tiny.chunks == 3 and tiny.n_docs == 2
    ticks = iter(range(1000))
    runners = stream.make_stream_replayers(tiny, device="cpu")
    res, stats = stream.stream_loop(
        runners, 2, str(tmp_path / "ck.npz"), stream.STATE_KEYS["blocked"],
        clock=lambda: float(next(ticks)))
    assert stats.resyncs == 1 and stats.checked == 3
    assert stats.wall_s is not None and stats.ckpt_ms is not None
    assert isinstance(res, TM.BlockedLanesMixedResult)
    _, plain = stream.stream_loop(
        stream.make_stream_replayers(tiny, device="cpu"), 2,
        str(tmp_path / "ck2.npz"), stream.STATE_KEYS["blocked"])
    assert plain.checked == 3 and plain.wall_s is None


def test_stream_cli(capsys):
    assert stream.main(["--docs", "4", "--chunks", "2", "--steps", "10",
                        "--resync-every", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["device"] == "cpu" and out["resyncs"] == 1


def test_sync_stream_example_on_cpu():
    from text_crdt_rust_tpu_torch.examples import sync_stream

    lines = []
    counts = sync_stream.run(docs=3, chunks=2, ops_per_chunk=8,
                             device="cpu", log=lines.append)
    assert counts["replays"] == 2 and counts["txns"] > 0
    assert "every chunk oracle-checked" in lines[-1]
