"""The port's closed-loop serve loadgen against the JAX package's, on the
CPU: the same seed gives the same report logical fields, every document's
string and ``state_digest``, and the same sha256 of the logical trace
stream, at pipeline depths 1 and 2. The JAX side runs through the golden
record's own script (``tests/data/make_serve_golden.py``) at a small
shape. The acceptance shape's committed record is held against the
port's run on the card (``chip_smoke.py``): on the CPU under the suite's
load the plain version's run takes minutes."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from text_crdt_rust_tpu_torch.config import ServeConfig
from text_crdt_rust_tpu_torch.serve import DocServer
from text_crdt_rust_tpu_torch.serve.loadgen import (
    ServeLoadGen,
    logical_report,
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests" / "data"))

import make_serve_golden as golden  # noqa: E402

SMALL = dict(docs=10, agents_per_doc=2, ticks=8, events_per_tick=10,
             zipf_alpha=1.1, fault_rate=0.10, local_prob=0.25, seed=11)
SMALL_CFG = dict(engine="rle-lanes-mixed", num_shards=1, lanes_per_shard=4,
                 lane_capacity=128, lanes_block_k=8, order_capacity=512,
                 step_buckets=(8, 32), max_txn_len=32)
GOLDEN = REPO / "tests" / "data" / "serve_lanes_golden.json"


def port_record(params, cfg_kw, depth, **kw):
    cfg = ServeConfig(pipeline_ticks=depth, trace_keep=True, **cfg_kw)
    gen = ServeLoadGen(cfg=cfg, device="cpu", **params, **kw)
    report = gen.run()
    assert report["converged"], report["mismatches"]
    assert report["pipeline"]["ticks"] == depth
    return gen, report, golden.record_of(gen, report)


def assert_matches(rec, want):
    assert rec["trace_sha256"] == want["trace_sha256"]
    assert rec["trace_events"] == want["trace_events"]
    assert rec["docs"] == want["docs"]
    assert rec["logical"] == want["logical"]


@pytest.fixture(scope="module")
def small_golden():
    """The golden script's JAX records at the small shape, both depths
    (in this process: one JAX compile serves both)."""
    return {str(d): golden.jax_record(SMALL, SMALL_CFG, d) for d in (1, 2)}


@pytest.mark.parametrize("depth", [1, 2])
def test_small_loadgen_equals_the_jax_package(small_golden, depth):
    gen, report, rec = port_record(SMALL, SMALL_CFG, depth)
    assert_matches(rec, small_golden[str(depth)])
    assert report["server"]["evictions"] >= 1
    for b in gen.server.residency.backends:
        assert b.shapes_seen <= set(SMALL_CFG["step_buckets"])


def test_golden_record_depths_agree():
    """The committed acceptance-shape record: the JAX package's runs at
    depths 1 and 2 agree on every logical field (the depth contract), and
    its parameters are the script's."""
    g = json.loads(GOLDEN.read_text())
    assert g["params"] == golden.ACCEPTANCE
    assert g["cfg"] == golden.ACCEPTANCE_CFG
    d1, d2 = g["depths"]["1"], g["depths"]["2"]
    assert d1 == d2
    assert d1["logical"]["converged"]
    assert d1["logical"]["server"]["evictions"] >= 20
    assert len(d1["docs"]) == golden.ACCEPTANCE["docs"]


def test_walls_only_from_the_callers_clock():
    """With a clock the report and the trace carry walls; the logical
    projection and stream are unchanged."""
    ticks = [0.0]

    def clock():
        ticks[0] += 0.001
        return ticks[0]

    _, plain, rec0 = port_record(SMALL, SMALL_CFG, 2)
    gen, timed, rec1 = port_record(SMALL, SMALL_CFG, 2, clock=clock)
    assert plain["wall_s"] is None and plain["latency_us"] == {}
    assert timed["wall_s"] > 0 and timed["latency_us"]["samples"] > 0
    assert timed["tick_ms"]["samples"] > 0
    assert rec0 == rec1
    assert logical_report(plain) == logical_report(timed)
    assert any("w" in ev for ev in gen.server.tracer.events)


def test_flat_engine_and_unported_options_refuse(tmp_path):
    """The flat slice is in: ``ServeConfig()``'s flat engine builds, and
    ``journal_dir``, ``profile_dir`` and ``recover()`` work; an engine
    outside the registry still raises."""
    srv = DocServer(ServeConfig(), device="cpu")
    assert srv.residency.backends[0].engine == "flat"
    srv.close_obs()
    with pytest.raises(ValueError, match="unknown engine"):
        DocServer(ServeConfig(engine="definitely-not-an-engine"),
                  device="cpu")
    # ``rle`` is registered (configs northstar, 2 and 3) but serves no
    # lanes, as in the JAX package's registry.
    with pytest.raises(ValueError, match="no serve lane backend"):
        DocServer(ServeConfig(engine="rle"), device="cpu")
    cfg = ServeConfig(num_shards=1, lanes_per_shard=2,
                      journal_dir=str(tmp_path / "j"),
                      profile_dir=str(tmp_path / "p"), profile_ticks=2,
                      spool_dir=str(tmp_path / "s"), trace_keep=True)
    gen = ServeLoadGen(cfg=cfg, device="cpu", docs=3, agents_per_doc=2,
                       ticks=4, events_per_tick=6, seed=5)
    assert gen.run()["converged"]
    assert (tmp_path / "p" / "trace.json").exists()
    assert gen.server.counters.get("profile_errors") == 0
    actions = [ev.get("action") for ev in gen.server.tracer.events
               if ev.get("k") == "profile"]
    assert actions[:2] == ["start", "stop"]
    srv = DocServer(ServeConfig(num_shards=1, lanes_per_shard=2,
                                journal_dir=str(tmp_path / "j"),
                                spool_dir=str(tmp_path / "s2")),
                    device="cpu")
    stats = srv.recover()
    assert stats["docs"] == 3 and stats["refusals"] == 0
    srv.close_obs()


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "text_crdt_rust_tpu_torch.serve.loadgen",
         *args], cwd=REPO, capture_output=True, text=True, timeout=300)


def test_cli_runs_on_cpu_and_refuses_flat():
    """The CLI runs both engines on the CPU; with no ``--engine`` it runs
    the flat engine (``ServeConfig()``'s default) and converges."""
    out = _cli("--engine", "rle-lanes-mixed", "--docs", "24", "--ticks",
               "10", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    report = json.loads(out.stdout)
    assert report["converged"] and report["engine"] == "rle-lanes-mixed"
    assert report["wall_s"] is None
    out = _cli("--docs", "24", "--ticks", "10", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    report = json.loads(out.stdout)
    assert report["converged"] and report["engine"] == "flat"
    out = _cli("--engine", "definitely-not-an-engine", "--docs", "2",
               "--ticks", "1", "--device", "cpu")
    assert out.returncode != 0 and "unknown engine" in out.stderr
