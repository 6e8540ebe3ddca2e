"""The port's trace analytics (``text_crdt_rust_tpu_torch.obs.analyze``)
against the JAX package's ``obs/analyze.py``: every case of
``tests/test_obs_analyze.py`` on the committed fixtures (the port's
reports equal the golden record and the JAX functions' outputs), every
report on a trace the port's own loadgen writes on the CPU with a
counting clock, and the CLI end to end with the JAX CLI's exit codes."""
import itertools
import json
import os
import subprocess
import sys

import pytest

from text_crdt_rust_tpu.obs import analyze as JA
from text_crdt_rust_tpu.obs import flow as JF
from text_crdt_rust_tpu_torch.config import ServeConfig
from text_crdt_rust_tpu_torch.obs import analyze as A
from text_crdt_rust_tpu_torch.obs.flow import flow_report
from text_crdt_rust_tpu_torch.obs.trace import WALL_KEY, validate_event
from text_crdt_rust_tpu_torch.serve.loadgen import ServeLoadGen

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURE = os.path.join(HERE, "data", "obs_trace_fixture.jsonl")
FIXTURE_B = os.path.join(HERE, "data", "obs_trace_fixture_b.jsonl")
GOLDEN = os.path.join(HERE, "data", "obs_trace_fixture_golden.json")
CLI = [sys.executable, "-m", "text_crdt_rust_tpu_torch.obs.analyze"]
JCLI = [sys.executable, "-m", "text_crdt_rust_tpu.obs.analyze"]

#: A small serve run on the flat engine (two shards of three lanes).
SMALL = dict(docs=10, agents_per_doc=2, ticks=8, events_per_tick=10,
             zipf_alpha=1.1, fault_rate=0.10, local_prob=0.25)
SMALL_CFG = dict(engine="flat", num_shards=2, lanes_per_shard=3,
                 lane_capacity=128, order_capacity=512,
                 step_buckets=(8, 32), max_txn_len=32, flow_sample_mod=1)


def events():
    return A.load_events([FIXTURE])


def golden():
    with open(GOLDEN) as f:
        return json.load(f)


# -- the JAX package's cases, on the committed fixtures -----------------------


def test_fixture_is_schema_valid():
    evs = events()
    assert evs == JA.load_events([FIXTURE])
    assert evs[0]["k"] == "trace.header"
    for ev in evs:
        validate_event(ev)
    kinds = {e["k"] for e in evs}
    assert {"apply", "tick.fuse", "device.compile",
            "tick.device", "tick.barrier"} <= kinds


def test_phase_breakdown_matches_golden():
    d = A.phase_breakdown(events())
    assert d == golden()["phases"] == JA.phase_breakdown(events())
    assert set(d["phases"]) == set(A.PHASES) == set(JA.PHASES)
    assert d["ticks"] > 0
    assert abs(sum(p["share_pct"] for p in d["phases"].values())
               - 100.0) < 0.5


def test_hotdocs_fuse_recompiles_match_golden():
    g, evs = golden(), events()
    assert A.hot_docs(evs, top=5) == g["hotdocs"] == JA.hot_docs(evs, top=5)
    fuse = A.fusion_table(evs, top=5)
    assert fuse == g["fuse"] == JA.fusion_table(evs, top=5)
    assert fuse["rows_saved"] == fuse["steps_in"] - fuse["steps_out"]
    rec = A.recompile_timeline(evs)
    assert rec == g["recompiles"] == JA.recompile_timeline(evs)
    assert rec["compiles"] >= 1
    assert rec["last_compile_tick"] <= rec["run_last_tick"]


def test_two_trace_diff_names_first_diverging_event():
    a, b = events(), A.load_events([FIXTURE_B])
    assert A.trace_diff(a, a) is None
    d = A.trace_diff(a, b)
    assert d == golden()["diff_vs_b"] == JA.trace_diff(a, b)
    assert d["fields"] == ["n"]
    assert d["a"]["k"] == "apply"
    assert d["index"] == d["a"]["i"]


def test_diff_ignores_wall_and_catches_length_drift():
    a = events()
    walled = [dict(e) for e in a]
    for e in walled:
        e[WALL_KEY] = {"ms": 123.0}
    assert A.trace_diff(a, walled) is None
    d = A.trace_diff(a, a[:-1])
    assert d == JA.trace_diff(a, a[:-1])
    assert d["only_in"] == "a" and d["index"] == len(a) - 1


def test_chrome_export_is_valid_trace_event_json():
    doc = A.chrome_trace(events())
    assert doc == JA.chrome_trace(events())
    doc = json.loads(json.dumps(doc))
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    spans = 0
    for te in doc["traceEvents"]:
        assert "name" in te and "ph" in te and "pid" in te
        assert te["ph"] in ("X", "i", "M")
        if te["ph"] != "M":
            assert isinstance(te["ts"], (int, float))
        if te["ph"] == "X":
            spans += 1
            assert te["dur"] >= 0
    assert spans >= 4
    first_span = next(t for t in doc["traceEvents"] if t["ph"] == "X")
    assert first_span["ts"] >= A.CHROME_TICK_US


def test_load_events_reads_bundles_and_segment_lists(tmp_path):
    evs = events()
    bundle = str(tmp_path / "bundle_x.json")
    with open(bundle, "w") as f:
        json.dump({"schema_version": 1, "reason": "divergence",
                   "events": evs[:10]}, f, indent=1)
    assert A.load_events([bundle]) == evs[:10] == JA.load_events([bundle])
    seg1, seg2 = str(tmp_path / "t.jsonl"), str(tmp_path / "t.jsonl.1")
    lines = open(FIXTURE).read().splitlines()
    with open(seg1, "w") as f:
        f.write("\n".join(lines[:20]) + "\n")
    with open(seg2, "w") as f:
        f.write("\n".join(lines[20:]) + "\n")
    assert A.load_events([seg1, seg2]) == evs


def test_load_events_keeps_prefix_of_crash_truncated_segment(tmp_path):
    lines = open(FIXTURE).read().splitlines()
    trunc = str(tmp_path / "trunc.jsonl")
    with open(trunc, "w") as f:
        f.write("\n".join(lines[:30]) + "\n" + lines[30][:17])
    assert A.load_events([trunc]) == events()[:30] == \
        JA.load_events([trunc])
    corrupt = str(tmp_path / "corrupt.jsonl")
    with open(corrupt, "w") as f:
        f.write("\n".join(lines[:10]) + "\n{not json}\n"
                + "\n".join(lines[10:]) + "\n")
    assert A.load_events([corrupt]) == events()[:10]


def test_stall_budget_names_top_phase():
    d = A.phase_breakdown(events())
    b = A.stall_budget(d)
    assert b == JA.stall_budget(d)
    assert b["phase"] in A.PHASES
    assert b["wall_ms"] == d["phases"][b["phase"]]["wall_ms"]
    assert b["wall_ms"] == max(r["wall_ms"] for r in d["phases"].values())
    assert b["share_pct"] == d["phases"][b["phase"]]["share_pct"]
    empty = A.stall_budget(A.phase_breakdown([]))
    assert empty["phase"] is None and empty["wall_ms"] == 0.0
    assert empty == JA.stall_budget(JA.phase_breakdown([]))


def test_overlap_report_accounting():
    evs = [
        {"i": 0, "t": 1, "k": "tick.drain", "shard": 0, "events": 3,
         "steps": 5, WALL_KEY: {"ms": 4.0}},
        {"i": 1, "t": 1, "k": "residency.evict", "doc": "d", "ckpt":
         "delta", "bytes": 10, WALL_KEY: {"ms": 2.0}},
        {"i": 2, "t": 1, "k": "tick.device", "shard": 0, "bucket": 8,
         "lanes": 1, "steps": 5, WALL_KEY: {"ms": 1.0}},
        {"i": 3, "t": 1, "k": "tick.barrier", "shard": 0,
         WALL_KEY: {"ms": 3.0, "win": 9.0}},
        {"i": 4, "t": 2, "k": "tick.drain", "shard": 0, "events": 1,
         "steps": 1, WALL_KEY: {"ms": 6.0}},
        {"i": 5, "t": 2, "k": "tick.barrier", "shard": 0,
         WALL_KEY: {"ms": 1.0, "win": 7.0}},
    ]
    d = A.overlap_report(evs)
    assert d == JA.overlap_report(evs)
    assert d["ticks"] == 2
    assert d["host_ms"] == 12.0
    assert d["dispatch_ms"] == 1.0
    assert d["stall_ms"] == 4.0
    assert d["win_ms"] == 16.0
    assert d["overlap_frac"] == round(16.0 / 20.0, 4)
    assert d["idle_gap_ms"]["max"] == 3.0
    assert d["worst_ticks"][0]["tick"] == 1
    serial = A.overlap_report([
        {"i": 0, "t": 1, "k": "tick.barrier", "shard": 0,
         WALL_KEY: {"ms": 5.0}}])
    assert serial["overlap_frac"] == 0.0
    assert serial["stall_share_pct"] == 100.0
    assert A.overlap_report(events()) == JA.overlap_report(events())


# -- a trace the port's loadgen writes ------------------------------------------


def _counting_clock():
    """Walls that advance 0.25 ms a read: deterministic, and nonzero."""
    ticks = itertools.count()
    return lambda: next(ticks) * 0.00025


def _port_trace(tmp_path, seed, depth):
    path = str(tmp_path / f"trace_s{seed}_d{depth}.jsonl")
    cfg = ServeConfig(pipeline_ticks=depth, trace_path=path, **SMALL_CFG)
    gen = ServeLoadGen(cfg=cfg, device="cpu", seed=seed,
                       clock=_counting_clock(), **SMALL)
    rep = gen.run()
    assert rep["converged"], rep["mismatches"]
    gen.server.tracer.close()
    return path


@pytest.fixture(scope="module")
def port_traces(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_traces")
    return {"a": _port_trace(tmp, 11, 2), "b": _port_trace(tmp, 12, 2),
            "a1": _port_trace(tmp, 11, 1)}


def test_every_report_equals_jax_on_a_port_trace(port_traces):
    for key in ("a", "a1"):
        evs = A.load_events([port_traces[key]])
        assert evs == JA.load_events([port_traces[key]])
        kinds = {e["k"] for e in evs}
        assert {"tick.drain", "tick.device", "tick.barrier",
                "device.compile", "apply", "flow.emit",
                "flow.apply"} <= kinds, kinds
        assert any(WALL_KEY in e for e in evs)
        ph = A.phase_breakdown(evs)
        assert ph == JA.phase_breakdown(evs)
        assert ph["wall_ms_total"] > 0
        assert A.stall_budget(ph) == JA.stall_budget(ph)
        ov = A.overlap_report(evs)
        assert ov == JA.overlap_report(evs)
        assert A.hot_docs(evs) == JA.hot_docs(evs)
        assert A.fusion_table(evs) == JA.fusion_table(evs)
        rec = A.recompile_timeline(evs)
        assert rec == JA.recompile_timeline(evs)
        assert rec["compiles"] >= 1
        assert A.chrome_trace(evs) == JA.chrome_trace(evs)
        fl = flow_report(evs, expect_terminal=True)
        assert fl == JF.flow_report(evs, expect_terminal=True)
        assert fl["audit_ok"], fl["findings"][:3]
    ov2 = A.overlap_report(A.load_events([port_traces["a"]]))
    assert ov2["win_ms"] > 0  # depth 2 stamps the overlap window


def test_diff_between_two_seeds_equals_jax(port_traces):
    a = A.load_events([port_traces["a"]])
    b = A.load_events([port_traces["b"]])
    d = A.trace_diff(a, b)
    assert d is not None and d == JA.trace_diff(a, b)
    assert A.trace_diff(a, a) is None


# -- the CLI ---------------------------------------------------------------------


def _both(capsys, args):
    """Both CLIs' ``main`` in this process: (exit code, stdout, stderr)
    each."""
    out = []
    for main in (A.main, JA.main):
        rc = main(args)
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def test_cli_end_to_end(tmp_path, capsys, port_traces):
    """Every subcommand through both CLIs: the same exit codes and the
    same ``--json`` documents; a crash-truncated segment reads as its
    prefix; ``flow --audit`` gives the JAX CLI's exit code on a
    conserved trace and on one cut mid-run; the module runs as
    ``python -m``."""
    lines = open(port_traces["a"]).read().splitlines()
    trunc = str(tmp_path / "trunc.jsonl")
    with open(trunc, "w") as f:
        f.write("\n".join(lines[:len(lines) // 2]) + "\n"
                + lines[len(lines) // 2][:23])
    for args in (["phases", FIXTURE, "--json"],
                 ["phases", port_traces["a"], "--stall-budget", "--json"],
                 ["overlap", port_traces["a"], "--json"],
                 ["hotdocs", port_traces["a"], "--json", "--top", "3"],
                 ["fuse", FIXTURE, "--json"],
                 ["recompiles", trunc, "--json"],
                 ["flow", port_traces["a"], "--audit", "--json"],
                 ["flow", trunc, "--audit", "--json"],
                 ["diff", FIXTURE, FIXTURE_B, "--json"],
                 ["diff", port_traces["a"], port_traces["a"], "--json"]):
        (rc, so, se), (jrc, jso, jse) = _both(capsys, args)
        assert rc == jrc, (args, se[-600:])
        assert json.loads(so) == json.loads(jso), args
    (rc, so, se), (jrc, _, _) = _both(capsys, ["flow", port_traces["a"],
                                               "--audit"])
    assert rc == jrc == 0 and "conservation audit OK" in se
    (rc, so, se), (jrc, _, _) = _both(capsys, ["phases", trunc, "--json"])
    assert rc == jrc == 0
    assert "truncated/corrupt line" in se
    assert json.loads(so) == A.phase_breakdown(A.load_events([trunc]))
    for args in (["phases", port_traces["a"], "--stall-budget"],
                 ["overlap", port_traces["a"]], ["hotdocs", FIXTURE],
                 ["fuse", FIXTURE], ["recompiles", FIXTURE],
                 ["flow", port_traces["a"]],
                 ["diff", FIXTURE, FIXTURE_B]):
        (rc, so, _), (jrc, jso, _) = _both(capsys, args)
        assert rc == jrc and so == jso, args
    out = str(tmp_path / "chrome.json")
    assert A.main(["chrome", port_traces["a"], "-o", out]) == 0
    with open(out) as f:
        assert json.load(f) == JA.chrome_trace(
            JA.load_events([port_traces["a"]]))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(CLI + ["diff", FIXTURE, FIXTURE_B],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO, env=env)
    assert r.returncode == 1
    assert "first divergence at event" in r.stdout
    assert "RuntimeWarning" not in r.stderr
