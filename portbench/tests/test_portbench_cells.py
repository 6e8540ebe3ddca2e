"""Whole runs of tiny cells on the CPU (the plain replay under the
window): the result line's keys, the check, a cell, a configuration, a
traffic mix and a metric added as new files, and no result without a
card."""
import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import spec
from portbench.run import forbidden_modules, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(tree, name, trace=False, wrap=None, seed=2**35 + 11):
    cell = spec.load_cell(name, root=tree.parent, here=tree)
    return run_cell(cell, seed, 0.3, trace, torch.device("cpu"), tree,
                    wrap=wrap, t0=time.perf_counter())


@pytest.mark.parametrize("name", ["tiny-trace", "tiny-edits"])
def test_result_line(tree, name):
    r = run(tree, name)
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == KEYS and list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"ops_per_s", "replay_p95_ms",
                                    "setup_s"}  # no card: no memory
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["check"]["docs_unjudged"] == {"value": 0, "limit": 0}
    assert all(v["value"] <= v["limit"] for v in line["check"].values())
    assert not forbidden_modules()


def test_traced_line_reports_the_per_layer_metrics_it_can_read(tree):
    r = run(tree, "tiny-trace", trace=True)
    # On the CPU no launch is timed and no device trace exists: those
    # readers stay silent, the compiler's count is read.
    assert set(r["metrics"]) == {"device_steps"}
    assert r["correct"] is True


def test_new_files_are_found_by_name(tree):
    root = tree.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((tree / "configs" / "tiny-edits.json").read_text())
    cfg.update(name="tiny-edits-k32", block_k=32)
    (tree / "configs" / "tiny-edits-k32.json").write_text(json.dumps(cfg))
    (tree / "traffic" / "one-group.json").write_text(json.dumps(
        {"groups": 1, "batch": 2}))
    # A reader of one-group cells: elsewhere it finds nothing to read.
    (tree / "metrics" / "replays.count.py").write_text(
        "def read(rec):\n    if len(rec.facts['groups']) == 1:\n"
        "        return float(len(rec.samples))\n")
    bench["configs"].append({"name": "tiny-edits-k32", "source": "tiny",
                             "file": "portbench/configs/tiny-edits-k32.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "added", "config": "tiny-edits-k32",
                               "traffic": "one-group", "chips": 1,
                               "why": "t"})
    bench["end_to_end"].append({"name": "replays.count", "unit": "replays",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(tree, "added")
    assert r["correct"] is True
    assert r["metrics"]["replays.count"]["value"] == r["attempted"]
    # The reader finds nothing in a two-group cell: the metric is left out.
    assert "replays.count" not in run(tree, "tiny-edits")["metrics"]


def test_no_result_without_a_card(tree):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "tiny-edits",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tree.parent, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tree.parent),
             "PYTHONPATH": str(tree.parent)})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
