"""``BENCHMARK.json`` against the benchmark's contract, and every file
it names present and in agreement with it."""
import json
import re

import pytest

from portbench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_run_length():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells (2 + 14 runs a cell) fits 43,200 seconds.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert BENCH["paths"] == ["portbench"]
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for text in [w["why"] for w in BENCH["workloads"] + BENCH["configs"]] \
            + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_cells_and_their_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        used.add(w["config"])
        cell = spec.load_cell(w["name"])
        assert cell.traffic["config"] == w["config"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert used == set(configs)
    for c in configs.values():
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("portbench/")
        assert (spec.HERE / "entries" / f"{cfg['entry']}.py").exists()
        assert (spec.HERE / "generators" /
                f"{cfg['history']['generator']}.py").exists()


def test_per_layer_metrics_move_one_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_each_metric_is_a_reader_that_agrees(metric):
    mod = spec.module("metrics", metric["name"])
    assert callable(mod.read)
    assert mod.UNIT == metric["unit"] and mod.SOURCE == metric["source"]
    if "layer" in metric:
        assert mod.LAYER == metric["layer"] and mod.MOVES == metric["moves"]
