"""The port re-derives five cells of the committed cost ledger
(``perf/COST_LEDGER.json``, recorded on the JAX package by
``perf/cost_ledger_probe.py``): ``serve`` (35 metrics), ``flow`` (23),
``recovery`` (14), ``flash-crowd`` (8) and ``fused-trace`` (10) — 90
metrics, each within its committed ``tol`` (0 for all of them: exact
logical counters), on the flat engine's plain version on the CPU.

Not derived: the ``serve`` cell's six ``hlo`` metrics (static costs of the
JAX package's compiled XLA programs), ``serve-lanes`` (a cost-model
replay, ``perf/blocked_lanes_sim.py``) and ``sp`` (the sequence-parallel
engine, not ported) — ``obs.cells.NOT_DERIVED`` and ``NOT_DERIVED_WHY``
below.
"""
import pytest

from text_crdt_rust_tpu_torch.obs import cells, ledger

EXPECTED = {"serve": 35, "flow": 23, "recovery": 14, "flash-crowd": 8,
            "fused-trace": 10}
#: The committed cells the port does not re-derive, and why.
NOT_DERIVED_WHY = {
    "serve-lanes": "a cost-model replay (perf/blocked_lanes_sim.py)",
    "sp": "the sequence-parallel engine is not ported",
}


@pytest.fixture(scope="module")
def committed():
    led = ledger.load_ledger()
    ledger.validate_ledger(led)
    return led


@pytest.mark.parametrize("name", cells.CELLS)
def test_cell_equals_the_committed_ledger(committed, name):
    fresh = cells.derive_cells([name], device="cpu")[name]
    want = cells.committed_view(committed, name)
    assert len(want["metrics"]) == EXPECTED[name]
    assert all(m.get("tol", 0.0) == 0.0 for m in want["metrics"].values())
    diffs = ledger.diff_cell(name, want, fresh)
    assert not diffs, diffs
    assert {k: v for k, v in fresh["workload"].items()
            if k in want["workload"]} == {
        k: v for k, v in want["workload"].items() if k in fresh["workload"]}


def test_what_is_left_out_is_named(committed):
    assert sum(EXPECTED.values()) == 90
    assert set(cells.CELLS) | set(NOT_DERIVED_WHY) == \
        set(ledger.cpu_cell_names(committed))
    serve = committed["cells"]["serve"]["metrics"]
    assert {k for k, m in serve.items() if m["family"] == "hlo"} == \
        set(cells.NOT_DERIVED["serve"])
    ok, diffs = ledger.diff_ledger(
        {"cells": {"fused-trace": committed["cells"]["fused-trace"]}},
        cells.derive_cells(["fused-trace"]))
    assert ok, diffs


def test_ledger_schema_refusals():
    with pytest.raises(ValueError, match="family"):
        ledger.metric(1, "nope")
    with pytest.raises(ValueError, match="schema_version"):
        ledger.validate_ledger({"schema_version": 1, "cells": {}})
    assert ledger.metric(3.0, "steps") == {"v": 3, "family": "steps"}
    assert "steps" in ledger.families_covered(
        {"cells": {"c": {"metrics": {"m": ledger.metric(1, "steps")}}}})
