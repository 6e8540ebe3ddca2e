"""Deterministic cost ledger (counterpart of
``text_crdt_rust_tpu/obs/ledger.py``): the schema, the per-metric diff and
the loader of the committed ``perf/COST_LEDGER.json``.

The same logical-first discipline that makes two same-seed loadgen runs
emit byte-identical traces makes every logical cost metric — device
steps, fused rows, wire and checkpoint bytes, admission/codec rejects,
dispatch counts, flow ages, the journal's replay economy — exactly
reproducible on the CPU, so a cost regression gate needs no wall clock.
``obs.cells`` re-derives the port's cells (``serve``, ``flow``,
``recovery``, ``flash-crowd``, ``fused-trace``) and ``diff_ledger``
compares them with the committed ones, metric by metric, each within its
own ``tol`` (0 = exact).

Ledger shape::

    {"schema_version": 2,
     "recorded": {...provenance note...},
     "cells": {
       "<cell>": {
         "kind": "cpu" | "device",      # the gate re-derives cpu cells
         "workload": {...pinned shape description...},
         "metrics": {
           "<metric>": {"v": <number>, "family": "<family>",
                        "tol": <relative band, 0.0 = exact>}}}}}

Wall-clock data never enters a cpu cell.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

LEDGER_SCHEMA_VERSION = 2  # v2: the "recovery" metric family
#                            (journal/replay durability counters)

#: Default committed-artifact location (repo-root relative).
LEDGER_PATH = "perf/COST_LEDGER.json"

#: Known metric families — every metric must claim one, so the
#: committed artifact stays groupable and the coverage floor
#: (>= 6 families) is checkable.
METRIC_FAMILIES = (
    "steps",        # device steps, pre-fusion steps, fused rows saved
    "compile",      # device_compiles (steady state must stay fixed)
    "wire",         # replication bytes by lane + bytes/op
    "ckpt",         # checkpoint bytes per evict kind, evictions/restores
    "admission",    # admission/codec rejects, admitted counts
    "trace",        # trace event volume, post-mortem bundle counts
    "touched-rows", # blocked-lanes cost-model replay of the tick trace
    "fuse",         # generalized step-fusion accounting
    "hlo",          # static compiled-HLO costs (collectives/flops/bytes)
    "wall",         # device-cell wall histograms (silicon re-record only)
    "flow",         # per-op provenance: span terminal states + op-age-
    #                 at-apply in logical ticks (obs/flow) — the
    #                 pipelined-tick latency contract
    "recovery",     # durability: journal bytes/op, replayed
    #                 records/ops/ticks-to-recover of the pinned crash
    #                 scenario, byte-identity + crash-audit asserted
    #                 green before pinning
)

CELL_KINDS = ("cpu", "device")


def metric(value, family: str, tol: float = 0.0) -> dict:
    """One ledger metric entry. ``tol`` is a RELATIVE band: 0.0 pins the
    value exactly (logical counters), ``0.5`` accepts ±50% (HLO costs,
    which drift with compiler versions without a logic change)."""
    if family not in METRIC_FAMILIES:
        raise ValueError(f"unknown metric family {family!r}")
    if tol < 0.0:
        raise ValueError(f"negative tolerance {tol}")
    v = float(value)
    out = {"v": int(v) if v == int(v) and tol == 0.0 else round(v, 6),
           "family": family}
    if tol:
        out["tol"] = tol
    return out


def validate_ledger(ledger: dict) -> None:
    """Raise ``ValueError`` naming every schema violation — the same
    write-time strictness as ``bench.validate_row``: a drifted artifact
    must refuse loudly, not mis-compare quietly."""
    problems: List[str] = []
    if ledger.get("schema_version") != LEDGER_SCHEMA_VERSION:
        problems.append(
            f"schema_version {ledger.get('schema_version')!r} != "
            f"{LEDGER_SCHEMA_VERSION} (re-record the ledger)")
    cells = ledger.get("cells")
    if not isinstance(cells, dict) or not cells:
        problems.append("ledger carries no cells")
        cells = {}
    for name, cell in cells.items():
        if cell.get("kind") not in CELL_KINDS:
            problems.append(f"cell {name!r}: unknown kind "
                            f"{cell.get('kind')!r}")
        if not isinstance(cell.get("workload"), dict):
            problems.append(f"cell {name!r}: missing workload pin")
        metrics = cell.get("metrics")
        if not isinstance(metrics, dict) or not metrics:
            problems.append(f"cell {name!r}: no metrics")
            continue
        for mname, m in metrics.items():
            if not isinstance(m, dict) or "v" not in m:
                problems.append(f"metric {name}.{mname}: no value")
                continue
            if not isinstance(m["v"], (int, float)):
                problems.append(f"metric {name}.{mname}: non-numeric "
                                f"value {m['v']!r}")
            if m.get("family") not in METRIC_FAMILIES:
                problems.append(f"metric {name}.{mname}: unknown family "
                                f"{m.get('family')!r}")
            if m.get("tol") is not None and (
                    not isinstance(m["tol"], (int, float))
                    or m["tol"] < 0):
                problems.append(f"metric {name}.{mname}: bad tol "
                                f"{m.get('tol')!r}")
    if problems:
        raise ValueError("cost ledger violates the schema: "
                         + "; ".join(problems))


def families_covered(ledger: dict) -> set:
    return {m.get("family")
            for cell in ledger.get("cells", {}).values()
            for m in cell.get("metrics", {}).values()}


def diff_cell(name: str, committed: dict, fresh: dict) -> List[str]:
    """Named per-metric diffs between one committed cell and its fresh
    re-derivation.  Drift in EITHER direction is a finding: a value
    outside its band, a committed metric the code no longer produces,
    or a new metric the ledger never recorded (schema growth that needs
    a deliberate re-record, not a silent pass)."""
    out: List[str] = []
    cm = committed.get("metrics", {})
    fm = fresh.get("metrics", {})
    for mname in sorted(cm):
        if mname not in fm:
            out.append(f"{name}.{mname}: committed "
                       f"{cm[mname]['v']} but the probe no longer "
                       f"derives it (re-record the ledger if deliberate)")
            continue
        want, got = cm[mname]["v"], fm[mname]["v"]
        tol = cm[mname].get("tol", 0.0)
        if tol:
            band = abs(want) * tol
            if abs(got - want) > band:
                out.append(
                    f"{name}.{mname} [{cm[mname]['family']}]: "
                    f"{got} outside {want} ±{tol * 100:.0f}% "
                    f"(band ±{band:.6g})")
        elif got != want:
            out.append(
                f"{name}.{mname} [{cm[mname]['family']}]: "
                f"{got} != committed {want} (exact logical counter)")
    for mname in sorted(set(fm) - set(cm)):
        out.append(f"{name}.{mname}: derived {fm[mname]['v']} but the "
                   f"committed ledger never recorded it (re-record to "
                   f"adopt the new metric)")
    return out


def diff_ledger(committed: dict, fresh_cells: Dict[str, dict]
                ) -> Tuple[bool, List[str]]:
    """Compare committed cells against freshly derived ones; only cells
    present in ``fresh_cells`` are judged (the gate derives the cpu
    cells; device cells wait for silicon).  Returns (ok, named diffs).
    """
    diffs: List[str] = []
    cells = committed.get("cells", {})
    for name in sorted(fresh_cells):
        if name not in cells:
            diffs.append(f"{name}: derived a cell the committed ledger "
                         f"does not carry (re-record to adopt it)")
            continue
        diffs.extend(diff_cell(name, cells[name], fresh_cells[name]))
    return not diffs, diffs


def cpu_cell_names(ledger: dict) -> List[str]:
    """The cells the wall-clock-free gate can re-derive on any box."""
    return sorted(n for n, c in ledger.get("cells", {}).items()
                  if c.get("kind") == "cpu")


def load_ledger(path: str = LEDGER_PATH) -> dict:
    with open(path) as f:
        return json.load(f)
