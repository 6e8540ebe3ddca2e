"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's file (``configs/<config>.json``) names its history
generator (``generators/<name>.py``) and its entry adapter
(``entries/<name>.py``); the traffic mix is ``traffic/<traffic>.json``;
every metric is a reader ``metrics/<metric>.py``. Adding a cell, a
configuration, a traffic mix or a metric adds files and entries and edits
no file that is there.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import List

#: The repository root: ``BENCHMARK.json`` and the port's package.
ROOT = Path(__file__).resolve().parent.parent
#: This folder; configurations, traffic and readers live under it.
HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    chips: int
    end_to_end: List[dict]   # BENCHMARK.json's metrics
    per_layer: List[dict]


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read
    from ``here``. Every metric's reader is asked in every cell; one that
    finds nothing to read there returns None and is left out."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    if traffic.get("config", w["config"]) != w["config"]:
        raise ValueError(f"traffic {w['traffic']!r} is made for config "
                         f"{traffic['config']!r}, not {w['config']!r}")
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w["chips"]), end_to_end=bench["end_to_end"],
                per_layer=bench["per_layer"])


def module(kind: str, name: str, here: Path = HERE):
    """The module in ``here/<kind>/<name>.py``, loaded from its path, so
    any name a file may have (``-`` and ``.`` too) is found. Such a module
    imports what it shares with others as ``portbench.<module>``."""
    path = here / kind / f"{name}.py"
    key = "portbench_file_" + re.sub(r"\W", "_", str(path))
    mod = sys.modules.get(key)
    if mod is None:
        if not path.exists():
            raise FileNotFoundError(f"no {kind} file {path}")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod
