"""An automerge-perf editing trace from the repository's
``benchmark_data/`` (a frozen copy of the port's
``utils/testdata.load_testing_data`` and ``flatten_patches``).

The file is gzipped JSON::

    { "startContent": str, "endContent": str,
      "txns": [ { "patches": [ [pos, del_len, ins_str], ... ] }, ... ] }

The history is every patch of every txn in order; its text is the
trace's ``endContent``. The seed draws nothing: the trace is the history.
"""
from __future__ import annotations

import gzip
import json
from pathlib import Path

from portbench.generators.history import History, Patch

DATA_DIR = Path(__file__).resolve().parent.parent.parent / "benchmark_data"


def load(path) -> History:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        raw = json.load(f)
    patches = [Patch(p[0], p[1], p[2])
               for t in raw["txns"] for p in t["patches"]]
    return History(patches=patches, text=raw.get("endContent", ""))


def make(params: dict, seed: int) -> History:
    """``params["trace"]`` names the trace, e.g. ``automerge-paper``;
    ``params["patches"]``, where given, keeps only the trace's first
    patches, whose text is then their plain string splice."""
    hist = load(DATA_DIR / f"{params['trace']}.json.gz")
    n = params.get("patches")
    if not n:
        return hist
    patches = hist.patches[:n]
    text = ""
    for p in patches:
        text = text[:p.pos] + p.ins_content + text[p.pos + p.del_len:]
    return History(patches=patches, text=text)
