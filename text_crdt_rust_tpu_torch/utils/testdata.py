"""Editing-trace loader (counterpart of ``text_crdt_rust_tpu/utils/testdata.py``,
the `crdt-testdata` sub-crate, `src/testdata/src/lib.rs:10-48`).

Parses the gzipped automerge-perf JSON traces shipped in
``benchmark_data/*.json.gz``:

    { "startContent": str, "endContent": str,
      "txns": [ { "patches": [ [pos, del_len, ins_str], ... ] }, ... ] }

Positions are in (unicode) characters; each patch is "delete ``del_len``
chars at ``pos``, then insert ``ins_str`` at ``pos``".
"""
from __future__ import annotations

import gzip
import json
import os
from dataclasses import dataclass
from typing import List

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA_DIR = os.path.join(REPO_ROOT, "benchmark_data")


@dataclass
class TestPatch:
    __test__ = False  # not a pytest class, despite the name

    pos: int
    del_len: int
    ins_content: str


@dataclass
class TestTxn:
    __test__ = False

    patches: List[TestPatch]


@dataclass
class TestData:
    __test__ = False

    start_content: str
    end_content: str
    txns: List[TestTxn]

    def num_ops(self) -> int:
        """Total CRDT ops (inserted chars + deleted chars), matching the
        order-number accounting of `doc.rs:376-389`."""
        return sum(p.del_len + len(p.ins_content)
                   for txn in self.txns for p in txn.patches)

    def num_patches(self) -> int:
        return sum(len(t.patches) for t in self.txns)


def load_testing_data(path: str) -> TestData:
    """Gunzip + parse one trace (`testdata/src/lib.rs:43-48`)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        raw = json.load(f)
    txns = [
        TestTxn(patches=[TestPatch(p[0], p[1], p[2]) for p in t["patches"]])
        for t in raw["txns"]
    ]
    return TestData(
        start_content=raw.get("startContent", ""),
        end_content=raw.get("endContent", ""),
        txns=txns,
    )


def trace_path(name: str) -> str:
    """Resolve a corpus trace by short name, e.g. ``automerge-paper``,
    against the repository's ``benchmark_data/``."""
    return os.path.join(DATA_DIR, f"{name}.json.gz")


def flatten_patches(data: TestData) -> List[TestPatch]:
    """All patches in order."""
    out: List[TestPatch] = []
    for t in data.txns:
        out.extend(t.patches)
    return out
