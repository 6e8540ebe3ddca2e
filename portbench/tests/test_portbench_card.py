"""On the card: one short run of each cell, which must come out correct
with every number of the check within its limit. Skips without a card.

    python -m pytest -m cuda portbench/tests/test_portbench_card.py
"""
import json
import subprocess
import sys

import pytest

from portbench.spec import ROOT


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["northstar-512", "random-edits-1k",
                                  "northstar-10k"])
def test_cell_runs_correct(card, cell):
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "4000000001", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert all(v["value"] <= v["limit"] for v in line["check"].values())
