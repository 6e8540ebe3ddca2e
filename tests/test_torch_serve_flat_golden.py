"""The port's serve loadgen on ``ServeConfig()`` (the flat engine, 2 x 16
lanes, CAP 512, OCAP 1,536, lmax 16, buckets 8/32/128) at the acceptance
shape (200 documents x 3 agents, 60 ticks of 48 events, 10 % faults,
seed 7), on the CPU, against the JAX package's golden record
``tests/data/serve_flat_golden.json`` (``tests/data/make_serve_golden.py
--engine flat``): the report's logical fields, every document's string and
``state_digest``, and the sha256 of the logical trace, bit for bit.

Depths 1 and 2 each hold their own record; tick trains of 2 and 4 at
depth 2 reproduce it on everything but the dispatch economy
(``test_torch_serve_flat.train_invariant``). ``chip_smoke.py`` holds the
same record against the port's run on the card.
"""
import json
import sys
from pathlib import Path

import pytest

from test_torch_serve_flat import train_invariant
from text_crdt_rust_tpu_torch.config import ServeConfig
from text_crdt_rust_tpu_torch.serve.loadgen import ServeLoadGen

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests" / "data"))

import make_serve_golden as golden  # noqa: E402

GOLDEN = REPO / "tests" / "data" / "serve_flat_golden.json"


@pytest.fixture(scope="module")
def record():
    return json.loads(GOLDEN.read_text())


def test_golden_record_is_the_acceptance_shape(record):
    assert record["params"] == golden.ACCEPTANCE
    assert record["cfg"] == golden.FLAT_CFG
    assert ServeConfig().engine == "flat"
    assert sorted(record["depths"]) == ["1", "2"]


@pytest.mark.parametrize("depth,train", [(1, 1), (2, 2), (2, 4)])
def test_acceptance_loadgen_equals_the_golden_record(record, depth, train):
    cfg = ServeConfig(pipeline_ticks=depth, train_ticks=train,
                      trace_keep=True)
    gen = ServeLoadGen(cfg=cfg, device="cpu", **golden.ACCEPTANCE)
    report = gen.run()
    assert report["converged"], report["mismatches"]
    assert report["pipeline"]["ticks"] == depth
    assert report["train"]["ticks"] == train
    rec = golden.record_of(gen, report)
    want = record["depths"][str(depth)]
    assert rec["trace_sha256"] == want["trace_sha256"]
    assert rec["docs"] == want["docs"]
    if train == 1:
        assert rec["logical"] == want["logical"]
    else:
        assert train_invariant(rec) == train_invariant(want)
