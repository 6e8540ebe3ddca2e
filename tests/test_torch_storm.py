"""The storm entry point on the CPU against the JAX package's config-4
pipeline (``bench.py`` ``cfg_4``): the same txns, compiled stream, replay
outputs (bit for bit, the JAX kernel in interpret mode) and oracle text.

Here at 20 rounds; the full 16-peer x 200-round storms are in
``test_torch_storm_full.py``. Tolerance: none.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import rle as JR
from text_crdt_rust_tpu.ops import rle_mixed as JRM
from text_crdt_rust_tpu.ops import span_arrays as JSA
from text_crdt_rust_tpu.utils.randedit import make_storm as j_make_storm
from text_crdt_rust_tpu_torch import convert, storm
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA

REPO = Path(__file__).resolve().parent.parent
FIELDS = ("ordp", "lenp", "blkord", "rows", "meta", "ol", "orr", "err")


def jax_pipeline(txns, run_len, del_prob, batch=8, block_k=128):
    """``cfg_4``'s pipeline in the JAX package: (ops, result, text)."""
    table = JB.AgentTable(sorted({t.id.agent for t in txns}))
    ops, _ = JB.compile_remote_txns(
        txns, table, lmax=min(16, run_len * 2),
        dmax=16 if del_prob == 0 else None)
    capacity = ((max(int(ops.num_steps * 3), 256) + block_k - 1)
                // block_k) * block_k
    res = JRM.replay_mixed_rle(ops, capacity=capacity, batch=batch,
                               block_k=block_k, chunk=1024, interpret=True)
    return ops, res, JSA.to_string(JR.rle_to_flat(ops, res))


def assert_same(jops, jres, tops, tres):
    for f in dataclasses.fields(JB.OpTensors):
        assert np.array_equal(np.asarray(getattr(jops, f.name)),
                              getattr(tops, f.name)), f.name
    got = convert.rle_mixed_result_to_numpy(tres)
    for f in FIELDS:
        j = np.asarray(getattr(jres, f))
        assert got[f].dtype == j.dtype and got[f].shape == j.shape, f
        assert np.array_equal(got[f], j), f


@pytest.mark.parametrize("del_prob", [0.0, 0.35])
def test_run_storm_matches_jax_pipeline(del_prob):
    run = storm.run_storm(rounds=20, batch=8, del_prob=del_prob,
                          device="cpu")
    txns, receiver = j_make_storm(16, 20, 4, seed=7, del_prob=del_prob)
    assert [dataclasses.asdict(t) for t in run.stream.txns] == \
        [dataclasses.asdict(t) for t in txns]
    jops, jres, jtext = jax_pipeline(txns, 4, del_prob)
    assert_same(jops, jres, run.stream.ops, run.result)
    assert run.ok and jtext == receiver.to_string() == TSA.to_string(run.doc)
    # The native engine applied the same txns (bench.py:831, :891).
    assert run.native_ok and run.native_text == jtext
    assert run.stream.char_ops == sum(
        len(getattr(op, "ins_content", "")) + getattr(op, "len", 0)
        for t in txns for op in t.ops)


def test_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "text_crdt_rust_tpu_torch.storm",
         "--rounds", "6", "--del-prob", "0.35", "--batch", "2",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["ok"] and line["device"] == "cpu" and line["steps"] > 96
