"""The port's slice end to end: the whole automerge-paper trace through
``northstar`` at the north-star geometry (capacity 20,992 run rows,
K = 128, fuse_w = 8) on a small batch, bit for bit against the JAX
package's Pallas replay in interpret mode, and its text against the
trace's ``endContent``."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from text_crdt_rust_tpu.ops import rle as JR
from text_crdt_rust_tpu.ops import span_arrays as JSA
from text_crdt_rust_tpu.ops.batch import OpTensors
from text_crdt_rust_tpu_torch import convert, northstar
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA
from text_crdt_rust_tpu_torch.utils import testdata as TT

REPO = Path(__file__).resolve().parent.parent
FIELDS = ("ordp", "lenp", "blkord", "rows", "meta", "ol", "orr", "err")


def test_full_trace_matches_jax_and_end_content():
    run = northstar.run_northstar(batch=8, device="cpu")
    assert run.ok
    # The original patches on the native engine (bench.py:594-598).
    assert run.native_ok and run.native_text == run.stream.want
    assert len(run.stream.patches) == 259778
    assert (run.stream.n_patches, run.stream.steps_merged,
            run.stream.steps) == (259778, 10712, 7352)
    res = run.results[0]
    assert int(res.meta[0, 0]) == 162  # of 164 blocks: splits are exact
    assert TSA.to_string(run.doc) == run.stream.want

    jops = OpTensors(**{f.name: getattr(run.stream.ops, f.name)
                        for f in dataclasses.fields(OpTensors)})
    jres = JR.replay_local_rle(jops, capacity=20992, batch=8, block_k=128,
                               chunk=1024, interpret=True)
    got = convert.rle_result_to_numpy(res)
    for f in FIELDS:
        assert np.array_equal(got[f], np.asarray(getattr(jres, f))), f
    jd = JSA.download(JR.rle_to_flat(jops, jres))
    td = TSA.download(run.doc)
    for k in jd:
        assert np.array_equal(jd[k], td[k]), k


@pytest.mark.parametrize("groups", [1, 2])
def test_prefix_groups(groups):
    run = northstar.run_northstar(batch=4, capacity=4096, block_k=16,
                                  groups=groups, patches=20000,
                                  device="cpu")
    assert run.ok and len(run.results) == groups
    patches = TT.flatten_patches(
        TT.load_testing_data(TT.trace_path("automerge-paper")))
    assert run.stream.want == northstar.apply_patches(patches[:20000])
    for r in run.results[1:]:
        for f in FIELDS:
            assert np.array_equal(convert.rle_result_to_numpy(r)[f],
                                  convert.rle_result_to_numpy(
                                      run.results[0])[f]), f


def test_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "text_crdt_rust_tpu_torch.northstar",
         "--device", "cpu", "--patches", "3000", "--batch", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert '"ok": true' in out.stdout.splitlines()[-1]
