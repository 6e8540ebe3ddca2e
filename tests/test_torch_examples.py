"""The port's ``examples/soak.py`` and ``examples/stats.py`` (the
upstream ``examples/simple.rs`` and ``examples/stats.rs`` programs on the
port's native engine, oracle and ``utils/metrics.print_stats``) at the
sizes of ``tests/test_examples_config.py``: their output equals the JAX
package's examples line for line, but for the rate lines, which the port
prints only with a caller's clock."""
import random
import time

import numpy as np
import pytest

from text_crdt_rust_tpu.examples import soak as JS
from text_crdt_rust_tpu.examples import stats as JST
from text_crdt_rust_tpu_torch.examples import soak as TS
from text_crdt_rust_tpu_torch.examples import stats as TST

SOAK = ["--edits", "3000", "--oracle", "300", "--seed", "11"]


def _lines(out: str, drop: str):
    return [ln for ln in out.splitlines() if drop not in ln]


def test_soak_edits_are_the_jax_draw():
    for got, want in zip(TS.make_edits(random.Random(11), 3000),
                         JS.make_edits(random.Random(11), 3000)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_soak_matches_the_jax_example(capsys):
    assert TS.main(SOAK) == 0
    ours = capsys.readouterr().out
    assert JS.main(SOAK) == 0
    theirs = capsys.readouterr().out
    assert "oracle prefix OK" in ours and "content OK" in ours
    assert _lines(ours, "native replay") == _lines(theirs, "native replay")
    assert "edits/s" not in ours
    assert TS.main(SOAK + ["--detailed"], clock=time.perf_counter) == 0
    out = capsys.readouterr().out
    assert "edits/s" in out and "span histogram" in out


@pytest.mark.parametrize("engine", ["native", "oracle"])
def test_stats_matches_the_jax_example(engine, capsys):
    argv = ["--trace", "sveltecomponent", "--engine", engine]
    assert TST.main(argv) == 0
    ours = capsys.readouterr().out
    assert JST.main(argv) == 0
    theirs = capsys.readouterr().out
    assert "final content OK" in ours and "merged spans" in ours
    assert _lines(ours, "replay (") == _lines(theirs, "replay (")
    assert "patches/s" not in ours


def test_stats_rate_with_a_clock(capsys):
    argv = ["--trace", "sveltecomponent", "--detailed"]
    assert TST.main(argv, clock=time.perf_counter) == 0
    out = capsys.readouterr().out
    assert "patches/s" in out and "span histogram" in out
