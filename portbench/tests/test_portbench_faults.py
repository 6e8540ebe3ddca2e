"""The timed path broken underneath, at a tiny size on the CPU: the
control and each fault must make ``correct`` false."""
import pytest

from portbench import faults
from portbench.control import control_wrap, fault_wrap

from .test_portbench_cells import run


@pytest.mark.parametrize("name", ["tiny-trace", "tiny-edits"])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_caught(tree, name, fault):
    r = run(tree, name, wrap=fault_wrap(fault))
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["check"].values())


@pytest.mark.parametrize("name,docs", [("tiny-edits", 6), ("tiny-trace", 4)])
def test_control_is_caught(tree, monkeypatch, name, docs):
    # The tiny histories have too few orders to wrap 16 bits: the control
    # is shifted by 40,000 orders, past 2^15, as the cells' histories
    # (~56,000 and 259,778 orders) need not be. Its runs then no longer
    # merge and take more blocks than the program's capacity.
    r = run(tree, name, wrap=control_wrap)
    assert r["correct"] is True  # below 2^15 orders int16 loses nothing
    real = faults.lower_precision

    def shifted(exp):
        import dataclasses
        import numpy as np
        s = exp.signed
        big = dataclasses.replace(
            exp, signed=np.sign(s) * (np.abs(s) + 40000),
            ol=(exp.ol.astype(np.int64) + 40000).astype(np.uint32),
            orr=(exp.orr.astype(np.int64) + 40000).astype(np.uint32))
        return real(big)

    monkeypatch.setattr(faults, "lower_precision", shifted)
    r = run(tree, name, wrap=control_wrap)
    assert r["correct"] is False
    assert r["check"]["docs_wrong"]["value"] == docs


def test_control_wraps_at_the_cells_order_counts():
    import numpy as np
    from portbench.reference.splice import Expected
    n = 60000
    exp = Expected(signed=np.arange(1, n + 1), ol=np.arange(n, dtype=np.uint32),
                   orr=np.arange(n, dtype=np.uint32),
                   inserted=np.ones(n, bool), text="")
    low = faults.lower_precision(exp)
    assert (low.signed != exp.signed).sum() == n - 32767
    assert (low.ol != exp.ol).any()
