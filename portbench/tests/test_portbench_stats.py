"""Percentiles, rates, and the metric readers over synthetic samples."""
import pytest

from portbench import spec, stats
from portbench.run import RunRecord


def test_percentile_matches_linear_interpolation():
    vals = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(vals, 0) == 1.0
    assert stats.percentile(vals, 100) == 5.0
    assert stats.percentile(vals, 50) == 3.0
    assert stats.percentile(vals, 95) == pytest.approx(4.8)


def test_one_stall_sets_the_tail_of_a_short_window():
    # 19 replays of 100 ms and one stall of 900 ms: the stall is the top
    # sample, and p95 interpolates toward it (0.95 of the way from the
    # 19th to the 20th order statistic).
    samples = [0.1] * 19 + [0.9]
    assert stats.percentile(samples, 95) == pytest.approx(0.1 + 0.05 * 0.8)
    # With 200 replays the single stall is beyond p95 and leaves it.
    assert stats.percentile([0.1] * 199 + [0.9], 95) == pytest.approx(0.1)


def test_rate_over_the_whole_window():
    assert stats.rate(1000, 2.0) == 500.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def _rec(**kw):
    base = dict(setup_s=7.5, window_s=2.0, samples=[0.15, 0.2, 0.25, 0.9],
                work_per_replay=1000, mem_peak_bytes=3 * 2 ** 30,
                counters={"device_steps": 7352}, facts={"groups": [
                    {"documents": 10, "steps": 100, "insert_steps": 60,
                     "runs": 50, "char_ops": 400}]})
    base.update(kw)
    return RunRecord(**base)


def test_end_to_end_readers():
    rec = _rec()
    read = {n: spec.module("metrics", n).read(rec) for n in
            ("ops_per_s", "replay_p95_ms", "device_mem_gib", "setup_s")}
    assert read["ops_per_s"] == 4 * 1000 / 2.0
    assert read["replay_p95_ms"] == pytest.approx(
        stats.percentile(rec.samples, 95) * 1e3)
    assert read["device_mem_gib"] == 3.0
    assert read["setup_s"] == 7.5


def test_per_layer_readers_and_their_silence():
    rec = _rec(kernel_ms={"rle_replay": [140.0, 190.0, 240.0, 890.0]},
               launches={"rle_replay": 4},
               device={"busy_s": 1.9, "window_s": 2.0},
               peaks={"bytes_per_s": 1e9, "ops_per_s": 1e12})
    m = {n: spec.module("metrics", n) for n in
         ("device_steps", "host_gap_ms", "a1_ms", "a1_roofline",
          "device_idle_pct")}
    assert m["device_steps"].read(rec) == 7352
    assert m["a1_ms"].read(rec) == pytest.approx(365.0)
    assert m["host_gap_ms"].read(rec) == pytest.approx(10.0)
    assert m["device_idle_pct"].read(rec) == pytest.approx(5.0)
    # 100*5*4 + 10*8*50 + 10*8*60 = 10,800 bytes over 1e9 B/s.
    assert m["a1_roofline"].read(rec) == pytest.approx(
        100 * 10_800e-9 / 0.365)
    bare = _rec()
    for name in ("host_gap_ms", "a1_ms", "a1_roofline", "device_idle_pct"):
        assert m[name].read(bare) is None
