"""Kernel A1's share of its roofline: the least time the card could take
for the workload (the larger of its bytes over the peak bandwidth and its
operations over the peak rate, ``roofline/a1.py`` and ``peaks.json``)
over A1's measured time a replay."""
from portbench.roofline import a1

LAYER = "kernel A1"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "ops_per_s"
KERNEL = "rle_replay"


def read(rec):
    ms = (rec.kernel_ms or {}).get(KERNEL)
    if not ms or sum(ms) <= 0 or not rec.peaks:
        return None
    nbytes, ops = a1.counts(rec.facts)
    least = max(nbytes / rec.peaks["bytes_per_s"],
                ops / rec.peaks["ops_per_s"])
    return 100.0 * least / (sum(ms) / len(ms) * 1e-3)
