"""CRDT operations per second: the history's patches times the documents
a replay covers, times the replays completed, over the window's whole
host time (its start to the synchronize of its last replay)."""
from portbench.stats import rate

UNIT = "ops/s"
SOURCE = "host_clock"


def read(rec):
    return rate(rec.work_per_replay * len(rec.samples), rec.window_s)
