"""The replayer wrapper's host share: the mean over the window's replays
of the replay's host time less kernel A1's CUDA-event time in it."""
LAYER = "replayer wrapper"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "replay_p95_ms"
KERNEL = "rle_replay"


def read(rec):
    ms = (rec.kernel_ms or {}).get(KERNEL)
    if not ms or len(ms) != len(rec.samples):
        return None
    return sum(s * 1e3 - k for s, k in zip(rec.samples, ms)) / len(ms)
