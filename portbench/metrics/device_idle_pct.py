"""The share of the traced window in which no kernel, memset or copy ran
on the card (``torch.profiler``'s trace, ``devtrace.py``)."""
LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "ops_per_s"


def read(rec):
    d = rec.device
    if not d or d["window_s"] <= 0 or d["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
