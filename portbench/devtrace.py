"""The traced window's device activity, from ``torch.profiler``'s trace.

The window runs inside a profiler with CPU and CUDA activities; the
benchmark's own spans (``record_function``) mark the window and, inside
it, each replay's call and its synchronize. From the exported trace:
the time in which a kernel, a memset or a copy ran on the card (the union
of their intervals inside the window), the device operations that took
the most time, and the card's idle gaps, each named by the span the host
was in when the gap began.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, Tuple

#: Trace categories of work on the card.
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
#: The span around the whole window, and the spans inside it.
WINDOW = "window"
SPANS = ("replay.call", "replay.sync")


def export(prof) -> dict:
    """The profiler's chrome trace as a dict (written to a temporary file
    under ``TMPDIR`` and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def _union(intervals: List[Tuple[float, float]]):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarise(trace: dict) -> Dict[str, object]:
    """``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` of the
    window (seconds; lists of ``[name, seconds]``, largest first, at most
    10 each). Raises if the trace holds no window span."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    host = [e for e in events if e.get("cat") == "user_annotation"]
    wins = [e for e in host if e.get("name") == WINDOW]
    if not wins:
        raise ValueError("the trace holds no window span")
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    dev, by_name = [], collections.Counter()
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            s = max(float(e["ts"]), w0)
            t = min(float(e["ts"]) + float(e["dur"]), w1)
            if t > s:
                dev.append((s, t))
                by_name[e["name"]] += (t - s) * 1e-6
    busy = _union(dev)
    busy_s = sum(t - s for s, t in busy) * 1e-6
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in host if e.get("name") in SPANS)
    starts = [s for s, _, _ in spans]
    gaps, prev = collections.Counter(), w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            gaps[_span_at(spans, starts, prev)] += (s - prev) * 1e-6
        prev = max(prev, t)
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6,
            "device_ops": [[n, v] for n, v in by_name.most_common(10)],
            "idle_gaps": [[n, v] for n, v in gaps.most_common(10)]}


def _span_at(spans, starts, t: float) -> str:
    """The name of the span open at ``t`` (the spans follow one another),
    else ``loop``: the window's own code between replays."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][1] >= t:
        return spans[i][2]
    return "loop"
