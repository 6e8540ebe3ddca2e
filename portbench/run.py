"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from the process's start to the window's): the history from the
seed, the cell's kernels built into the port's ``_build/`` (a hit after a
checkout's first run), the port's compile and staging, one warm-up
replay. The window: one caller replaying back to back for ``--seconds``.
Then the check: the reference worked out from the history, and the last
replay's outputs judged against it, every document. ``--trace 1`` runs
the window under ``torch.profiler`` with CUDA events around each launch
and reports the per-layer metrics instead of the end-to-end ones. The
last line of standard output is one JSON object; the numbers the check
compared, each with its limit, are the last lines of standard error.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python gets

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from portbench import spec  # noqa: E402

#: Top-level module names that may not be loaded in a run: JAX and the
#: JAX package (compared whole, so the port's name does not match).
FORBIDDEN = ("jax", "jaxlib", "flax", "text_crdt_rust_tpu")
#: Limit of each number the check compares: the comparison is exact.
LIMITS = {"docs_unjudged": 0, "docs_wrong": 0, "origins_wrong": 0,
          "flags_set": 0, "orders_uncovered": 0}


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read (``metrics/<name>.py``)."""

    setup_s: float
    window_s: float
    samples: List[float]            # each replay's host time (s)
    work_per_replay: int            # patches x documents
    mem_peak_bytes: int
    counters: Dict[str, float]      # the program's own counts
    facts: dict                     # the workload, for the rooflines
    kernel_ms: Dict[str, List[float]] = None  # traced: events a replay
    launches: Dict[str, int] = None           # traced: launches
    device: dict = None             # traced: busy_s, window_s
    peaks: dict = None              # the card's peaks, if in peaks.json


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _spans(log):
    @contextlib.contextmanager
    def span(name):
        t = time.perf_counter()
        yield
        log[name] = log.get(name, 0.0) + time.perf_counter() - t
    return span


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _window(replay, seconds, sync, trace: bool, cuda: bool, kernels):
    """The measured window; when traced, under ``torch.profiler`` with
    the benchmark's spans and, on the card, CUDA events around each
    launch. Returns ``(window, profiler, events, launches)``."""
    from portbench.window import LaunchEvents, closed_loop

    timer = LaunchEvents(kernels) if (trace and cuda) else None
    prof = span = None
    kernels.reset_launches()
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = stack.enter_context(profile(activities=acts))
            stack.enter_context(record_function("window"))
            span = record_function
        if timer is not None:
            stack.enter_context(timer)
        win = closed_loop(
            replay, seconds, sync, span=span,
            on_replay=(lambda i: setattr(timer, "replay", i))
            if timer is not None else None)
    return win, prof, timer, dict(kernels.launches)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             here: Path, wrap=None, t0: float = None):
    """Set up, measure and check one cell on ``device``; returns the
    result line's object. ``wrap(replay, entry, history)``, where given,
    returns the call the window drives in place of the replay (the
    control and the fault tests put it under the timed path)."""
    import numpy as np
    import torch

    from portbench import judge as J
    from portbench.reference import splice

    t0 = T0 if t0 is None else t0
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    torch.set_num_threads(1)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    host: Dict[str, float] = {}
    span = _spans(host)
    cfg, traffic = cell.config, cell.traffic
    gen = spec.module("generators", cfg["history"]["generator"], here)
    adapter = spec.module("entries", cfg["entry"], here)
    # An entry that reads its input itself (a public trace) gets none:
    # the benchmark's copy serves only the reference, after the window.
    history = None
    if getattr(adapter, "NEEDS_HISTORY", True) or wrap is not None:
        with span("history"):
            history = gen.make(cfg["history"], seed)
    from text_crdt_rust_tpu_torch.ops import _kernels
    if cuda:
        with span("build"):
            _kernels.build(adapter.KERNELS)
    with span("compile"):
        entry = adapter.setup(cfg, traffic, history, device)
    replay = entry.replay if wrap is None else \
        wrap(entry.replay, entry, history)
    with span("warmup"):
        out = replay()
        sync()
        out = None
    setup_s = time.perf_counter() - t0

    win, prof, timer, launches = _window(replay, seconds, sync, trace,
                                         cuda, _kernels)
    mem = torch.cuda.max_memory_allocated() if cuda else 0
    results = entry.results(win.last)
    steps, documents, counters = entry.steps, entry.documents, \
        dict(entry.counters)
    del entry, replay, win.last

    if history is None:
        with span("history"):
            history = gen.make(cfg["history"], seed)
    if counters.pop("patches", len(history.patches)) != len(history.patches):
        raise RuntimeError("the program read another history than the "
                           "benchmark's")
    with span("reference"):
        expected = splice.replay(history.patches)
    if expected.text != history.text:
        raise RuntimeError("the reference does not reproduce the history's "
                           "text")
    with span("check"):
        check = J.judge(results, steps, [expected] * len(steps))
    check["docs_unjudged"] = documents - check["docs"]
    correct = all(check[k] <= v for k, v in LIMITS.items())
    runs = len(expected.runs()[0])
    facts = {"groups": [{"documents": documents // len(steps),
                         "steps": len(s), "insert_steps":
                         int((np.asarray(n) > 0).sum()), "runs": runs,
                         "char_ops": history.inserted + history.deleted}
                        for s, n in steps]}
    rec = RunRecord(setup_s=setup_s, window_s=win.window_s,
                    samples=win.samples,
                    work_per_replay=len(history.patches) * documents,
                    mem_peak_bytes=mem, counters=counters, facts=facts)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": mem}
    breakdown = None
    if trace:
        rec.launches = launches
        if timer is not None:
            rec.kernel_ms = timer.per_replay_ms(len(win.samples))
        if cuda:
            from portbench import devtrace
            summary = devtrace.summarise(devtrace.export(prof))
            rec.device = {"busy_s": summary["busy_s"],
                          "window_s": summary["window_s"]}
            dev.update(rec.device)
            breakdown = {"device_ops": summary["device_ops"],
                         "idle_gaps": summary["idle_gaps"]}
        peaks = json.loads((here / "peaks.json").read_text())
        rec.peaks = peaks.get(dev["kind"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.module("metrics", m["name"], here).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if cuda:
        limit = power_limit()
        if limit:
            print(f"card: {limit}", file=sys.stderr)
    print(f"replays {len(win.samples)} in {win.window_s:.3f} s; host "
          f"seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in host.items()),
          file=sys.stderr)
    result = {"correct": correct, "attempted": len(win.samples),
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": check[k], "limit": LIMITS[k]}
                       for k in LIMITS}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), spec.HERE)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad} in the measured process",
              file=sys.stderr)
        return 4
    for k, v in result["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
