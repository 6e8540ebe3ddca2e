"""The measured window: one caller replaying back to back (a closed loop),
and the CUDA events the traced run puts around each kernel launch."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List

import torch


@dataclasses.dataclass
class Window:
    samples: List[float]   # each replay's host time, call to synchronize (s)
    window_s: float        # the window's start to its last synchronize
    last: Any              # the last replay's outputs


def closed_loop(replay: Callable[[], Any], seconds: float,
                sync: Callable[[], None], span=None,
                on_replay: Callable[[int], None] = None) -> Window:
    """Replay until ``seconds`` have passed. No earlier replay's outputs
    stay alive while the next runs; the last one's are returned. ``span``
    (a context manager factory) marks each call and synchronize."""
    span = span or (lambda name: contextlib.nullcontext())
    samples: List[float] = []
    out = None
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        if on_replay is not None:
            on_replay(len(samples))
        t0 = time.perf_counter()
        out = None
        with span("replay.call"):
            out = replay()
        with span("replay.sync"):
            sync()
        t1 = time.perf_counter()
        samples.append(t1 - t0)
        if t1 >= deadline:
            return Window(samples=samples, window_s=t1 - start, last=out)


class LaunchEvents:
    """CUDA events around every launch made through the port's
    ``_kernels.function`` while active: the launcher's kernels, on the
    stream it is handed (PyTorch's current stream)."""

    def __init__(self, kernels_module):
        self.kern = kernels_module
        self.replay = 0
        self.marks = []            # (replay, kernel, start, end)

    def __enter__(self):
        self.orig = self.kern.function
        self.kern.function = self._function
        return self

    def __exit__(self, *exc):
        self.kern.function = self.orig
        return False

    def _function(self, name, symbol, argtypes):
        fn = self.orig(name, symbol, argtypes)

        def call(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            code = fn(*args)
            b.record()
            self.marks.append((self.replay, name, a, b))
            return code

        return call

    def per_replay_ms(self, replays: int) -> Dict[str, List[float]]:
        """Each kernel's event milliseconds summed over each replay (call
        after a synchronize)."""
        out: Dict[str, List[float]] = {}
        for r, name, a, b in self.marks:
            if r < replays:
                out.setdefault(name, [0.0] * replays)[r] += \
                    a.elapsed_time(b)
        return out
