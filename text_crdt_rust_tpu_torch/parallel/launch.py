"""A world of N ranks on ``torch.distributed``: the port's stand-in for the
JAX package's virtual device mesh (``--xla_force_host_platform_device_count``).

``World(n, backend, device)`` spawns ``n`` processes (``torch.multiprocessing``
with the ``spawn`` start method), joins them in one process group through a
``FileStore`` in a fresh temporary directory, and keeps them waiting for
jobs. ``World.run(fn, *args)`` runs ``fn(ctx, *args)`` on every rank, where
``ctx`` is this rank's ``Rank`` (rank, world size, device, backend), and
returns rank 0's result; ``fn`` must be importable by name (a module-level
function of a module that the children can import). A rank keeps what one
job leaves for the next in ``ctx.store`` (a dict that lives as long as the
rank). ``run_world`` starts a world, runs one job and stops it.

The caller names the collective backend and the device; nothing here picks
either by itself:

- ``backend="nccl"``, ``device=None``: rank r runs on ``cuda:r``, one card
  each (NCCL refuses two ranks on one card);
- ``backend="gloo"``, ``device="cpu"``: every rank on the CPU;
- ``backend="gloo"``, ``device="cuda:0"`` (any one named card): every rank
  shares that card, the collectives go over gloo (a machine with fewer
  cards than ranks; ``Rank.shared_card`` says so).

Every world has a time limit: ``init_process_group(timeout=...)`` bounds each
collective, and a world from which no rank has answered for ``timeout``
seconds is killed, every rank, and ``TimeoutError`` raised (the wait is
the results queue's own, so this package reads no clock). A rank that fails
sends its traceback; the world is then stopped (its ranks may be out of
step) and ``RuntimeError`` carries the traceback. A later ``run`` starts a
fresh world.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: Seconds a job (and every collective inside it) may take by default.
TIMEOUT = 120.0
#: Seconds a new world may take to start before it is killed.
START_TIMEOUT = 120.0


@dataclasses.dataclass(frozen=True)
class Rank:
    """What a job learns about its rank, and ``store``: what an earlier job
    on this rank left for the next ones."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    store: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def shared_card(self) -> bool:
        """Every rank runs on the same card (gloo between processes)."""
        return self.device.type == "cuda" and self.world_size > 1 \
            and self.backend == "gloo"


def rank_device(rank: int, world_size: int, backend: str,
                device=None) -> torch.device:
    """The device of ``rank`` under the caller's ``backend`` and ``device``
    (see the module docstring); raises on a combination that cannot run."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown collective backend {backend!r}")
    if device is None:
        if backend != "nccl":
            raise ValueError("device=None means one card a rank, which "
                             "needs backend='nccl'; name the device for "
                             "gloo ('cpu', or one card to share)")
        return torch.device("cuda", rank)
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend != "gloo":
            raise ValueError("CPU ranks need backend='gloo'")
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if backend == "nccl" and world_size > 1:
        raise ValueError("NCCL takes one card a rank; pass device=None, or "
                         "backend='gloo' to share one card")
    return torch.device("cuda", 0 if dev.index is None else dev.index)


def _check_cards(world_size: int, backend: str, device) -> None:
    """Raise in the caller's process before spawning a world that cannot
    find its cards."""
    devs = {rank_device(r, world_size, backend, device)
            for r in range(world_size)}
    if any(d.type == "cuda" for d in devs):
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "and backend='gloo' to run on the CPU")
        have = torch.cuda.device_count()
        need = 1 + max(d.index for d in devs)
        if need > have:
            raise RuntimeError(f"the world needs {need} cards and this "
                               f"machine has {have}")


def _rank_main(rank, world_size, backend, device, store_path, timeout,
               jobs, results):
    try:
        torch.set_num_threads(1)
        dev = rank_device(rank, world_size, backend, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        ctx = Rank(rank, world_size, dev, backend)
        results.put((rank, "ready", None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            break
        fn, args, kwargs = job
        try:
            out = fn(ctx, *args, **kwargs)
            results.put((rank, "done", out if rank == 0 else None))
        except BaseException:
            results.put((rank, "error", traceback.format_exc()))
    dist.destroy_process_group()


class World:
    """``n`` ranks in one process group, waiting for jobs (see the module
    docstring). Use as a context manager, or call ``close()``."""

    def __init__(self, n: int, backend: str, device=None,
                 timeout: float = TIMEOUT):
        _check_cards(n, backend, device)
        self.n, self.backend, self.device = n, backend, device
        self.timeout = float(timeout)
        self.starts = 0
        self._procs = []

    @property
    def alive(self) -> bool:
        return bool(self._procs)

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.mkdtemp(prefix="tcr_world_")
        store = os.path.join(self._tmp, "store")
        self._jobs = [ctx.SimpleQueue() for _ in range(self.n)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, self.n, self.backend, self.device, store,
                              self.timeout, self._jobs[r], self._results))
            for r in range(self.n)]
        for p in self._procs:
            p.start()
        self.starts += 1
        self._collect(START_TIMEOUT)

    def _collect(self, timeout: float):
        """Wait for every rank's answer; stop the world and raise on an
        error or when no answer came for ``timeout`` seconds. Returns
        rank 0's payload."""
        got, out = 0, None
        while got < self.n:
            try:
                rank, kind, payload = self._results.get(timeout=timeout)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                self.close(kill=True)
                raise TimeoutError(
                    f"world of {self.n} ({self.backend}) did not answer "
                    f"within {timeout:.0f} s; ranks {dead} had exited; "
                    f"every rank was killed") from None
            if kind == "error":
                self.close(kill=True)
                raise RuntimeError(f"rank {rank} of {self.n} failed:\n"
                                   f"{payload}")
            got += 1
            if rank == 0:
                out = payload
        return out

    def run(self, fn: Callable, *args, timeout: Optional[float] = None,
            **kwargs) -> Any:
        """``fn(ctx, *args, **kwargs)`` on every rank; rank 0's result."""
        if not self._procs:
            self._start()
        for q in self._jobs:
            q.put((fn, args, kwargs))
        return self._collect(self.timeout if timeout is None else timeout)

    def close(self, kill: bool = False) -> None:
        """Stop every rank (at once with ``kill``) and remove the store."""
        if not self._procs:
            return
        if not kill:
            for q in self._jobs:
                q.put(None)
            for p in self._procs:
                p.join(timeout=30)
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join()
        self._procs = []
        self._results.close()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)


def run_world(fn: Callable, n: int, backend: str, device=None, *args,
              timeout: float = TIMEOUT, **kwargs) -> Any:
    """Start a world of ``n`` ranks, run ``fn(ctx, *args, **kwargs)`` on
    every rank, stop the world; rank 0's result."""
    with World(n, backend, device, timeout) as w:
        return w.run(fn, *args, **kwargs)


__all__ = ["Rank", "TIMEOUT", "World", "rank_device", "run_world"]
