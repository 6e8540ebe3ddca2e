"""Time the per-character block kernels (A8, A9, A10) on one NVIDIA card.

    python3 chip_blocked_timing.py [tests] [a10] [a8] [a9] [--reps N]

A quicker loop than ``chip_smoke.py`` while redesigning those three
kernels: it builds them (printing ptxas's registers and spills), then
runs the named phases, all by default:

- ``tests``: the card tests of the three kernels
  (``tests/test_torch_cuda.py -k blocked``, against their plain versions);
- ``a10``: the config-4 insert storm (16 peers x 200 rounds, 128
  documents) through ``run_storm(engine="blocked-mixed")``, its scan
  steps and windows, and the kernel's median time;
- ``a8``: the north star's 19,149-patch prefix on A8, its median time;
- ``a9``: the whole automerge-paper trace on A9, its cache misses and its
  median time at 8, 4, 16, 2 and 1 warps a thread block.

Times are medians of ``--reps`` runs (3) after 1 warm-up, CUDA events.
The plain versions are not timed here; ``chip_smoke.py`` holds every
kernel against them and is the record.

To time another checkout's kernels with the same script (a parent
commit beside this one, in one call on one card), run it from that
checkout's root so that its package is the one imported::

    python3 -c "import runpy, sys; sys.argv = ['t', 'a10', 'a8', 'a9'];
        runpy.run_path('/path/to/chip_blocked_timing.py',
                       run_name='__main__')"

Wrappers without ``stats`` or ``warps`` are timed as they are.
"""
from __future__ import annotations

import argparse
import inspect
import statistics
import subprocess
import sys


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def takes(fn, name: str) -> bool:
    return name in inspect.signature(fn).parameters


def main(argv=None) -> int:
    phases = ("tests", "a10", "a8", "a9")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="*", help=f"any of {phases} (all)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if set(args.phases) - set(phases):
        ap.error(f"phases must be among {phases}")
    args.phases = args.phases or list(phases)

    import torch

    if not torch.cuda.is_available():
        print("chip_blocked_timing: CUDA is not available", file=sys.stderr)
        return 1
    from text_crdt_rust_tpu_torch import northstar, storm
    from text_crdt_rust_tpu_torch.ops import _kernels
    from text_crdt_rust_tpu_torch.ops import blocked as TBL
    from text_crdt_rust_tpu_torch.ops import blocked_hbm as TBH
    from text_crdt_rust_tpu_torch.ops import blocked_mixed as TBM

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    reports = _kernels.build(["blocked_replay", "blocked_hbm_replay",
                              "blocked_mixed_replay"])
    for name, report in reports.items():
        print(name, [line.strip() for line in report.splitlines()
                     if "registers" in line or "spill" in line], flush=True)
    dev = torch.device("cuda")

    if "tests" in args.phases:
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
             "-q", "-x", "tests/test_torch_cuda.py", "-k", "blocked",
             "-p", "no:cacheprovider"], capture_output=True, text=True)
        print(r.stdout[-3000:], r.stderr[-2000:], flush=True)
        if r.returncode != 0:
            return 1

    if "a10" in args.phases:
        run = storm.run_storm(rounds=200, batch=128, engine="blocked-mixed",
                              device=dev)
        torch.cuda.synchronize()
        print("A10 storm: text ok", run.ok, "all lanes equal",
              TBL.lanes_equal(run.result), flush=True)
        rep = storm.make_storm_replayer(run.stream, batch=128,
                                        engine="blocked-mixed", device=dev)
        ms = cuda_ms(torch, lambda: TBM.blocked_mixed_replay_cuda(
            *rep.staged, **rep.shape), args.reps)
        print(f"A10 storm: {ms:.3f} ms", flush=True)
        if takes(TBM.blocked_mixed_replay_cuda, "stats"):
            stats = torch.zeros(2, 128, dtype=torch.int32, device=dev)
            TBM.blocked_mixed_replay_cuda(*rep.staged, **rep.shape,
                                          stats=stats)
            torch.cuda.synchronize()
            steps, windows = int(stats[0, 0]), int(stats[1, 0])
            print(f"A10 storm: {steps} scan steps, {windows} windows a "
                  f"lane, {ms * 1e3 / steps:.5f} us a scan step",
                  flush=True)

    if "a8" in args.phases:
        pre = northstar.run_northstar(engine="blocked", patches=19149,
                                      batch=128, device=dev)
        rep = northstar.make_northstar_replayer(pre.stream, batch=128,
                                                engine="blocked", device=dev)
        ms = cuda_ms(torch, lambda: TBL.blocked_replay_cuda(*rep.staged,
                                                            **rep.shape),
                     args.reps)
        print(f"A8 prefix: text ok {pre.ok}, {ms:.3f} ms", flush=True)

    if "a9" in args.phases:
        run = northstar.run_northstar(engine="hbm", batch=128, device=dev)
        print("A9 trace: text ok", run.ok, "all lanes equal",
              TBL.lanes_equal(run.results[0]), flush=True)
        del run
        stream = northstar.compile_northstar(engine="hbm")
        rep = northstar.make_northstar_replayer(stream, batch=128,
                                                engine="hbm", device=dev)
        if not takes(TBH.blocked_hbm_replay_cuda, "warps"):
            ms = cuda_ms(torch, lambda: TBH.blocked_hbm_replay_cuda(
                *rep.staged, **rep.shape), args.reps)
            print(f"A9 trace: {ms:.3f} ms", flush=True)
            return 0
        stats = torch.zeros(1, 128, dtype=torch.int32, device=dev)
        TBH.blocked_hbm_replay_cuda(*rep.staged, **rep.shape, stats=stats)
        torch.cuda.synchronize()
        print("A9 trace: cache misses a lane", int(stats[0, 0]), flush=True)
        for warps in (8, 4, 16, 2, 1):
            ms = cuda_ms(torch, lambda: TBH.blocked_hbm_replay_cuda(
                *rep.staged, **rep.shape, warps=warps), args.reps)
            print(f"A9 trace: {warps} warps, {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
