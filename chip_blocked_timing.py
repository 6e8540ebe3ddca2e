"""Time the redesigned kernels (A2, A3, A8, A9, A10) on one NVIDIA card.

    python3 chip_blocked_timing.py [tests] [a10] [a8] [a9] [a2] [a3]
        [--reps N]

A quicker loop than ``chip_smoke.py`` while redesigning those kernels:
it builds them (printing ptxas's registers and spills), then runs the
named phases, all by default:

- ``tests``: the card tests of the five kernels
  (``tests/test_torch_cuda.py -k "blocked or hbm or mixed_kernel"``,
  against their plain versions);
- ``a10``: the config-4 insert storm (16 peers x 200 rounds, 128
  documents) through ``run_storm(engine="blocked-mixed")``, its scan
  steps and windows, and the kernel's median time;
- ``a8``: the north star's 19,149-patch prefix on A8, its median time;
- ``a9``: the whole automerge-paper trace on A9, its cache misses and its
  median time at 8, 4, 16, 2 and 1 warps a thread block;
- ``a2``: kevin (5M prepends, 128 documents, K = 2,048) and the north
  star on A2 (1,024 documents, K = 512) through their entry points, then
  each replay's median time at 1, 2, 4, 8 and 16 warps a thread block,
  its splits and window loads, and the share of its cycles spent in
  splits;
- ``a3``: both config-4 storms (128 documents, K = 128) through
  ``run_storm()``, then each replay's median time at 4, 8 and 16 warps
  (128, 256, 512 threads), its hint misses and the blocks its fast-scan
  windows span.

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


def stats_for(torch, wrapper, fn, shape, n, dev):
    """Each chain's counters of one run of ``fn`` (int64, ``shape +
    (n,)``), or None where ``wrapper`` keeps none."""
    if not takes(wrapper, "stats"):
        return None
    stats = torch.zeros(*shape, n, dtype=torch.int64, device=dev)
    fn(stats=stats)
    torch.cuda.synchronize()
    return stats


def time_warps(torch, wrapper, fn, label, steps, counts, reps):
    """The median of ``fn`` at each warp count, or as it is where
    ``wrapper`` takes no ``warps``."""
    if not takes(wrapper, "warps"):
        ms = cuda_ms(torch, fn, reps)
        print(f"{label}: {ms:.3f} ms, {ms * 1e3 / steps:.3f} us a step",
              flush=True)
        return
    for warps in counts:
        ms = cuda_ms(torch, lambda: fn(warps=warps), reps)
        print(f"{label}: {warps} warps, {ms:.3f} ms, "
              f"{ms * 1e3 / steps:.3f} us a step", flush=True)


def phase_a2(torch, dev, reps):
    from text_crdt_rust_tpu_torch import kevin, northstar
    from text_crdt_rust_tpu_torch.ops import rle_hbm as TH

    ks = kevin.compile_kevin(5_000_000, 64)
    krun = kevin.run_kevin(batch=128, device=dev, stream=ks)
    torch.cuda.synchronize()
    print("A2 kevin: flags", krun.result.err[:2].amax(dim=1).tolist(),
          "order ok", krun.order_ok, "all lanes equal", krun.lanes_equal,
          flush=True)
    del krun
    rep = kevin.make_kevin_replayer(ks, batch=128, device=dev)
    nrun = northstar.run_northstar(engine="rle-hbm", batch=1024, device=dev)
    torch.cuda.synchronize()
    print("A2 north star: text ok", nrun.ok, "all lanes equal",
          TH.lanes_equal(nrun.results[0]), flush=True)
    nrep = northstar.make_northstar_replayer(nrun.stream, batch=1024,
                                             device=dev, engine="rle-hbm")
    del nrun
    for label, r, steps in (("A2 kevin", rep, ks.steps),
                            ("A2 north star", nrep, int(
                                ((nrep.staged[1] > 0)
                                 | (nrep.staged[2] > 0)).sum()))):
        def fn(r=r, **kw):
            return TH.rle_hbm_replay_cuda(*r.staged, **r.shape, **kw)

        stats = stats_for(torch, TH.rle_hbm_replay_cuda, fn,
                          (r.shape["groups"], r.shape["batch"]),
                          getattr(TH, "STATS", 0), dev)
        if stats is not None:
            splits, loads, sc, tc = (int(v) for v in stats[0, 0])
            print(f"{label}: {splits} splits, {loads} window loads a lane, "
                  f"{sc / max(tc, 1):.4f} of the chain's cycles in splits "
                  f"({sc / max(splits, 1):.0f} cycles a split)", flush=True)
        time_warps(torch, TH.rle_hbm_replay_cuda, fn, label, steps,
                   (1, 2, 4, 8, 16), reps)
        torch.cuda.empty_cache()
    del rep, nrep
    torch.cuda.empty_cache()


def phase_a3(torch, dev, reps):
    from text_crdt_rust_tpu_torch import storm
    from text_crdt_rust_tpu_torch.ops import rle_mixed as RM

    for name, dp in (("insert storm", 0.0), ("delete-heavy storm", 0.35)):
        run = storm.run_storm(del_prob=dp, device=dev)
        torch.cuda.synchronize()
        print(f"A3 {name}: text ok {run.ok}", flush=True)
        rep = storm.make_storm_replayer(run.stream, device=dev)

        def fn(**kw):
            return RM.rle_mixed_replay_cuda(*rep.staged, **rep.shape, **kw)

        stats = stats_for(torch, RM.rle_mixed_replay_cuda, fn,
                          (rep.shape["batch"],), getattr(RM, "STATS", 0),
                          dev)
        if stats is not None:
            v = [int(x) for x in stats[0]]
            look, miss, scans, blocks, most, walks = v[:6]
            print(f"A3 {name}: {look} order lookups, {miss} hint misses, "
                  f"{scans} fast scans spanning {blocks / max(scans, 1):.3f} "
                  f"blocks on average and {most} at most, {walks} serial "
                  f"walks a lane", flush=True)
            if len(v) >= 10:
                tot = max(v[9], 1)
                print(f"A3 {name}: shares of the chain's {tot} cycles: "
                      f"window passes {v[6] / tot:.4f}, order lookups "
                      f"{v[7] / tot:.4f}, splices {v[8] / tot:.4f}",
                      flush=True)
        time_warps(torch, RM.rle_mixed_replay_cuda, fn, f"A3 {name}",
                   run.stream.steps, (4, 8, 16), reps)


def main(argv=None) -> int:
    phases = ("tests", "a10", "a8", "a9", "a2", "a3")
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
                              "blocked_mixed_replay", "rle_hbm_replay",
                              "rle_mixed_replay"])
    for name, report in reports.items():
        print(name, [line.strip() for line in report.splitlines()
                     if "registers" in line or "spill" in line], flush=True)
    dev = torch.device("cuda")

    if "tests" in args.phases:
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
             "-q", "-x", "tests/test_torch_cuda.py", "-k",
             "blocked or hbm or mixed_kernel", "-p", "no:cacheprovider"],
            capture_output=True, text=True)
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
        else:
            stats = torch.zeros(1, 128, dtype=torch.int32, device=dev)
            TBH.blocked_hbm_replay_cuda(*rep.staged, **rep.shape,
                                        stats=stats)
            torch.cuda.synchronize()
            print("A9 trace: cache misses a lane", int(stats[0, 0]),
                  flush=True)
            for warps in (8, 4, 16, 2, 1):
                ms = cuda_ms(torch, lambda: TBH.blocked_hbm_replay_cuda(
                    *rep.staged, **rep.shape, warps=warps), args.reps)
                print(f"A9 trace: {warps} warps, {ms:.3f} ms", flush=True)
        del rep
        torch.cuda.empty_cache()

    if "a2" in args.phases:
        phase_a2(torch, dev, args.reps)
    if "a3" in args.phases:
        phase_a3(torch, dev, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
