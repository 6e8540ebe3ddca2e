"""Run the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds every CUDA kernel of the port from the sources in
   ``text_crdt_rust_tpu_torch/ops/csrc`` (timed as set-up).
3. Holds each kernel against its plain PyTorch version on the card, on
   the same inputs, bit for bit (the replay state is integers): a fused
   trace prefix, fused prepend bursts (W > 2), two divergent doc groups,
   and the two error cases (block table full, delete past the end).
4. Drives the main path through its entry point,
   ``northstar.run_northstar()``: the full automerge-paper trace replayed
   into 512 identical documents (capacity 20,992 run rows, K = 128,
   fuse_w = 8). With the launch counts set to 0 just before and read just
   after, it fails unless every kernel of the path launched, doc 0
   reproduces the trace's ``endContent`` and every lane equals lane 0.
5. At the main path's shapes: kernel against plain version once more,
   the plain version's time, and the kernel's median time over 3 runs
   after 1 warm-up (CUDA events), with ops/s and device steps.
6. Prints ``{"kernels": [...]}`` and, as its last line,
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line; so does a host without
CUDA, and a directory without the rest of the repository.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate (data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
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


OUTPUTS = ("ol", "orr", "ordp", "lenp", "blkord", "rows", "meta", "err")


def max_abs_err(got, want) -> int:
    """Largest absolute difference over the replay's eight outputs
    (0 = bit-identical; origins compare as their int32 bit patterns)."""
    worst = 0
    for name, g, w in zip(OUTPUTS, got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        if g.numel():
            worst = max(worst, int((g.long() - w.long()).abs().max()))
    return worst


def compare_cases(B, northstar, randedit, TestPatch, np):
    """(label, streams, shape, wants, expect_err) of the kernel-vs-plain
    phase. ``wants`` holds each group's expected text (None for the
    error cases)."""
    rng = np.random.default_rng

    def compile_merged(patches, fuse_w=1):
        merged = B.merge_patches(patches)
        lmax = max([len(p.ins_content) for p in merged] + [1])
        ops, _ = B.compile_local_patches(merged, lmax=lmax, fuse_w=fuse_w)
        if fuse_w > 1:
            ops, _ = B.fuse_steps(ops, fuse_w=fuse_w)
        return ops

    cases = []
    prefix = northstar.compile_northstar(patches=20000, fuse_w=8)
    cases.append(("automerge-paper[:20000] fuse_w=8, B=32, K=16",
                  [prefix.ops], dict(capacity=4096, batch=32, block_k=16),
                  [prefix.want], None))
    bp, bc = randedit.prepend_bursts(rng(3), 60)
    bops, _ = B.compile_local_patches(B.merge_patches(bp), lmax=16,
                                      fuse_w=8)
    bops, _ = B.fuse_steps(bops, fuse_w=8)
    if B.fused_width(bops) <= 2:
        raise AssertionError("the burst stream must fuse wider than 2")
    cases.append((f"prepend bursts W={B.fused_width(bops)}, B=64, K=32",
                  [bops], dict(capacity=2048, batch=64, block_k=32),
                  [bc], None))
    groups, wants = [], []
    for seed in (11, 12):
        gp, gc = randedit.random_patches(rng(seed), 300)
        groups.append(compile_merged(gp))
        wants.append(gc)
    cases.append(("2 divergent groups, B=16, K=8", groups,
                  dict(capacity=1024, batch=16, block_k=8), wants, None))
    full, _ = B.compile_local_patches([TestPatch(0, 0, "ab")] * 40, lmax=2)
    cases.append(("block table full -> err[0]", [full],
                  dict(capacity=16, batch=8, block_k=8), None, 0))
    bad, _ = B.compile_local_patches(
        [TestPatch(0, 0, "abc"), TestPatch(0, 10, "")], lmax=4)
    cases.append(("delete past the end -> err[1]", [bad],
                  dict(capacity=32, batch=8, block_k=8), None, 1))
    return cases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        import numpy as np

        from text_crdt_rust_tpu_torch import northstar
        from text_crdt_rust_tpu_torch.ops import _kernels
        from text_crdt_rust_tpu_torch.ops import batch as B
        from text_crdt_rust_tpu_torch.ops import rle as R
        from text_crdt_rust_tpu_torch.ops import span_arrays as SA
        from text_crdt_rust_tpu_torch.utils import randedit
        from text_crdt_rust_tpu_torch.utils.testdata import TestPatch
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              f"from the root of the repository", file=sys.stderr)
        return 1

    card = card_line()
    log(card)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    reports = _kernels.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{sorted(_kernels.sources())}")
    for name, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # -- kernel vs plain version on the card, small shapes ----------------
    worst = 0
    for label, streams, shape, wants, expect_err in compare_cases(
            B, northstar, randedit, TestPatch, np):
        rep = R.make_replayer_rle(streams, device=dev, **shape)
        plain = R.rle_replay_plain(*rep.staged, **rep.shape)
        kern = R.rle_replay_cuda(*rep.staged, **rep.shape)
        torch.cuda.synchronize()
        err = max_abs_err(kern, plain)
        worst = max(worst, err)
        flags = kern[7][:2].amax(dim=1).tolist()
        if expect_err is None:
            results = rep()
            texts = [SA.to_string(R.rle_to_flat(s, r))
                     for s, r in zip(streams, results)]
            text_ok = texts == wants
        else:
            text_ok = flags[expect_err] == 1
        log(f"compare {label}: max_abs_err {err}, err flags {flags}, "
            f"{'ok' if err == 0 and text_ok else 'FAILED'}")
        if err != 0 or not text_ok:
            raise AssertionError(f"kernel disagrees on: {label}")

    # -- the main path, counted ------------------------------------------
    _kernels.reset_launches()
    t0 = time.perf_counter()
    run = northstar.run_northstar(device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    res = run.results[0]
    lanes_equal = all(
        bool((t == t[:, :1]).all())
        for t in (res.ordp, res.lenp, res.blkord, res.rows, res.ol,
                  res.orr))
    log(f"main path: run_northstar() {run.stream.n_patches} patches -> "
        f"{run.stream.steps} device steps, B={res.batch}, capacity "
        f"{res.ordp.shape[0]}, K={res.block_k}: "
        f"text ok {run.ok}, all lanes equal {lanes_equal}, launches "
        f"{launches}, host wall {wall:.2f} s with compile")
    missing = [n for n in ("rle_replay",) if launches.get(n, 0) < 1]
    if missing or not run.ok or not lanes_equal:
        raise AssertionError(f"main path failed: missing launches "
                             f"{missing}, text ok {run.ok}, lanes equal "
                             f"{lanes_equal}")

    # -- the main path's shapes: agreement and times ------------------------
    rep = northstar.make_northstar_replayer(run.stream, device=dev)
    staged, shape = rep.staged, rep.shape
    t0 = time.perf_counter()
    plain = R.rle_replay_plain(*staged, **shape)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    kern = R.rle_replay_cuda(*staged, **shape)
    torch.cuda.synchronize()
    err = max_abs_err(kern, plain)
    worst = max(worst, err)
    del plain, kern
    log(f"compare main path shape: max_abs_err {err}")
    if err != 0:
        raise AssertionError("kernel disagrees at the main path's shape")
    ms = cuda_ms(torch, lambda: R.rle_replay_cuda(*staged, **shape), reps=3)
    ops_per_s = run.stream.n_patches * shape["batch"] / (ms / 1e3)

    G, S, Bn, CAP = (shape["groups"], shape["steps"], shape["batch"],
                     shape["capacity"])
    K = shape["block_k"]
    NBL = max(8, CAP // K)
    nbytes = 4 * (5 * G * S + 2 * G * CAP * Bn + 2 * G * NBL * Bn
                  + 8 * G * Bn + 2 * G * S * Bn + 8 * Bn)
    # Every step with work scans at least one K-row block and the NBL
    # live-prefix slots in every lane: a lower bound on the operations.
    active = int(((staged[1] > 0) | (staged[2] > 0)).sum())
    nops = active * G * Bn * (K + NBL)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = nops / PEAK_OPS_PER_S * 1e3
    log(f"replay: median {ms:.3f} ms over 3 reps after 1 warm-up (CUDA "
        f"events); {ops_per_s:.4g} patches/s ({run.stream.n_patches} x "
        f"{Bn} docs); {active} device steps; plain version {plain_ms:.1f} "
        f"ms; bound {max(bytes_ms, ops_ms):.4f} ms; on {card}")

    log(json.dumps({"kernels": [{
        "name": "rle_replay",
        "route": "cuda",
        "source": "text_crdt_rust_tpu_torch/ops/csrc/rle_replay.cu",
        "replaces": "text_crdt_rust_tpu/ops/rle.py:283",
        "jax_counterpart": "text_crdt_rust_tpu/ops/rle.py::_rle_kernel",
        "launches": launches.get("rle_replay", 0),
        "matches_plain": worst == 0,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "bytes": nbytes,
        "ops_lower_bound": nops,
        "serial_steps": active,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
