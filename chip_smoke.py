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
6. The mixed run replay (``rle_mixed_replay``) against its plain version
   on the card, bit for bit on all eight outputs: a small delete storm
   (K = 8), a mid storm (16 peers x 20 rounds, K = 32) with the fast
   YATA scan and with the serial walk alone, a two-peer merge with
   splits and mid-run cursors, a local-only stream, and a capacity
   overflow that must raise ``err[0]``.
7. Drives the storm path through its entry point, ``storm.run_storm()``:
   the config-4 insert storm and its delete-heavy variant (16 peers x
   200 rounds, 128 documents, K = 128), launch counts set to 0 just
   before and read just after. It fails unless ``rle_mixed_replay``
   launched at least twice, both texts equal the oracle receiver's and
   every lane equals lane 0.
8. At the storm shapes, per variant: host set-up (generation and
   compile), kernel against plain version once more, the plain
   version's time, the kernel's median over 3 runs after 1 warm-up
   (CUDA events), char-ops/s, device steps and the bound.
9. Prints ``{"kernels": [...]}`` (both kernels) and, as its last line,
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


def mixed_compare_cases(B, storm, randedit, TestPatch, np):
    """(label, ops, replayer kwargs, expected text or None, expected err
    row or None) of the mixed replay's kernel-vs-plain phase."""
    cases = []
    txns, recv = randedit.make_storm(3, 4, 2, seed=7, del_prob=0.3)
    cases.append(("small delete storm 3x4, B=16, K=8",
                  storm.compile_storm_txns(txns, 2, 0.3),
                  dict(capacity=256, batch=16, block_k=8, chunk=32),
                  recv.to_string(), None))
    txns, recv = randedit.make_storm(16, 20, 4, seed=7, del_prob=0.35)
    mid = storm.compile_storm_txns(txns, 4, 0.35)
    mid_cap = storm.storm_capacity(mid, 32)
    for fast in (True, False):
        cases.append((f"mid storm 16x20, {'fast' if fast else 'serial'} "
                      f"scan, B=32, K=32", mid,
                      dict(capacity=mid_cap, batch=32, block_k=32,
                           chunk=128, fast_integrate=fast),
                      recv.to_string(), None))
    txns, recv = randedit.make_two_peer_merge(400)
    two_peer, _ = B.compile_remote_txns(
        txns, B.AgentTable(sorted({t.id.agent for t in txns})), lmax=4)
    cases.append(("two-peer merge (serial fallback), B=16, K=8", two_peer,
                  dict(capacity=1024, batch=16, block_k=8, chunk=32),
                  recv.to_string(), None))
    lp, lc = randedit.random_patches(np.random.default_rng(5), 120)
    local, _ = B.compile_local_patches(B.merge_patches(lp), lmax=8)
    cases.append(("local-only stream, B=16, K=8", local,
                  dict(capacity=512, batch=16, block_k=8, chunk=128),
                  lc, None))
    full, _ = B.compile_local_patches([TestPatch(0, 0, "ab")] * 40, lmax=2)
    cases.append(("block table full -> err[0]", full,
                  dict(capacity=16, batch=8, block_k=8, chunk=64), None, 0))
    return cases


def all_lanes_equal(res) -> bool:
    """Every lane of a replay result equals lane 0."""
    return all(bool((t == t[:, :1]).all())
               for t in (res.ordp, res.lenp, res.blkord, res.rows, res.meta,
                         res.ol, res.orr, res.err))


def mixed_bound(staged, shape):
    """(bytes, operations) that one mixed replay must at least move and do:
    each input read once and each output written once, and per lane one
    K-row block plus the NBL slot prefixes for every step with work. The
    kernel's passes over all CAP run rows (the fast scan's classification,
    the delete's flip) are its own choice, not needed by the function, and
    are not counted."""
    S, Bn, CAP, K = (shape["steps"], shape["batch"], shape["capacity"],
                     shape["block_k"])
    NBL = max(8, CAP // K)
    OTL = shape["order_rows"] * 128
    nbytes = 4 * (9 * S + 3 * OTL + 2 * S * Bn + 2 * CAP * Bn
                  + 2 * NBL * Bn + 16 * Bn)
    kind, dlen, ilen = staged[0], staged[2], staged[7]
    active = int(((dlen > 0) | (ilen > 0) | (kind == 2)).sum())
    nops = Bn * active * (K + NBL)
    return nbytes, nops


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        import numpy as np

        from text_crdt_rust_tpu_torch import northstar, storm
        from text_crdt_rust_tpu_torch.ops import _kernels
        from text_crdt_rust_tpu_torch.ops import batch as B
        from text_crdt_rust_tpu_torch.ops import rle as R
        from text_crdt_rust_tpu_torch.ops import rle_mixed as RM
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

    rle_line = {
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
    }

    # -- the mixed replay against its plain version, small shapes ----------
    mworst = 0
    for label, ops, kw, want, expect_err in mixed_compare_cases(
            B, storm, randedit, TestPatch, np):
        rep = RM.make_replayer_rle_mixed(ops, device=dev, **kw)
        plain = RM.rle_mixed_replay_plain(*rep.staged, **rep.shape)
        kern = RM.rle_mixed_replay_cuda(*rep.staged, **rep.shape)
        torch.cuda.synchronize()
        err = max_abs_err(kern, plain)
        mworst = max(mworst, err)
        flags = kern[7][:3].amax(dim=1).tolist()
        if expect_err is None:
            text_ok = flags == [0, 0, 0] and SA.to_string(
                R.rle_to_flat(ops, rep())) == want
        else:
            text_ok = flags[expect_err] == 1
        log(f"compare mixed {label}: {ops.num_steps} steps, max_abs_err "
            f"{err}, err flags {flags}, "
            f"{'ok' if err == 0 and text_ok else 'FAILED'}")
        if err != 0 or not text_ok:
            raise AssertionError(f"mixed kernel disagrees on: {label}")

    # -- the storm path, counted ------------------------------------------
    variants = (("insert storm", 0.0), ("delete-heavy storm", 0.35))
    _kernels.reset_launches()
    t0 = time.perf_counter()
    runs = [storm.run_storm(del_prob=dp, device=dev) for _, dp in variants]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mlaunches = _kernels.launches.get("rle_mixed_replay", 0)
    equal = [all_lanes_equal(r.result) for r in runs]
    for (name, _), r, eq in zip(variants, runs, equal):
        res = r.result
        log(f"storm path: run_storm({name}) {len(r.stream.txns)} txns -> "
            f"{r.stream.steps} device steps, B={res.batch}, capacity "
            f"{res.ordp.shape[0]}, K={res.block_k}: text ok {r.ok}, all "
            f"lanes equal {eq}")
    log(f"storm path: launches {dict(_kernels.launches)}, host wall "
        f"{wall:.2f} s for both (generation, compile, replay, readback)")
    if mlaunches < 2 or not all(r.ok for r in runs) or not all(equal):
        raise AssertionError(
            f"storm path failed: rle_mixed_replay launches {mlaunches}, "
            f"text ok {[r.ok for r in runs]}, lanes equal {equal}")

    # -- the storm shapes: set-up, agreement and times ----------------------
    per_variant = []
    for (name, dp), r in zip(variants, runs):
        t0 = time.perf_counter()
        stream = storm.make_storm_stream(del_prob=dp)
        setup_s = time.perf_counter() - t0
        if stream.steps != r.stream.steps or stream.want != r.stream.want:
            raise AssertionError(f"{name}: regenerated storm differs")
        log(f"host set-up {name}: {setup_s:.2f} s (generation with the "
            f"oracle + compile, {len(stream.txns)} txns -> "
            f"{stream.steps} steps)")
        rep = storm.make_storm_replayer(stream, device=dev)
        staged, shape = rep.staged, rep.shape
        t0 = time.perf_counter()
        plain = RM.rle_mixed_replay_plain(*staged, **shape)
        torch.cuda.synchronize()
        mplain_ms = (time.perf_counter() - t0) * 1e3
        kern = RM.rle_mixed_replay_cuda(*staged, **shape)
        torch.cuda.synchronize()
        err = max_abs_err(kern, plain)
        mworst = max(mworst, err)
        del plain, kern
        log(f"compare {name} shape: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"mixed kernel disagrees at the {name} "
                                 f"shape")
        mms = cuda_ms(torch,
                      lambda: RM.rle_mixed_replay_cuda(*staged, **shape),
                      reps=3)
        mbytes, mops = mixed_bound(staged, shape)
        b_ms = mbytes / PEAK_BYTES_PER_S * 1e3
        o_ms = mops / PEAK_OPS_PER_S * 1e3
        rate = stream.char_ops * shape["batch"] / (mms / 1e3)
        log(f"replay {name}: median {mms:.3f} ms over 3 reps after 1 "
            f"warm-up (CUDA events); {rate:.4g} char-ops/s "
            f"({stream.char_ops} x {shape['batch']} docs); "
            f"{stream.steps} device steps "
            f"({mms * 1e3 / stream.steps:.2f} us each); plain version "
            f"{mplain_ms:.1f} ms; bound {max(b_ms, o_ms):.4f} ms "
            f"({mbytes} B, {mops} ops); on {card}")
        per_variant.append(dict(
            variant=name, steps=stream.steps, char_ops=stream.char_ops,
            batch=shape["batch"], capacity=shape["capacity"], ms=mms,
            plain_ms=mplain_ms, bound_ms=max(b_ms, o_ms),
            bound_by="bytes" if b_ms >= o_ms else "operations",
            bytes=mbytes, ops_lower_bound=mops, char_ops_per_s=rate,
            setup_s=setup_s))

    m_bytes_ms = sum(v["bytes"] for v in per_variant) / PEAK_BYTES_PER_S * 1e3
    m_ops_ms = (sum(v["ops_lower_bound"] for v in per_variant)
                / PEAK_OPS_PER_S * 1e3)
    mixed_line = {
        "name": "rle_mixed_replay",
        "route": "cuda",
        "source": "text_crdt_rust_tpu_torch/ops/csrc/rle_mixed_replay.cu",
        "replaces": "text_crdt_rust_tpu/ops/rle_mixed.py:144",
        "jax_counterpart":
            "text_crdt_rust_tpu/ops/rle_mixed.py::_mixed_rle_kernel",
        "launches": mlaunches,
        "matches_plain": mworst == 0,
        "max_abs_err": mworst,
        # The storm path launches once per variant: its times add up.
        "ms": sum(v["ms"] for v in per_variant),
        "plain_ms": sum(v["plain_ms"] for v in per_variant),
        "bound_ms": max(m_bytes_ms, m_ops_ms),
        "bound_by": "bytes" if m_bytes_ms >= m_ops_ms else "operations",
        "library_ms": None,
        "variants": per_variant,
    }
    log(json.dumps({"kernels": [rle_line, mixed_line]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
