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
9. The per-lane mixed replays, un-blocked (``rle_lanes_mixed``) and
   blocked (``rle_lanes_mixed_blocked``), against their plain versions on
   the card, bit for bit on all 8 and 14 outputs: divergent tiebreaks,
   two-peer merges, fragmented and double deletes, local and remote ops in
   one step, K = 8 storms (splits, stale hints, forward hops, the plane
   fallback), a warm-start chain growing its capacity, the error rows.
10. Drives the config-5r path through its entry point,
   ``stream.run_stream()``: 2,048 documents x 8 chunks x 100 patches,
   K = 64, a checkpoint every 4 chunks, launch counts set to 0 just before
   and read just after. It fails unless the blocked kernel launched once
   per chunk, every chunk's flags were clear and every sampled document
   equals the oracle. Host set-up (generation, compile) is timed apart.
11. At the 5r shapes: the chain of 8 blocked launches against the plain
   chain, bit for bit after every chunk; the plain chain's time; the
   kernel chain's median over 3 runs after 1 warm-up (CUDA events);
   char-ops/s; per-chunk blocking time per real step (p50, p99); the
   checkpoint time; peak device memory; device steps and the bound. The
   blocked plain chain runs on every 16th document (128 of 2,048, at the
   same per-document shapes): documents are independent (the CPU tests
   hold a B-lane replay against B one-lane replays), and the plain chain
   of all 2,048 takes about 20 minutes.
12. The un-blocked kernel on the same stream: against its plain version
   on every 8th document (256) and against the blocked kernel on all
   2,048 (expanded lanes, origins, tables).
13. ``examples/sync_stream`` through the un-blocked kernel (128 documents
   x 3 chunks x 15 patches per peer, every chunk oracle-checked).
14. The per-lane local replays, un-blocked (``rle_lanes``) and blocked
   (``rle_lanes_blocked``), against their plain versions on the card, bit
   for bit on all 6 and 9 outputs: divergent documents (the CPU tests'
   seeds 7 and 42, K = 16 and 8, splits), pure inserts and deletes with
   the SHARED_CUM hoist, fused W-row bursts, both error rows with their
   post-error state, and a warm-start chain growing its capacity 64 ->
   128 -> 192 at K = 8.
15. Drives the config-5 path through its entry point,
   ``stream.run_stream_5()``: 2,048 documents x 8 chunks x 100 local
   patches, K = 64, capacity growing to 1,664 run rows, a checkpoint every
   4 chunks, launch counts set to 0 just before and read just after. It
   fails unless ``rle_lanes_blocked`` launched once per chunk, every
   chunk's flags were clear and every sampled document's text equals the
   string simulation. Host set-up (generation, compile) is timed apart.
16. At the config-5 shapes: the chain of 8 blocked launches against the
   plain chain on all 2,048 documents, bit for bit after every chunk; the
   plain chain's time; the kernel chain's median over 3 runs after 1
   warm-up (CUDA events); patches/s; per-chunk blocking time per real step
   (p50, p99); the checkpoint time; peak device memory; device steps and
   the bound.
17. The un-blocked kernel on the same stream: through
   ``run_stream_5(engine="unblocked")`` with the launch counts set to 0
   just before and read just after, against its plain version on all
   2,048 documents, and against the blocked kernel (origins every chunk,
   every document); its chain's median time and bound.
18. The HBM-plane run replay (``rle_hbm_replay``, A2) against its plain
   version on the card, bit for bit on all eight outputs: random streams
   and three divergent groups at K = 8, fused prepend bursts at K = 64, a
   far-jump stream beside a raw random one at K = 512 (window misses), 20k
   prepends fused W = 64 at K = 2,048 (splits) with and without origins,
   and both error rows.
19. Drives kevin through its entry point, ``kevin.run_kevin()``:
   5,000,000 single-char prepends fused to 78,125 W = 64 steps, 128
   documents, K = 2,048, capacity 10,500,096 run rows (10.75 GB of
   planes), no per-op origins; launch counts set to 0 just before and
   read just after. It fails unless ``rle_hbm_replay`` launched, the
   flags are clear, lane 0 expands to orders ``n .. 1`` and every lane
   equals lane 0 over the used blocks. Host set-up (``compile_kevin``)
   apart; the kernel's median over 3 runs after 1 warm-up (CUDA events),
   prepends/s, device steps, blocks in use, peak device memory above what
   was held before, the bound. The planes are freed after it.
20. The plain check at kevin's geometry: kernel against plain version, bit
   for bit, on all 5,000,000 prepends (78,125 steps, K = 2,048, W = 64,
   128 documents, origins kept so they are checked too), the plain
   version's time.
21. Drives the north star on A2 through ``northstar.run_northstar(engine=
   "rle-hbm", batch=1024)`` (K = 512, capacity 32,768), counted the same
   way: it fails unless doc 0 reproduces ``endContent`` and every lane
   equals lane 0; then, at the same shapes, the kernel against its plain
   version and against A1's kernel on the same stream (lane 0's expanded
   runs and origins), times and the bound.
22. The per-character block replay with the document in shared memory
   (``blocked_replay``, A8) against its plain version on the card (random
   streams with rebalances at K = 16 and 32, prepends, a delete across
   blocks, the delete past the end), then the north star's 19,149-patch
   prefix (16,384 inserted characters, capacity 32,768 rows, K = 512, 128
   documents) through ``northstar.run_northstar(engine="blocked")``,
   counted: it fails unless the kernel launched, doc 0 reproduces the
   prefix's text and every lane equals lane 0. At that shape: the kernel
   against its plain version on all 128 lanes, against A9's kernel on the
   same stream and geometry (``signed``, ``rows[:NB]``, ``ol``, ``orr``,
   ``err``), its median over 3 runs after 1 warm-up, patches/s, the bound.
23. The main path of this slice, the per-character replay with the rows
   in device memory (``blocked_hbm_replay``, A9): the small cases (three
   doc groups included), then the whole automerge-paper trace (259,778
   steps, capacity 524,288 rows, K = 512, 128 documents) through
   ``northstar.run_northstar(engine="hbm")``, counted the same way, with
   doc 0 against ``endContent`` and peak device memory. At that shape: the
   kernel against its plain version over all 259,778 steps on lanes 0-7,
   and every one of the kernel's 128 lanes equal to lane 0 (every lane
   replays the same stream, and the plain version replays each step as a
   sequence of small PyTorch operations: minutes on one CPU core even at
   8 lanes); the median over 3 runs after 1 warm-up, patches/s, the
   rebalance count and the bound, without and with the rebalances'
   traffic.
24. The per-character mixed replay (``blocked_mixed_replay``, A10): small
   storms, a delete storm and an unknown delete target (err rows 1 and 2)
   against its plain version, then the config-4 insert storm (16 peers x
   200 rounds, 12,800 characters, capacity 32,768 rows, K = 256, 128
   documents) through ``storm.run_storm(engine="blocked-mixed")``,
   counted: it fails unless the kernel launched, doc 0 equals the oracle
   receiver and every lane equals lane 0. The main path's outputs against
   the plain version over all 3,200 steps on all 128 lanes (its ~9.7M
   conflict-scan steps read a host copy of the state: under a minute on
   one CPU core), then the median over 3 runs after 1 warm-up, char-ops/s,
   the bound.
   The plain versions of phases 22-24 at those shapes run on the CPU in
   three child processes, one thread each, started when phase 21 ends
   (so they take no core from the earlier phases' plain checks); the
   three phases run in the order 24, 22, 23, each doing its card work
   first and waiting for its plain result last.
25. Prints ``{"kernels": [...]}`` (all ten kernels) and, as its last
   line, ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line; so does a host without
CUDA, and a directory without the rest of the repository.
"""
from __future__ import annotations

import atexit
import json
import multiprocessing
import statistics
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate (data sheet)
PLAIN_STRIDE_A7 = 16           # 5r blocked plain chain: every 16th doc
PLAIN_STRIDE_A6 = 8            # 5r un-blocked plain chain: every 8th doc


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


def compile_patches(B, patches, fuse_w=1):
    """A patch list merged, compiled at its longest insert and, for
    ``fuse_w`` > 1, fused."""
    merged = B.merge_patches(patches)
    lmax = max([len(p.ins_content) for p in merged] + [1])
    ops, _ = B.compile_local_patches(merged, lmax=lmax, fuse_w=fuse_w)
    if fuse_w > 1:
        ops, _ = B.fuse_steps(ops, fuse_w=fuse_w)
    return ops


def compare_cases(B, northstar, randedit, TestPatch, np):
    """(label, streams, shape, wants, expect_err) of the kernel-vs-plain
    phase. ``wants`` holds each group's expected text (None for the
    error cases)."""
    rng = np.random.default_rng

    def compile_merged(patches, fuse_w=1):
        return compile_patches(B, patches, fuse_w)

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


# -- the per-lane mixed replays ------------------------------------------------

A6_OUTPUTS = ("ol", "orr", "ordp", "lenp", "rows", "oll", "orl", "err")
A7_OUTPUTS = ("ol", "orr", "ordp", "lenp", "nlog", "blkord", "rws", "liv",
              "raw", "oll", "orl", "ordblk", "fwd", "err")


def worst_err(got, want, names) -> int:
    """Largest absolute difference over a replay's outputs (0 =
    bit-identical; origins compare as their int32 bit patterns)."""
    worst = 0
    for name, g, w in zip(names, got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        if g.numel():
            worst = max(worst, int((g.long() - w.long()).abs().max()))
    return worst


def lanes_cases(B, randedit, common, Patch, ListCRDT, export):
    """(label, stacked per-lane ops, un-blocked capacity, blocked shape,
    expected error row or None) of the per-lane kernels' small phase,
    built by the port alone."""
    import random

    RemoteId, RemoteIns, RemoteDel, RemoteTxn = (
        common.RemoteId, common.RemoteIns, common.RemoteDel,
        common.RemoteTxn)
    root = RemoteId("ROOT", 0xFFFFFFFF)

    def txn(agent, seq, op, parents=()):
        return RemoteTxn(id=RemoteId(agent, seq), parents=list(parents),
                         ops=[op])

    def lanes(lane_txns, lmax=4):
        opses = []
        for txns in lane_txns:
            table = B.AgentTable()
            for t in txns:
                table.add(t.id.agent)
                for op in t.ops:
                    if hasattr(op, "id"):
                        table.add(op.id.agent)
            opses.append(B.compile_remote_txns(txns, table, lmax=lmax)[0])
        return B.stack_ops(opses)

    def peer(patches, agent):
        doc = ListCRDT()
        a = doc.get_or_create_agent_id(agent)
        for p in patches:
            if p.del_len:
                doc.local_delete(a, p.pos, p.del_len)
            if p.ins_content:
                doc.local_insert(a, p.pos, p.ins_content)
        return export(doc, 0)

    def two_peer(seed, n=3, patches=20):
        rng = random.Random(seed)
        return [peer(randedit.random_patches(rng, patches)[0], "peer-a")
                + peer(randedit.random_patches(rng, patches)[0], "peer-b")
                for _ in range(n)]

    tiebreaks = [
        [txn(n, 0, RemoteIns(root, root, t))
         for n, t in [("zed", "zz"), ("amy", "aa"), ("mia", "mm")]],
        [txn(n, 0, RemoteIns(root, root, t))
         for n, t in [("bob", "b"), ("eve", "ee"), ("cat", "c")]]]
    fragmented = [
        [txn("amy", 0, RemoteIns(root, root, "abcdef")),
         txn("bob", 0, RemoteDel(RemoteId("amy", 1), 3), [RemoteId("amy", 5)]),
         txn("cat", 0, RemoteDel(RemoteId("amy", 2), 3), [RemoteId("amy", 5)])],
        [txn("amy", 0, RemoteIns(root, root, "x" * 50)),
         txn("bob", 0, RemoteDel(RemoteId("amy", 5), 40),
             [RemoteId("amy", 49)])],
        [txn("amy", 0, RemoteIns(root, root, "abcdefgh")),
         txn("amy", 8, RemoteDel(RemoteId("amy", 2), 4), [RemoteId("amy", 7)]),
         txn("bob", 0, RemoteIns(RemoteId("amy", 3), RemoteId("amy", 4),
                                 "XY"), [RemoteId("amy", 7)])]]
    rng = random.Random(11)
    lp, _ = randedit.random_patches(rng, 25)
    local = B.compile_local_patches(B.merge_patches(lp), lmax=8)[0]
    remote_txns = peer(randedit.random_patches(rng, 18)[0], "peer-a")
    table = B.AgentTable(sorted({t.id.agent for t in remote_txns}))
    mixed = B.stack_ops([local, B.compile_remote_txns(
        remote_txns, table, lmax=8, dmax=16)[0]])
    storms = lanes([randedit.make_storm(3, 5, 2, seed=50 + k,
                                        del_prob=0.35)[0] for k in range(3)])
    overflow = [[txn("amy", 0, RemoteIns(root, root, "aaaaaaaa"))]
                + [txn("bob", k, RemoteDel(RemoteId("amy", s), 1))
                   for k, s in enumerate((1, 3, 5, 6))]]
    busy = []
    for k in range(24):
        busy.append(Patch(0, 0, "ab"))
        if k % 2:
            busy.append(Patch(1, 1, ""))
    busy_ops = B.stack_ops([
        B.compile_local_patches([Patch(0, 0, "ab")], lmax=2)[0],
        B.compile_local_patches(busy, lmax=2)[0]])
    bad = B.stack_ops([B.compile_local_patches(
        [Patch(0, 0, "abc"), Patch(0, 10, "")], lmax=4)[0]])

    def corrupt(stacked, **cells):
        out = B.OpTensors(**{k: v.copy() for k, v in vars(stacked).items()})
        for field, (step, lane, value) in cells.items():
            getattr(out, field)[step, lane] = value
        return out

    one = lanes([[txn("a", 0, RemoteIns(root, root, "ab"))]])
    missing_target = corrupt(one, kind=(0, 0, B.KIND_REMOTE_DEL),
                             del_target=(0, 0, 90), del_len=(0, 0, 1),
                             ins_len=(0, 0, 0))
    missing_origin = corrupt(
        lanes([[txn("a", 0, RemoteIns(root, root, "ab")),
                txn("a", 2, RemoteIns(RemoteId("a", 1), root, "cd"))]]),
        origin_left=(1, 0, 90))
    k8, k16, tiny = (dict(capacity=128, block_k=8),
                     dict(capacity=256, block_k=16),
                     dict(capacity=8, block_k=8))
    return [
        ("divergent tiebreaks", lanes(tiebreaks), 64, k8, None),
        ("two-peer merges", lanes(two_peer(3)), 512, k16, None),
        ("fragmented and double deletes", lanes(fragmented, lmax=16), 128,
         k8, None),
        ("local and remote in one step", mixed, 256, k16, None),
        ("storms with deletes, K = 8", storms, 512, k8, None),
        ("delete out of capacity -> err[0]", lanes(overflow, lmax=8), 8,
         tiny, 0),
        ("local out of capacity -> err[0]", busy_ops, 8, tiny, 0),
        ("bad local delete -> err[1]", bad, 16, tiny, 1),
        ("missing delete target -> err[1]", missing_target, 16, tiny, 1),
        ("missing origin -> err[2]", missing_origin, 16, tiny, 2),
    ], two_peer


def lanes_bound(staged, shape_rows, blocked, K, NBT):
    """(bytes, operations) one per-lane replay must at least move and do:
    each input read once, each output written once (all int32), and per
    document one K-row block plus the NBT slot prefixes for every step
    with work. Whole-plane passes are a design's cost, not the
    function's, and are not counted."""
    kind, dlen, ilen = staged[0], staged[2], staged[7]
    S, Bn = kind.shape
    CAP, OCAP = shape_rows
    words = 10 * S * Bn                  # op columns
    words += 2 * 2 * CAP * Bn            # planes in and out
    words += 2 * 2 * OCAP * Bn           # oll/orl in and out
    words += 3 * OCAP * Bn               # prefill delta and ranks
    words += 2 * S * Bn + 8 * Bn         # origins, err
    if blocked:
        words += 2 * (5 * NBT + 1) * Bn  # slot tables and nlog, in and out
        words += 2 * OCAP * Bn           # ordblk in and out
    else:
        words += 2 * Bn                  # rows in and out
    active = int(((kind == 0) & ((dlen > 0) | (ilen > 0))).sum()
                 + ((kind == 1) & (ilen > 0)).sum()
                 + ((kind == 2) & (dlen > 0)).sum())
    return 4 * words, active * (K + NBT), active


def doc_subset(stream, B, s5, stride: int):
    """The 5r stream cut to every ``stride``-th document, at the same
    per-document shapes and steps: what a plain chain runs on."""
    return stream.Stream5r(**{
        **vars(s5), "n_docs": len(range(0, s5.n_docs, stride)),
        "stacked": [B.OpTensors(**{k: v[:, ::stride]
                                   for k, v in vars(st).items()})
                    for st in s5.stacked]})


def chain(fn, runners, states_out=None):
    """Run the chunk replayers' staged inputs through ``fn`` (a kernel or
    plain version), the state carried on the device and grown between
    chunks. Returns the outputs of every chunk."""
    outs = []
    state = None
    for run in runners:
        ini = run.initial() if state is None else run.grow(state)
        out = fn(*run.staged, *ini, *getattr(run, "deltas", ()), **run.shape)
        outs.append(out)
        state = states_out(out)
    return outs


# -- the per-lane local replays (config 5) ----------------------------------------

A4_OUTPUTS = ("ol", "orr", "ordp", "lenp", "rows", "err")
A5_OUTPUTS = ("ol", "orr", "ordp", "lenp", "nlog", "blkord", "rws", "liv",
              "err")


def local_lanes_cases(B, randedit, Patch, np):
    """(label, stacked local streams, un-blocked capacity, blocked shape,
    expected error row or None) of the local per-lane kernels' small
    phase: the CPU tests' cases, built by the port alone."""
    import random

    def stack(streams, lmax=None, fuse_w=1):
        if lmax is None:
            lmax = max(len(p.ins_content) for ps in streams for p in ps)
        return B.stack_ops([B.compile_local_patches(
            ps, lmax=lmax, dmax=None, fuse_w=fuse_w)[0] for ps in streams])

    def divergent(seed, docs=16):
        rng = random.Random(seed)
        return stack([randedit.random_patches(rng, 30 + rng.randint(0, 30))[0]
                      for _ in range(docs)])

    pure = stack([randedit.continue_patches(random.Random(1000 + d), "", 120,
                                            0.45)[0] for d in range(8)])
    bursts = stack([randedit.prepend_bursts(np.random.default_rng(s), 12)[0]
                    for s in (3, 4)], lmax=16, fuse_w=5)
    if B.fused_width(bursts) <= 2:
        raise AssertionError("the burst streams must fuse wider than 2")
    busy = []
    for k in range(24):
        busy.append(Patch(0, 0, "ab"))
        if k % 2:
            busy.append(Patch(1, 1, ""))
    busy_ops = stack([[Patch(0, 0, "ab")], busy])
    bad = stack([[Patch(0, 0, "abc"), Patch(0, 10, "")],
                 [Patch(0, 0, "abcdefgh"), Patch(2, 3, "")]], lmax=8)
    k8, k16 = dict(capacity=256, block_k=8), dict(capacity=256, block_k=16)
    return [
        ("divergent documents, seed 7, K = 16", divergent(7), 256, k16, None),
        ("divergent documents, seed 42, K = 8", divergent(42), 256, k8, None),
        ("pure inserts and deletes (SHARED_CUM on), K = 16", pure, 256, k16,
         None),
        (f"fused bursts W = {B.fused_width(bursts)}, K = 16", bursts, 256,
         k16, None),
        ("out of capacity -> err[0]", busy_ops, 8,
         dict(capacity=16, block_k=8), 0),
        ("delete off the end -> err[1]", bad, 16,
         dict(capacity=16, block_k=8), 1),
    ]


def local_bound(staged, capacity, blocked, K, NBT):
    """(bytes, operations, doc-steps with work) one local per-lane replay
    must at least move and do: each input read once, each output written
    once (all int32), and per document one K-row block plus the NBT slot
    prefixes for every step with work. Whole-plane passes are a design's
    cost, not the function's, and are not counted."""
    dlen, ilen = staged[1], staged[2]
    S, Bn = dlen.shape
    words = 5 * S * Bn                   # op columns
    words += 2 * 2 * capacity * Bn       # planes in and out
    words += 2 * S * Bn + 8 * Bn         # origins, err
    if blocked:
        words += 2 * (3 * NBT + 1) * Bn  # slot tables and nlog, in and out
    else:
        words += 2 * Bn                  # rows in and out
    active = int(((dlen > 0) | (ilen > 0)).sum())
    return 4 * words, active * (K + NBT), active


def local_lanes_phase(torch, dev, B, RL, randedit, Patch, np):
    """The local per-lane kernels against their plain versions on small
    cases and on a warm-start chain whose capacity grows. Returns the
    worst differences (A4, A5)."""
    import random

    a4_worst = a5_worst = 0
    for label, ops, cap4, shape5, expect in local_lanes_cases(
            B, randedit, Patch, np):
        r4 = RL.make_replayer_lanes(ops, capacity=cap4, chunk=16, device=dev)
        r5 = RL.make_replayer_lanes_blocked(ops, chunk=16, device=dev,
                                            **shape5)
        k4 = RL.lanes_replay_cuda(*r4.staged, *r4.initial(), **r4.shape)
        k5 = RL.lanes_blocked_replay_cuda(*r5.staged, *r5.initial(),
                                          **r5.shape)
        torch.cuda.synchronize()
        e4 = worst_err(k4, RL.lanes_replay_plain(
            *r4.staged, *r4.initial(), **r4.shape), A4_OUTPUTS)
        e5 = worst_err(k5, RL.lanes_blocked_replay_plain(
            *r5.staged, *r5.initial(), **r5.shape), A5_OUTPUTS)
        a4_worst, a5_worst = max(a4_worst, e4), max(a5_worst, e5)
        f4 = k4[-1][:2].amax(dim=1).tolist()
        f5 = k5[-1][:2].amax(dim=1).tolist()
        flags_ok = (f4 == f5 == [0, 0] if expect is None
                    else f4[expect] == f5[expect] == 1)
        ok = e4 == 0 and e5 == 0 and flags_ok
        log(f"compare local lanes {label}: {ops.num_steps} steps x "
            f"{ops.kind.shape[1]} docs, SHARED_CUM {r4.shape['shared_cum']}, "
            f"blocks in use {int(k5[4].max())}, max_abs_err un-blocked {e4} "
            f"blocked {e5}, err flags {f4} {f5}, {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"local per-lane kernel disagrees on: "
                                 f"{label}")

    # A warm-start chain whose capacity grows 64 -> 128 -> 192 (K = 8).
    rng = random.Random(31)
    nexts = [0] * 4
    chunks = []
    for _ in range(3):
        opses = []
        for d in range(4):
            ops, nexts[d] = B.compile_local_patches(
                randedit.random_patches(rng, 15)[0], lmax=8, dmax=None,
                start_order=nexts[d])
            opses.append(ops)
        chunks.append(B.stack_ops(opses))
    for name, make, kern, plain, names, kw in (
            ("un-blocked", RL.make_replayer_lanes, RL.lanes_replay_cuda,
             RL.lanes_replay_plain, A4_OUTPUTS, {}),
            ("blocked", RL.make_replayer_lanes_blocked,
             RL.lanes_blocked_replay_cuda, RL.lanes_blocked_replay_plain,
             A5_OUTPUTS, dict(block_k=8))):
        runners = [make(c, capacity=cap, chunk=16, device=dev, **kw)
                   for c, cap in zip(chunks, (64, 128, 192))]
        kouts = chain(kern, runners, lambda o: o[2:-1])
        pouts = chain(plain, runners, lambda o: o[2:-1])
        torch.cuda.synchronize()
        e = max(worst_err(k, q, names) for k, q in zip(kouts, pouts))
        flags = kouts[-1][-1][:2].amax(dim=1).tolist()
        if name == "blocked":
            a5_worst = max(a5_worst, e)
        else:
            a4_worst = max(a4_worst, e)
        log(f"compare local lanes warm-start chain (capacity 64 -> 128 -> "
            f"192), {name}: max_abs_err {e}, err flags {flags}, "
            f"{'ok' if e == 0 and flags == [0, 0] else 'FAILED'}")
        if e != 0 or flags != [0, 0]:
            raise AssertionError(f"{name} local kernel disagrees on the "
                                 f"chain")
    return a4_worst, a5_worst


def config5_phase(torch, dev, card, stream, RL, _kernels, a4_worst,
                  a5_worst):
    """Config 5 at full size: ``stream.run_stream_5()`` counted, its chain
    against the plain chain on all documents, times and the bound; A4 on
    the same stream, counted through the entry point, against its plain
    version and against A5. Returns the two ``kernels`` entries."""
    t0 = time.perf_counter()
    chunk_patches, contents = stream.generate_5()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s5 = stream.compile_5(chunk_patches, contents)
    compile_s = time.perf_counter() - t0
    del chunk_patches
    setup_s = gen_s + compile_s
    log(f"host set-up 5: {setup_s:.2f} s = generation {gen_s:.2f} s "
        f"(continue_patches) + compile {compile_s:.2f} s "
        f"(compile_local_patches, stack_ops): {s5.n_docs} docs x "
        f"{s5.chunks} chunks x {s5.steps_per_chunk} patches -> "
        f"{sum(s5.real_steps)} real steps, {s5.steps} device steps, "
        f"{s5.n_patches} patches")
    # The earlier phases still hold device memory: count the path's peak
    # above it.
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    run5 = stream.run_stream_5(stream=s5, device=dev, clock=time.perf_counter)
    torch.cuda.synchronize()
    wall5 = time.perf_counter() - t0
    l5 = _kernels.launches.get("rle_lanes_blocked", 0)
    launches5 = dict(_kernels.launches)
    peak_mem = torch.cuda.max_memory_allocated() - base_mem
    res5 = run5.result
    log(f"5 path: run_stream_5() {s5.n_docs} docs x {s5.chunks} chunks, "
        f"K=64, capacity {res5.ordp.shape[0]} (NB {res5.blkord.shape[0]}): "
        f"launches {launches5}, chunks checked {run5.stats.checked}, "
        f"resyncs {run5.stats.resyncs}, sampled texts == simulation "
        f"{run5.ok}; host wall {wall5:.2f} s (replayer set-up, apply "
        f"{run5.stats.wall_s:.3f} s, checkpoints {run5.stats.ckpt_ms:.1f} "
        f"ms, text check); peak device memory {peak_mem / 2**20:.1f} MiB "
        f"above the {base_mem / 2**20:.1f} MiB held before it")
    if (l5 != s5.chunks or run5.stats.checked != s5.chunks or not run5.ok):
        raise AssertionError(
            f"5 path failed: blocked launches {l5}, checked "
            f"{run5.stats.checked}, texts {run5.ok}")

    # -- the blocked kernel at the config-5 shapes ---------------------------
    runners5 = stream.stream_replayers_5(s5, device=dev)
    t0 = time.perf_counter()
    p5 = chain(RL.lanes_blocked_replay_plain, runners5, lambda o: o[2:-1])
    torch.cuda.synchronize()
    plain5_ms = (time.perf_counter() - t0) * 1e3
    k5 = chain(RL.lanes_blocked_replay_cuda, runners5, lambda o: o[2:-1])
    torch.cuda.synchronize()
    e5 = max(worst_err(k, q, A5_OUTPUTS) for k, q in zip(k5, p5))
    a5_worst = max(a5_worst, e5)
    del p5
    log(f"compare 5 blocked chain: max_abs_err {e5} over {s5.chunks} chunks "
        f"against its plain version on all {s5.n_docs} docs; plain chain "
        f"{plain5_ms:.1f} ms")
    if e5 != 0:
        raise AssertionError("blocked local kernel disagrees at the 5 "
                             "shapes")
    ms5 = cuda_ms(torch, lambda: chain(RL.lanes_blocked_replay_cuda,
                                       runners5, lambda o: o[2:-1]), reps=3)
    lat = stream.step_latency_5(runners5, s5.real_steps, time.perf_counter)
    b5 = [local_bound(r.staged, r.capacity, True, 64, r.nbt)
          for r in runners5]
    bytes5, ops5 = sum(b[0] for b in b5), sum(b[1] for b in b5)
    steps5 = sum(b[2] for b in b5)
    bb5, bo5 = bytes5 / PEAK_BYTES_PER_S * 1e3, ops5 / PEAK_OPS_PER_S * 1e3
    rate5 = s5.n_patches / (ms5 / 1e3)
    log(f"5 blocked chain: median {ms5:.3f} ms over 3 reps after 1 warm-up "
        f"(CUDA events, {s5.chunks} launches with the state grown between "
        f"them); {rate5:.4g} patches/s ({s5.n_patches} patches); per-chunk "
        f"blocking time per real step p50 {lat['p50_us']:.2f} us, p99 "
        f"{lat['p99_us']:.2f} us (samples "
        f"{[round(x, 2) for x in lat['samples_us']]}); checkpoints "
        f"{run5.stats.ckpt_ms:.1f} ms ({run5.stats.resyncs}); {s5.steps} "
        f"device steps ({steps5} doc-steps with work); plain chain "
        f"{plain5_ms:.1f} ms; bound {max(bb5, bo5):.4f} ms ({bytes5} B, "
        f"{ops5} ops); on {card}")

    # -- the un-blocked kernel on the same stream, counted -------------------
    _kernels.reset_launches()
    run4 = stream.run_stream_5(stream=s5, device=dev, engine="unblocked")
    torch.cuda.synchronize()
    l4 = _kernels.launches.get("rle_lanes", 0)
    log(f"5 path, un-blocked engine: run_stream_5(engine='unblocked') "
        f"launches {dict(_kernels.launches)}, chunks checked "
        f"{run4.stats.checked}, sampled texts == simulation {run4.ok}")
    if l4 != s5.chunks or run4.stats.checked != s5.chunks or not run4.ok:
        raise AssertionError(f"5 path (un-blocked) failed: launches {l4}, "
                             f"texts {run4.ok}")
    del run4
    runners4 = stream.stream_replayers_5(s5, engine="unblocked", device=dev)
    k4 = chain(RL.lanes_replay_cuda, runners4, lambda o: o[2:-1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p4 = chain(RL.lanes_replay_plain, runners4, lambda o: o[2:-1])
    torch.cuda.synchronize()
    plain4_ms = (time.perf_counter() - t0) * 1e3
    e4 = max(worst_err(k, q, A4_OUTPUTS) for k, q in zip(k4, p4))
    a4_worst = max(a4_worst, e4)
    del p4
    # The two engines: same origins every chunk, same documents.
    same = all(torch.equal(a[i], b[i]) for a, b in zip(k4, k5)
               for i in (0, 1))
    last4 = RL.LanesResult(
        ordp=k4[-1][2].cpu(), lenp=k4[-1][3].cpu(), rows=k4[-1][4].cpu(),
        ol=None, orr=None, err=k4[-1][5].cpu(), batch=s5.n_docs)
    last5 = RL.BlockedLanesResult(
        *[t.cpu() for t in k5[-1][2:8]], ol=None, orr=None,
        err=k5[-1][8].cpu(), batch=s5.n_docs, block_k=64)
    same_docs = all(RL.expand_lane(last4, d).tolist()
                    == RL.expand_lane(last5, d).tolist()
                    for d in range(s5.n_docs))
    log(f"compare 5 un-blocked chain: max_abs_err {e4} against its plain "
        f"version on all {s5.n_docs} docs (plain chain {plain4_ms:.1f} ms); "
        f"against the blocked kernel: origins equal {same}, all "
        f"{s5.n_docs} documents equal {same_docs}")
    if e4 != 0 or not same or not same_docs:
        raise AssertionError("un-blocked local kernel disagrees at the 5 "
                             "shapes")
    del k4, k5
    ms4 = cuda_ms(torch, lambda: chain(RL.lanes_replay_cuda, runners4,
                                       lambda o: o[2:-1]), reps=3)
    b4 = [local_bound(r.staged, r.capacity, False, 64,
                      max(8, r.capacity // 64)) for r in runners4]
    bytes4, ops4 = sum(b[0] for b in b4), sum(b[1] for b in b4)
    bb4, bo4 = bytes4 / PEAK_BYTES_PER_S * 1e3, ops4 / PEAK_OPS_PER_S * 1e3
    log(f"5 un-blocked chain: median {ms4:.3f} ms over 3 reps after 1 "
        f"warm-up (CUDA events); {s5.n_patches / (ms4 / 1e3):.4g} "
        f"patches/s; plain chain {plain4_ms:.1f} ms; bound "
        f"{max(bb4, bo4):.4f} ms; on {card}")

    a4_line = {
        "name": "rle_lanes",
        "route": "cuda",
        "source": "text_crdt_rust_tpu_torch/ops/csrc/rle_lanes.cu",
        "replaces": "text_crdt_rust_tpu/ops/rle_lanes.py:111",
        "jax_counterpart":
            "text_crdt_rust_tpu/ops/rle_lanes.py::_rle_lanes_kernel",
        "launches": l4,
        "launches_path": "stream.run_stream_5(engine='unblocked') "
                         "(config 5)",
        "matches_plain": a4_worst == 0,
        "max_abs_err": a4_worst,
        "ms": ms4,
        "plain_ms": plain4_ms,
        "plain_docs": s5.n_docs,
        "bound_ms": max(bb4, bo4),
        "bound_by": "bytes" if bb4 >= bo4 else "operations",
        "library_ms": None,
        "bytes": bytes4,
        "ops_lower_bound": ops4,
    }
    a5_line = {
        "name": "rle_lanes_blocked",
        "route": "cuda",
        "source": "text_crdt_rust_tpu_torch/ops/csrc/rle_lanes_blocked.cu",
        "replaces": "text_crdt_rust_tpu/ops/rle_lanes.py:488",
        "jax_counterpart":
            "text_crdt_rust_tpu/ops/rle_lanes.py::_lanes_blocked_kernel",
        "launches": l5,
        "launches_path": "stream.run_stream_5 (config 5)",
        "matches_plain": a5_worst == 0,
        "max_abs_err": a5_worst,
        "ms": ms5,
        "plain_ms": plain5_ms,
        "plain_docs": s5.n_docs,
        "bound_ms": max(bb5, bo5),
        "bound_by": "bytes" if bb5 >= bo5 else "operations",
        "library_ms": None,
        "bytes": bytes5,
        "ops_lower_bound": ops5,
        "patches_per_s": rate5,
        "p50_step_us": lat["p50_us"],
        "p99_step_us": lat["p99_us"],
        "checkpoint_ms": run5.stats.ckpt_ms,
        "setup_s": setup_s,
        "generation_s": gen_s,
        "compile_s": compile_s,
        "peak_device_bytes": peak_mem,
        "device_steps": s5.steps,
    }
    return a4_line, a5_line


# -- the HBM-plane run replay: kevin and the north star on A2 -----------------

KEVIN_N = 5_000_000            # kevin's prepends (upstream benches/yjs.rs)


def hbm_compare_cases(B, randedit, TestPatch, np):
    """(label, streams, replayer kwargs, expected error row or None) of
    the A2 kernel-vs-plain phase."""
    rng = np.random.default_rng

    def merged(patches, fuse_w=1):
        return compile_patches(B, patches, fuse_w)

    def prepends(n, w):
        return B.compile_local_patches([TestPatch(0, 0, " ")] * n, lmax=w,
                                       fuse_w=w)[0]

    far = [TestPatch(0, 0, "abcdefgh")]
    for k in range(300):
        far += [TestPatch(0, 0, "xy"), TestPatch(8 + 2 * k, 0, "pq")]
    raw = B.compile_local_patches(
        randedit.random_patches(rng(13), 1500)[0], lmax=8)[0]
    return [
        ("random, K=8", [merged(randedit.random_patches(rng(1), 200)[0])],
         dict(capacity=512, block_k=8), None),
        ("3 divergent groups, K=8",
         [merged(randedit.random_patches(rng(s), 150)[0]) for s in (4, 5, 6)],
         dict(capacity=512, block_k=8), None),
        ("prepend bursts W=8, K=64",
         [merged(randedit.prepend_bursts(rng(3), 60)[0], fuse_w=8)],
         dict(capacity=2048, block_k=64), None),
        ("far-jump stream and a raw random stream, K=512",
         [B.compile_local_patches(far, lmax=8)[0], raw],
         dict(capacity=8192, block_k=512), None),
        ("kevin prepends W=64, K=2048 (splits)", [prepends(20000, 64)],
         dict(capacity=65536, block_k=2048, batch=128), None),
        ("kevin prepends W=64, K=2048, store_origins=False",
         [prepends(20000, 64)],
         dict(capacity=65536, block_k=2048, batch=128, store_origins=False),
         None),
        ("block table full -> err[0]",
         [B.compile_local_patches([TestPatch(0, 0, "ab")] * 40, lmax=2)[0]],
         dict(capacity=16, block_k=8), 0),
        ("delete past the end -> err[1]",
         [B.compile_local_patches([TestPatch(0, 0, "abc"),
                                   TestPatch(0, 10, "")], lmax=4)[0]],
         dict(capacity=32, block_k=8), 1),
    ]


def hbm_bound(TH, staged, shape, used_rows):
    """(bytes, operations) one HBM-plane replay must at least move and do:
    each input read once and each output written once (the planes' rows of
    the blocks the replay used, ``used_rows`` over all groups, since no
    other row is an output; the tables, meta, err and the origins when
    kept), and per lane, for every step with work, one K-row block and the
    two levels of the descent (the NSUP segment sums, one 64-slot
    segment)."""
    G, S, Bn, CAP, K = (shape["groups"], shape["steps"], shape["batch"],
                        shape["capacity"], shape["block_k"])
    _, NSUP, NBL, _ = TH.table_geometry(CAP, K)
    words = (5 * G * S + 2 * used_rows * Bn + 2 * G * NBL * Bn + 8 * G * Bn
             + 8 * Bn)
    if shape["store_origins"]:
        words += 2 * G * S * Bn
    active = int(((staged[1] > 0) | (staged[2] > 0)).sum())
    return 4 * words, active * Bn * (K + NSUP + TH.SUP), active


def hbm_phase(torch, dev, card, B, R, TH, kevin, northstar, randedit,
              TestPatch, np, _kernels):
    """A2: the small cases, kevin at 5M prepends through ``run_kevin()``
    (counted), the plain check at kevin's geometry, and the north star on
    A2 through ``run_northstar(engine="rle-hbm")`` (counted), against its
    plain version and A1. Returns the ``kernels`` entry."""
    worst = 0
    for label, streams, kw, expect in hbm_compare_cases(B, randedit,
                                                        TestPatch, np):
        kw.setdefault("batch", 32)
        rep = TH.make_replayer_rle_hbm(streams, device=dev, chunk=128, **kw)
        plain = TH.rle_hbm_replay_plain(*rep.staged, **rep.shape)
        kern = TH.rle_hbm_replay_cuda(*rep.staged, **rep.shape)
        torch.cuda.synchronize()
        err = max_abs_err(kern, plain)
        worst = max(worst, err)
        flags = kern[7][:2].amax(dim=1).tolist()
        flags_ok = flags == [0, 0] if expect is None else flags[expect] == 1
        ok = err == 0 and flags_ok
        log(f"compare hbm {label}: {[s.num_steps for s in streams]} steps, "
            f"blocks in use {kern[6][:, 0, 0].tolist()}, max_abs_err {err}, "
            f"err flags {flags}, {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"hbm kernel disagrees on: {label}")
        del plain, kern

    # -- kevin, counted -------------------------------------------------------
    t0 = time.perf_counter()
    ks = kevin.compile_kevin(KEVIN_N, 64)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    krun = kevin.run_kevin(batch=128, device=dev, stream=ks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    l_kevin = launches.get("rle_hbm_replay", 0)
    peak_mem = torch.cuda.max_memory_allocated() - base_mem
    res = krun.result
    flags = res.err[:2].amax(dim=1).tolist()
    nlog = int(res.meta[0, 0])
    used = TH.used_rows(res)
    log(f"kevin path: run_kevin() {ks.n} prepends -> {ks.steps} device "
        f"steps (W=64), B={res.batch}, K={res.block_k}, capacity "
        f"{res.ordp.shape[0]} run rows (NB {res.num_blocks}): launches "
        f"{launches}, err flags {flags}, meta[0] {nlog} blocks, lane 0 == "
        f"arange(n, 0, -1) {krun.order_ok}, all lanes equal over the used "
        f"blocks {krun.lanes_equal}; host set-up (compile_kevin) "
        f"{setup_s:.2f} s; host wall {wall:.2f} s (replay and checks); "
        f"peak device memory {peak_mem / 2**30:.2f} GiB above the "
        f"{base_mem / 2**30:.2f} GiB held before it")
    if (l_kevin < 1 or flags != [0, 0] or not krun.order_ok
            or not krun.lanes_equal):
        raise AssertionError(f"kevin path failed: launches {l_kevin}, flags "
                             f"{flags}, order {krun.order_ok}, lanes "
                             f"{krun.lanes_equal}")
    del krun, res  # free the 10.75 GB of planes
    rep = kevin.make_kevin_replayer(ks, batch=128, device=dev)
    ms = cuda_ms(torch, lambda: TH.rle_hbm_replay_cuda(*rep.staged,
                                                       **rep.shape), reps=3)
    nbytes, nops, active = hbm_bound(TH, rep.staged, rep.shape, used)
    bb, bo = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_OPS_PER_S * 1e3
    rate = ks.n * 128 / (ms / 1e3)
    log(f"kevin replay: median {ms:.3f} ms over 3 reps after 1 warm-up "
        f"(CUDA events, the wrapper's zeroing of the "
        f"{2 * rep.shape['capacity'] * 128 * 4 / 1e9:.2f} GB of planes "
        f"included); "
        f"{rate:.4g} prepends/s over 128 docs ({ks.n / (ms / 1e3):.4g} a "
        f"doc); {active} device steps, {ms / active * 1e3:.3f} us a step; "
        f"bound {max(bb, bo):.4f} ms ({nbytes} B, {nops} ops); on {card}")
    del rep

    # -- the plain check at kevin's geometry ----------------------------------
    prep = kevin.make_kevin_replayer(ks, batch=128, store_origins=True,
                                     device=dev)
    kern = TH.rle_hbm_replay_cuda(*prep.staged, **prep.shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = TH.rle_hbm_replay_plain(*prep.staged, **prep.shape)
    torch.cuda.synchronize()
    kplain_ms = (time.perf_counter() - t0) * 1e3
    e = max_abs_err(kern, plain)
    worst = max(worst, e)
    log(f"compare kevin geometry: all {ks.n} prepends ({ks.steps} "
        f"steps, K={prep.shape['block_k']}, W=64, B=128, capacity "
        f"{prep.shape['capacity']}, "
        f"origins kept): max_abs_err {e} on all eight outputs, blocks in "
        f"use {int(kern[6][0, 0, 0])}; plain version {kplain_ms:.1f} ms")
    if e != 0:
        raise AssertionError("hbm kernel disagrees at kevin's geometry")
    del kern, plain, prep

    # -- the north star on A2, counted ----------------------------------------
    _kernels.reset_launches()
    t0 = time.perf_counter()
    nrun = northstar.run_northstar(engine="rle-hbm", batch=1024, device=dev)
    torch.cuda.synchronize()
    nwall = time.perf_counter() - t0
    nlaunch = dict(_kernels.launches)
    l_ns = nlaunch.get("rle_hbm_replay", 0)
    nres = nrun.results[0]
    nequal = TH.lanes_equal(nres)
    log(f"north star on A2: run_northstar(engine='rle-hbm') "
        f"{nrun.stream.n_patches} patches -> {nrun.stream.steps} device "
        f"steps, B={nres.batch}, K={nres.block_k}, capacity "
        f"{nres.ordp.shape[0]}: text ok {nrun.ok}, all lanes equal "
        f"{nequal}, launches {nlaunch}, blocks in use "
        f"{int(nres.meta[0, 0])}, host wall {nwall:.2f} s with compile")
    if l_ns < 1 or not nrun.ok or not nequal:
        raise AssertionError(f"north star on A2 failed: launches {l_ns}, "
                             f"text {nrun.ok}, lanes {nequal}")
    nrep = northstar.make_northstar_replayer(nrun.stream, batch=1024,
                                             device=dev, engine="rle-hbm")
    t0 = time.perf_counter()
    plain = TH.rle_hbm_replay_plain(*nrep.staged, **nrep.shape)
    torch.cuda.synchronize()
    nplain_ms = (time.perf_counter() - t0) * 1e3
    kern = TH.rle_hbm_replay_cuda(*nrep.staged, **nrep.shape)
    torch.cuda.synchronize()
    en = max_abs_err(kern, plain)
    worst = max(worst, en)
    del plain, kern
    a1 = northstar.make_northstar_replayer(nrun.stream, batch=1024,
                                           device=dev)()[0]
    same = (np.array_equal(R.expand_runs(a1), R.expand_runs(nres))
            and torch.equal(a1.ol[:, 0], nres.ol[:, 0])
            and torch.equal(a1.orr[:, 0], nres.orr[:, 0]))
    log(f"compare north star on A2: max_abs_err {en} against its plain "
        f"version (plain {nplain_ms:.1f} ms); against A1's kernel on the "
        f"same stream (lane 0's expand_runs, ol, orr): equal {same}")
    if en != 0 or not same:
        raise AssertionError("hbm kernel disagrees on the north star")
    del a1
    nms = cuda_ms(torch, lambda: TH.rle_hbm_replay_cuda(*nrep.staged,
                                                        **nrep.shape), reps=3)
    nb2, no2, nact = hbm_bound(TH, nrep.staged, nrep.shape,
                               TH.used_rows(nres))
    nbb, nbo = nb2 / PEAK_BYTES_PER_S * 1e3, no2 / PEAK_OPS_PER_S * 1e3
    nrate = nrun.stream.n_patches * 1024 / (nms / 1e3)
    log(f"north star on A2 replay: median {nms:.3f} ms over 3 reps after 1 "
        f"warm-up (CUDA events); {nrate:.4g} patches/s ({nrun.stream.n_patches} x 1024 docs); {nact} device "
        f"steps; plain version {nplain_ms:.1f} ms; bound "
        f"{max(nbb, nbo):.4f} ms ({nb2} B, {no2} ops); on {card}")
    return {
        "name": "rle_hbm_replay",
        "route": "cuda",
        "source": "text_crdt_rust_tpu_torch/ops/csrc/rle_hbm_replay.cu",
        "replaces": "text_crdt_rust_tpu/ops/rle_hbm.py:54",
        "jax_counterpart":
            "text_crdt_rust_tpu/ops/rle_hbm.py::_rle_hbm_kernel",
        "launches": l_kevin,
        "launches_path": "kevin.run_kevin (5M prepends)",
        "launches_northstar": l_ns,
        "matches_plain": worst == 0,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": kplain_ms,
        "plain_prepends": ks.n,
        "bound_ms": max(bb, bo),
        "bound_by": "bytes" if bb >= bo else "operations",
        "library_ms": None,
        "bytes": nbytes,
        "ops_lower_bound": nops,
        "serial_steps": active,
        "prepends_per_s": rate,
        "blocks_used": nlog,
        "setup_s": setup_s,
        "peak_device_bytes": peak_mem,
        "northstar_ms": nms,
        "northstar_plain_ms": nplain_ms,
        "northstar_bound_ms": max(nbb, nbo),
    }


# -- the per-character block replays: A8, A9 and A10 -------------------------

CHAR_LANES = 128             # documents of the three per-character paths
PREFIX_A8 = 19_149           # the largest prefix bench.py sizes to 32,768 rows
TRACE_A9 = None              # the whole trace (259,778 patches)
STORM_ROUNDS = 200           # the config-4 insert storm: 16 peers x 200
PLAIN_LANES_A9 = 8           # A9's full-trace plain check: lanes
CHAR_OUTPUTS = ("ol", "orr", "signed", "rows", "err")


def plain_a9(lanes: int, patches):
    """Runs in a child process, on the CPU: A9's plain version over the
    trace (its first ``patches``, None for all) on ``lanes`` lanes (every
    lane replays the same stream, so the kernel's 128 are each held equal
    to lane 0 besides). Returns the staged columns, the outputs, the work
    counts and the seconds."""
    from text_crdt_rust_tpu_torch import northstar
    from text_crdt_rust_tpu_torch.ops import blocked_hbm as TBH

    stream = northstar.compile_northstar(patches=patches, engine="hbm")
    rep = northstar.make_northstar_replayer(stream, batch=lanes,
                                            engine="hbm", device="cpu")
    return timed_plain(TBH.blocked_hbm_replay_plain, rep.staged, rep.shape)


def plain_a8(prefix: int, lanes: int):
    """Runs in a child process, on the CPU: A8's plain version at the
    trace's first ``prefix`` patches on ``lanes`` lanes, the main path's
    geometry. Returns as ``plain_a9``."""
    from text_crdt_rust_tpu_torch import northstar
    from text_crdt_rust_tpu_torch.ops import blocked as TBL

    stream = northstar.compile_northstar(patches=prefix, engine="blocked")
    rep = northstar.make_northstar_replayer(stream, batch=lanes,
                                            engine="blocked", device="cpu")
    return timed_plain(TBL.blocked_replay_plain, rep.staged, rep.shape)


def plain_a10(rounds: int, lanes: int):
    """Runs in a child process, on the CPU: A10's plain version on the
    insert storm of ``rounds`` rounds, on ``lanes`` lanes at the storm's
    geometry and tables. Returns as ``plain_a9``."""
    from text_crdt_rust_tpu_torch import storm
    from text_crdt_rust_tpu_torch.ops import blocked_mixed as TBM

    sst = storm.make_storm_stream(rounds=rounds)
    rep = storm.make_storm_replayer(sst, batch=lanes,
                                    engine="blocked-mixed", device="cpu")
    return timed_plain(TBM.blocked_mixed_replay_plain, rep.staged,
                       rep.shape)


def timed_plain(replay, staged, shape):
    """One plain replay on one CPU thread: (staged columns, outputs, work
    counts, seconds), as numpy arrays."""
    import torch

    torch.set_num_threads(1)
    counts = {}
    t0 = time.perf_counter()
    outs = replay(*staged, **shape, counts=counts)
    secs = time.perf_counter() - t0
    return ([c.numpy() for c in staged], [o.numpy() for o in outs], counts,
            secs)


def same_inputs(torch, staged, cols_np) -> bool:
    """The child compiled the same inputs as this process."""
    return len(staged) == len(cols_np) and all(
        torch.equal(c.cpu(), torch.from_numpy(n))
        for c, n in zip(staged, cols_np))


def char_err(torch, kern, plain, lanes=None) -> int:
    """Largest absolute difference between a kernel's outputs (lanes
    ``[:lanes]`` when given) and its plain version's (tensors or numpy
    arrays); 0 = bit-identical."""
    worst = 0
    for name, k, p in zip(CHAR_OUTPUTS, kern, plain):
        if lanes is not None:
            k = k[..., :lanes]
        p = torch.as_tensor(p).to(k.device)
        if k.shape != p.shape:
            raise AssertionError(f"{name}: shape {tuple(k.shape)} != "
                                 f"{tuple(p.shape)}")
        if k.numel():
            worst = max(worst, int((k.long() - p.long()).abs().max()))
    return worst


def char_compare_cases(B, randedit, TestPatch, np):
    """(label, local streams, capacity, block_k, expected error rows) of
    the A8 and A9 kernel-vs-plain phases: random streams with rebalances
    (K = 16 and 32), prepends, a delete across blocks and the delete past
    the end."""
    import random

    def chars(patches, lmax=4):
        return B.compile_local_patches(patches, lmax=lmax, dmax=lmax)[0]

    def rnd(seed, steps):
        return chars(randedit.random_patches(random.Random(seed), steps)[0])

    return [
        ("random streams, K=16", [rnd(7, 120), rnd(11, 80)], 1024, 16,
         [0, 0, 0]),
        ("random, lmax 16, K=32", [chars(randedit.random_patches(
            random.Random(5), 400)[0], 16)], 4096, 32, [0, 0, 0]),
        ("prepends, K=8", [chars([TestPatch(0, 0, "ab")] * 40)], 256, 8,
         [0, 0, 0]),
        ("delete across blocks, K=8", [chars(
            [TestPatch(0, 0, "abcdefghijklmnopqrstuvwxyz"),
             TestPatch(2, 20, "")])], 64, 8, [0, 0, 0]),
        ("delete past the end -> err[1]", [chars(
            [TestPatch(0, 0, "abc"), TestPatch(0, 10, "")])], 64, 8,
         [0, 1, 0]),
    ]


def mixed_char_cases(B, storm, np):
    """(label, stream, capacity, block_k, expected error rows) of the A10
    kernel-vs-plain phase: storms (rebalances between remote lookups,
    stale hints and the full-state fallback), a delete storm, and an
    unknown delete target (err rows 1 and 2)."""
    import dataclasses

    def stormops(n_peers, rounds, run_len, del_prob):
        st = storm.make_storm_stream(n_peers, rounds, run_len, seed=7,
                                     del_prob=del_prob)
        return st.ops

    small = stormops(2, 3, 2, 0.0)
    fields = {f.name: np.asarray(getattr(small, f.name))
              for f in dataclasses.fields(small)}
    fields = {k: np.concatenate([v, np.zeros((1,) + v.shape[1:], v.dtype)])
              for k, v in fields.items()}
    fields["kind"][-1] = B.KIND_REMOTE_DEL
    fields["del_len"][-1] = 3
    fields["del_target"][-1] = 90
    fields["rows_per_step"][-1] = 1
    return [
        ("storm 4x10, K=16", stormops(4, 10, 2, 0.0), 256, 16, [0, 0, 0]),
        ("storm 16x20, K=32", stormops(16, 20, 4, 0.0), 4096, 32,
         [0, 0, 0]),
        ("delete storm 6x20, K=16", stormops(6, 20, 3, 0.3), 1024, 16,
         [0, 0, 0]),
        ("unknown delete target -> err[1], err[2]", B.OpTensors(**fields),
         256, 16, [0, 1, 1]),
    ]


def char_bound(staged, shape, ops_per_step: int, ncols: int = 4,
               table_words: int = 0, rebalances: int = 0):
    """(bytes, operations, active steps) one per-character replay must at
    least move and do: each input read once (the op columns, the order
    tables) and each output written once (the origins, the rows, the block
    counts, err), and per lane, for every step with work, one K-row block
    and the block descent (``ops_per_step``). ``rebalances`` adds one read
    and one write of the rows per rebalance (the second bound asked of
    A9)."""
    G = shape.get("groups", 1)
    S, Bn, CAP, K = (shape["steps"], shape["batch"], shape["capacity"],
                     shape["block_k"])
    nbp = max(8, CAP // K)
    words = (ncols * G * S + table_words + 2 * G * S * Bn + G * CAP * Bn
             + G * nbp * Bn + 8 * Bn + rebalances * 2 * CAP * Bn)
    if ncols == 4:   # pos, del_len, ins_len, ins_order_start
        busy = (staged[1] > 0) | (staged[2] > 0)
    else:            # kind, pos, del_len, ..., ins_len, ins_order_start
        busy = (staged[2] > 0) | (staged[7] > 0) | (staged[0] == 2)
    active = int(busy.sum())
    return 4 * words, active * Bn * ops_per_step, active


def bound_ms(nbytes, nops):
    bb, bo = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_OPS_PER_S * 1e3
    return max(bb, bo), "bytes" if bb >= bo else "operations"


def blocked_a8_phase(torch, dev, card, B, northstar, TBL, TBH, randedit,
                     TestPatch, np, _kernels, plain_async):
    """A8: the small cases, the north star's 19,149-patch prefix through
    ``run_northstar(engine="blocked")`` (counted), and at that shape the
    kernel against its plain version, against A9's kernel, and timed.
    Returns the ``kernels`` entry."""
    worst = 0
    for label, streams, cap, k, flags in char_compare_cases(
            B, randedit, TestPatch, np):
        rep = TBL.make_replayer(streams[0], cap, batch=32, block_k=k,
                                chunk=128, device=dev)
        plain = TBL.blocked_replay_plain(*rep.staged, **rep.shape)
        kern = TBL.blocked_replay_cuda(*rep.staged, **rep.shape)
        torch.cuda.synchronize()
        e = char_err(torch, kern, plain)
        worst = max(worst, e)
        got = kern[4][:3].amax(dim=1).tolist()
        ok = e == 0 and got == flags
        log(f"compare blocked {label}: {streams[0].num_steps} steps, "
            f"max_abs_err {e}, err flags {got}, {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"blocked kernel disagrees on: {label}")

    _kernels.reset_launches()
    t0 = time.perf_counter()
    run = northstar.run_northstar(engine="blocked", patches=PREFIX_A8,
                                  batch=CHAR_LANES, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    n_launch = launches.get("blocked_replay", 0)
    res = run.results[0]
    equal = TBL.lanes_equal(res)
    log(f"north star on A8: run_northstar(engine='blocked', patches="
        f"{PREFIX_A8}) -> {run.stream.steps} device steps, "
        f"{run.stream.ins_total} inserted chars, B={res.batch}, "
        f"K={res.block_k}, capacity {res.signed.shape[0]} rows: text ok "
        f"{run.ok}, all lanes equal {equal}, launches {launches}, host wall "
        f"{wall:.2f} s with compile")
    if n_launch < 1 or not run.ok or not equal:
        raise AssertionError(f"north star on A8 failed: launches {n_launch},"
                             f" text {run.ok}, lanes {equal}")
    rep = northstar.make_northstar_replayer(run.stream, batch=CHAR_LANES,
                                            engine="blocked", device=dev)
    kern = TBL.blocked_replay_cuda(*rep.staged, **rep.shape)
    NB = rep.shape["capacity"] // rep.shape["block_k"]
    hrep = TBH.make_replayer_hbm(run.stream.ops, rep.shape["capacity"],
                                 batch=CHAR_LANES,
                                 block_k=rep.shape["block_k"], device=dev)
    hk = TBH.blocked_hbm_replay_cuda(*hrep.staged, **hrep.shape)
    torch.cuda.synchronize()
    same = (torch.equal(kern[0], hk[0][0]) and torch.equal(kern[1], hk[1][0])
            and torch.equal(kern[2], hk[2])
            and torch.equal(kern[3][:NB], hk[3][0][:NB])
            and torch.equal(kern[4], hk[4]))
    del hk
    ms = cuda_ms(torch, lambda: TBL.blocked_replay_cuda(*rep.staged,
                                                        **rep.shape), reps=3)
    nbytes, nops, active = char_bound(rep.staged, rep.shape,
                                      rep.shape["block_k"] + NB)
    bms, by = bound_ms(nbytes, nops)
    rate = PREFIX_A8 * CHAR_LANES / (ms / 1e3)
    cols, plain, counts, plain_s = plain_async.get()
    if not same_inputs(torch, rep.staged, cols):
        raise AssertionError("A8's plain check compiled other inputs")
    e = char_err(torch, kern, plain)
    worst = max(worst, e)
    log(f"compare north star on A8: max_abs_err {e} against its plain "
        f"version on all {CHAR_LANES} lanes (plain {plain_s:.1f} s on one "
        f"CPU core, {counts}); against A9's kernel on the same stream and "
        f"geometry (signed, rows[:NB], ol, orr, err): equal {same}")
    if e != 0 or not same:
        raise AssertionError("blocked kernel disagrees on the north-star "
                             "prefix")
    del kern
    log(f"north star on A8 replay: median {ms:.3f} ms over 3 reps after 1 "
        f"warm-up (CUDA events); {rate:.4g} patches/s ({PREFIX_A8} x "
        f"{CHAR_LANES} docs); {active} device steps, "
        f"{ms / active * 1e3:.3f} us a step; plain version {plain_s:.1f} s; "
        f"bound {bms:.4f} ms by {by} ({nbytes} B, {nops} ops); on {card}")
    return {
        "name": "blocked_replay",
        "route": "cuda",
        "source": "text_crdt_rust_tpu_torch/ops/csrc/blocked_replay.cu",
        "replaces": "text_crdt_rust_tpu/ops/blocked.py:227",
        "jax_counterpart": "text_crdt_rust_tpu/ops/blocked.py::"
                           "_replay_kernel",
        "launches": n_launch,
        "launches_path": f"northstar.run_northstar(engine='blocked', "
                         f"patches={PREFIX_A8})",
        "matches_plain": worst == 0,
        "max_abs_err": worst,
        "matches_a9": same,
        "ms": ms,
        "plain_ms": plain_s * 1e3,
        "plain_where": "CPU, one core, all lanes",
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": None,
        "bytes": nbytes,
        "ops_lower_bound": nops,
        "serial_steps": active,
        "patches_per_s": rate,
        "rebalances": counts.get("rebalances"),
        "delete_windows": counts.get("delete_windows"),
    }


def blocked_a9_phase(torch, dev, card, B, northstar, TBL, TBH, randedit,
                     TestPatch, np, _kernels, plain_async):
    """A9, the main path: the small cases (doc groups included), the full
    trace through ``run_northstar(engine="hbm")`` (counted), and at that
    shape the kernel against its plain version (on PLAIN_LANES_A9 lanes,
    every lane of the kernel held equal to lane 0), timed, with peak
    device memory and the rebalance count. Returns the ``kernels``
    entry."""
    worst = 0
    cases = char_compare_cases(B, randedit, TestPatch, np)
    for label, streams, cap, k, flags in cases:
        rep = TBH.make_replayer_hbm(streams, cap, batch=32, block_k=k,
                                    chunk=128, device=dev)
        plain = TBH.blocked_hbm_replay_plain(*rep.staged, **rep.shape)
        kern = TBH.blocked_hbm_replay_cuda(*rep.staged, **rep.shape)
        torch.cuda.synchronize()
        e = char_err(torch, kern, plain)
        worst = max(worst, e)
        got = kern[4][:3].amax(dim=1).tolist()
        ok = e == 0 and got == flags
        log(f"compare blocked-hbm {label}: "
            f"{[s.num_steps for s in streams]} steps, max_abs_err {e}, err "
            f"flags {got}, {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"blocked-hbm kernel disagrees on: {label}")

    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    run = northstar.run_northstar(engine="hbm", patches=TRACE_A9,
                                  batch=CHAR_LANES, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    n_launch = launches.get("blocked_hbm_replay", 0)
    peak_mem = torch.cuda.max_memory_allocated() - base_mem
    res = run.results[0]
    equal = TBL.lanes_equal(res)
    log(f"main path on A9: run_northstar(engine='hbm') "
        f"{run.stream.n_patches} patches -> {run.stream.steps} device steps, "
        f"{run.stream.ins_total} inserted chars, B={res.batch}, "
        f"K={res.block_k}, capacity {res.signed.shape[0]} rows (NB "
        f"{res.num_blocks}): text ok {run.ok}, all lanes equal {equal}, "
        f"launches {launches}, host wall {wall:.2f} s with compile and "
        f"checks, peak device memory {peak_mem / 2**30:.2f} GiB above the "
        f"{base_mem / 2**30:.2f} GiB held before it")
    if n_launch < 1 or not run.ok or not equal:
        raise AssertionError(f"north star on A9 failed: launches {n_launch},"
                             f" text {run.ok}, lanes {equal}")
    del run, res
    stream = northstar.compile_northstar(patches=TRACE_A9, engine="hbm")
    rep = northstar.make_northstar_replayer(stream, batch=CHAR_LANES,
                                            engine="hbm", device=dev)
    kern = TBH.blocked_hbm_replay_cuda(*rep.staged, **rep.shape)
    torch.cuda.synchronize()
    equal = TBL.lanes_equal(TBL.BlockedResult(
        signed=kern[2], rows=kern[3][0], ol=kern[0][0], orr=kern[1][0],
        err=kern[4], block_k=rep.shape["block_k"],
        num_blocks=rep.shape["capacity"] // rep.shape["block_k"],
        batch=CHAR_LANES))
    ms = cuda_ms(torch, lambda: TBH.blocked_hbm_replay_cuda(*rep.staged,
                                                            **rep.shape),
                 reps=3)
    cols, plain, counts, plain_s = plain_async.get()
    if not same_inputs(torch, rep.staged, cols):
        raise AssertionError("A9's plain check compiled other inputs")
    e = char_err(torch, kern, plain, lanes=PLAIN_LANES_A9)
    worst = max(worst, e)
    log(f"compare main path on A9: all {stream.steps} steps, max_abs_err "
        f"{e} against its plain version on lanes 0-{PLAIN_LANES_A9 - 1} "
        f"(plain {plain_s:.1f} s on one CPU core; {counts}); all "
        f"{CHAR_LANES} lanes of the kernel equal lane 0: {equal}")
    if e != 0 or not equal:
        raise AssertionError("blocked-hbm kernel disagrees on the trace")
    del kern
    _, NSUP, _, _ = TBH.hbm_geometry(rep.shape["capacity"],
                                     rep.shape["block_k"])
    per_step = rep.shape["block_k"] + NSUP + TBH.SUP
    nbytes, nops, active = char_bound(rep.staged, rep.shape, per_step)
    bms, by = bound_ms(nbytes, nops)
    rb = counts.get("rebalances", 0)
    nbytes_rb, _, _ = char_bound(rep.staged, rep.shape, per_step,
                                 rebalances=rb)
    bms_rb, by_rb = bound_ms(nbytes_rb, nops)
    rate = stream.n_patches * CHAR_LANES / (ms / 1e3)
    log(f"main path on A9 replay: median {ms:.3f} ms over 3 reps after 1 "
        f"warm-up (CUDA events, the wrapper's allocations included); "
        f"{rate:.4g} patches/s ({stream.n_patches} x {CHAR_LANES} docs); "
        f"{active} device steps, {ms / active * 1e3:.3f} us a step; "
        f"{rb} rebalances; bound {bms:.4f} ms by {by} ({nbytes} B, {nops} "
        f"ops), {bms_rb:.4f} ms by {by_rb} with one read and one write of "
        f"the rows per rebalance ({nbytes_rb} B); on {card}")
    return {
        "name": "blocked_hbm_replay",
        "route": "cuda",
        "source": "text_crdt_rust_tpu_torch/ops/csrc/blocked_hbm_replay.cu",
        "replaces": "text_crdt_rust_tpu/ops/blocked_hbm.py:50",
        "jax_counterpart": "text_crdt_rust_tpu/ops/blocked_hbm.py::"
                           "_hbm_replay_kernel",
        "launches": n_launch,
        "launches_path": "northstar.run_northstar(engine='hbm'), the "
                         "whole trace",
        "matches_plain": worst == 0,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_s * 1e3,
        "plain_where": f"CPU, one core, {PLAIN_LANES_A9} lanes",
        "bound_ms": bms,
        "bound_by": by,
        "bound_with_rebalances_ms": bms_rb,
        "library_ms": None,
        "bytes": nbytes,
        "bytes_with_rebalances": nbytes_rb,
        "ops_lower_bound": nops,
        "serial_steps": active,
        "patches_per_s": rate,
        "rebalances": rb,
        "delete_windows": counts.get("delete_windows"),
        "peak_device_bytes": peak_mem,
    }


def blocked_a10_phase(torch, dev, card, B, storm, TBL, TBM, np, _kernels,
                      plain_async):
    """A10: the small cases (error rows included), the config-4 insert
    storm through ``run_storm(engine="blocked-mixed")`` (counted), and at
    that shape the main path's outputs against the plain version's over
    the whole storm, and timed. Returns the ``kernels`` entry."""
    worst = 0
    for label, ops, cap, k, flags in mixed_char_cases(B, storm, np):
        rep = TBM.make_replayer_mixed(ops, cap, batch=32, block_k=k,
                                      chunk=128, device=dev)
        plain = TBM.blocked_mixed_replay_plain(*rep.staged, **rep.shape)
        kern = TBM.blocked_mixed_replay_cuda(*rep.staged, **rep.shape)
        torch.cuda.synchronize()
        e = char_err(torch, kern, plain)
        worst = max(worst, e)
        got = kern[4][:3].amax(dim=1).tolist()
        ok = e == 0 and got == flags
        log(f"compare blocked-mixed {label}: {ops.num_steps} steps, "
            f"max_abs_err {e}, err flags {got}, {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"blocked-mixed kernel disagrees on: "
                                 f"{label}")

    _kernels.reset_launches()
    t0 = time.perf_counter()
    run = storm.run_storm(rounds=STORM_ROUNDS, batch=CHAR_LANES,
                          engine="blocked-mixed", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    n_launch = launches.get("blocked_mixed_replay", 0)
    res = run.result
    equal = TBL.lanes_equal(res)
    log(f"storm on A10: run_storm(engine='blocked-mixed') "
        f"{len(run.stream.txns)} txns -> {run.stream.steps} device steps, "
        f"{run.stream.char_ops} char-ops, B={res.batch}, K={res.block_k}, "
        f"capacity {res.signed.shape[0]} rows: text ok {run.ok}, all lanes "
        f"equal {equal}, launches {launches}, host wall {wall:.2f} s with "
        f"generation and compile")
    if n_launch < 1 or not run.ok or not equal:
        raise AssertionError(f"storm on A10 failed: launches {n_launch}, "
                             f"text {run.ok}, lanes {equal}")
    rep = storm.make_storm_replayer(run.stream, batch=CHAR_LANES,
                                    engine="blocked-mixed", device=dev)
    ms = cuda_ms(torch, lambda: TBM.blocked_mixed_replay_cuda(
        *rep.staged, **rep.shape), reps=3)
    cols, plain, counts, plain_s = plain_async.get()
    if not same_inputs(torch, rep.staged, cols):
        raise AssertionError("A10's plain check compiled other inputs")
    s = run.stream.steps
    e = char_err(torch, (res.ol, res.orr, res.signed, res.rows, res.err),
                 (plain[0][:s], plain[1][:s], *plain[2:]))
    worst = max(worst, e)
    log(f"compare storm on A10: the main path's outputs, all {s} steps and "
        f"all {CHAR_LANES} lanes: max_abs_err {e} against the plain version "
        f"at the storm's geometry and tables (plain {plain_s:.1f} s on one "
        f"CPU core; {counts})")
    if e != 0:
        raise AssertionError("blocked-mixed kernel disagrees on the storm")
    NB = rep.shape["capacity"] // rep.shape["block_k"]
    nbytes, nops, active = char_bound(
        rep.staged, rep.shape, rep.shape["block_k"] + NB, ncols=9,
        table_words=3 * rep.shape["order_rows"] * 128)
    bms, by = bound_ms(nbytes, nops)
    rate = run.stream.char_ops * CHAR_LANES / (ms / 1e3)
    log(f"storm on A10 replay: median {ms:.3f} ms over 3 reps after 1 "
        f"warm-up (CUDA events); {rate:.4g} char-ops/s "
        f"({run.stream.char_ops} x {CHAR_LANES} docs); {active} device "
        f"steps, {ms / active * 1e3:.3f} us a step; bound {bms:.4f} ms by "
        f"{by} ({nbytes} B, {nops} ops); on {card}")
    return {
        "name": "blocked_mixed_replay",
        "route": "cuda",
        "source":
            "text_crdt_rust_tpu_torch/ops/csrc/blocked_mixed_replay.cu",
        "replaces": "text_crdt_rust_tpu/ops/blocked_mixed.py:68",
        "jax_counterpart": "text_crdt_rust_tpu/ops/blocked_mixed.py::"
                           "_mixed_kernel",
        "launches": n_launch,
        "launches_path": "storm.run_storm(engine='blocked-mixed'), the "
                         "16 x 200 insert storm",
        "matches_plain": worst == 0,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_s * 1e3,
        "plain_where": "CPU, one core, all steps and lanes",
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": None,
        "bytes": nbytes,
        "ops_lower_bound": nops,
        "serial_steps": active,
        "char_ops_per_s": rate,
        "plain_counts": counts,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        import numpy as np

        from text_crdt_rust_tpu_torch import (
            common,
            kevin,
            northstar,
            storm,
            stream,
        )
        from text_crdt_rust_tpu_torch.examples import sync_stream
        from text_crdt_rust_tpu_torch.models.oracle import ListCRDT
        from text_crdt_rust_tpu_torch.models.sync import export_txns_since
        from text_crdt_rust_tpu_torch.ops import _kernels
        from text_crdt_rust_tpu_torch.ops import batch as B
        from text_crdt_rust_tpu_torch.ops import blocked as TBL
        from text_crdt_rust_tpu_torch.ops import blocked_hbm as TBH
        from text_crdt_rust_tpu_torch.ops import blocked_mixed as TBM
        from text_crdt_rust_tpu_torch.ops import rle as R
        from text_crdt_rust_tpu_torch.ops import rle_hbm as TH
        from text_crdt_rust_tpu_torch.ops import rle_lanes as RL
        from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as RLM
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
        sst = storm.make_storm_stream(del_prob=dp)
        setup_s = time.perf_counter() - t0
        if sst.steps != r.stream.steps or sst.want != r.stream.want:
            raise AssertionError(f"{name}: regenerated storm differs")
        log(f"host set-up {name}: {setup_s:.2f} s (generation with the "
            f"oracle + compile, {len(sst.txns)} txns -> "
            f"{sst.steps} steps)")
        rep = storm.make_storm_replayer(sst, device=dev)
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
        rate = sst.char_ops * shape["batch"] / (mms / 1e3)
        log(f"replay {name}: median {mms:.3f} ms over 3 reps after 1 "
            f"warm-up (CUDA events); {rate:.4g} char-ops/s "
            f"({sst.char_ops} x {shape['batch']} docs); "
            f"{sst.steps} device steps "
            f"({mms * 1e3 / sst.steps:.2f} us each); plain version "
            f"{mplain_ms:.1f} ms; bound {max(b_ms, o_ms):.4f} ms "
            f"({mbytes} B, {mops} ops); on {card}")
        per_variant.append(dict(
            variant=name, steps=sst.steps, char_ops=sst.char_ops,
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
    # -- the per-lane mixed replays against their plain versions, small --
    a6_worst = a7_worst = 0
    cases, two_peer = lanes_cases(B, randedit, common, TestPatch, ListCRDT,
                                  export_txns_since)
    for label, ops, cap6, shape7, expect in cases:
        r6 = RLM.make_replayer_lanes_mixed(ops, capacity=cap6, chunk=16,
                                           order_capacity=256, device=dev)
        r7 = RLM.make_replayer_lanes_mixed_blocked(
            ops, order_capacity=256, chunk=16, device=dev, **shape7)
        k6 = RLM.lanes_mixed_replay_cuda(*r6.staged, *r6.initial(),
                                         *r6.deltas, **r6.shape)
        k7 = RLM.lanes_mixed_blocked_replay_cuda(*r7.staged, *r7.initial(),
                                                 *r7.deltas, **r7.shape)
        torch.cuda.synchronize()
        e6 = worst_err(k6, RLM.lanes_mixed_replay_plain(
            *r6.staged, *r6.initial(), *r6.deltas, **r6.shape), A6_OUTPUTS)
        e7 = worst_err(k7, RLM.lanes_mixed_blocked_replay_plain(
            *r7.staged, *r7.initial(), *r7.deltas, **r7.shape), A7_OUTPUTS)
        a6_worst, a7_worst = max(a6_worst, e6), max(a7_worst, e7)
        f6 = k6[-1][:3].amax(dim=1).tolist()
        f7 = k7[-1][:3].amax(dim=1).tolist()
        flags_ok = (f6 == f7 == [0, 0, 0] if expect is None
                    else f6[expect] == f7[expect] == 1)
        ok = e6 == 0 and e7 == 0 and flags_ok
        log(f"compare lanes {label}: {ops.num_steps} steps x "
            f"{ops.kind.shape[1]} docs, max_abs_err un-blocked {e6} "
            f"blocked {e7}, err flags {f6} {f7}, "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"per-lane kernel disagrees on: {label}")

    # A warm-start chain whose capacity grows between chunks (K = 8).
    lane_txns = two_peer(42, 3, 30)
    tables = [B.AgentTable() for _ in lane_txns]
    assigners = [None] * len(lane_txns)
    chunks = []
    for which in (0, 1):
        opses = []
        for d, txns in enumerate(lane_txns):
            half = (txns[:len(txns) // 2], txns[len(txns) // 2:])[which]
            for t in half:
                tables[d].add(t.id.agent)
            ops, assigners[d] = B.compile_remote_txns(
                half, tables[d], assigner=assigners[d], lmax=4)
            opses.append(ops)
        chunks.append(B.stack_ops(opses))
    rkls = [RLM.lane_tables(c, 256)[2] for c in chunks]
    rkl = np.where(rkls[1] != 0, rkls[1], rkls[0])
    for name, make, kern, plain, names, kw in (
            ("un-blocked", RLM.make_replayer_lanes_mixed,
             RLM.lanes_mixed_replay_cuda, RLM.lanes_mixed_replay_plain,
             A6_OUTPUTS, {}),
            ("blocked", RLM.make_replayer_lanes_mixed_blocked,
             RLM.lanes_mixed_blocked_replay_cuda,
             RLM.lanes_mixed_blocked_replay_plain, A7_OUTPUTS,
             dict(block_k=8))):
        runners = [make(c, capacity=cap, order_capacity=256, chunk=16,
                        rkl=r, device=dev, **kw)
                   for c, cap, r in zip(chunks, (128, 256), (None, rkl))]
        kouts = chain(kern, runners, lambda o: o[2:-1])
        pouts = chain(plain, runners, lambda o: o[2:-1])
        torch.cuda.synchronize()
        e = max(worst_err(k, q, names) for k, q in zip(kouts, pouts))
        flags = kouts[-1][-1][:3].amax(dim=1).tolist()
        if name == "blocked":
            a7_worst = max(a7_worst, e)
        else:
            a6_worst = max(a6_worst, e)
        log(f"compare lanes warm-start chain (capacity 128 -> 256), {name}: "
            f"max_abs_err {e}, err flags {flags}, "
            f"{'ok' if e == 0 and flags == [0, 0, 0] else 'FAILED'}")
        if e != 0 or flags != [0, 0, 0]:
            raise AssertionError(f"{name} kernel disagrees on the chain")

    # -- the 5r path, counted ------------------------------------------------
    t0 = time.perf_counter()
    chunk_txns, contents = stream.generate_5r()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s5 = stream.compile_5r(chunk_txns, contents)
    compile_s = time.perf_counter() - t0
    setup_s = gen_s + compile_s
    log(f"host set-up 5r: {setup_s:.2f} s = generation {gen_s:.2f} s "
        f"(continue_patches + PeerSynth) + compile {compile_s:.2f} s "
        f"(compile_remote_txns, stack_ops, pad_ops): {s5.n_docs} docs x "
        f"{s5.chunks} chunks x {s5.steps_per_chunk} patches -> "
        f"{sum(s5.real_steps)} real steps, {s5.steps} device steps, "
        f"{s5.char_ops} char-ops")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    run5 = stream.run_stream(stream=s5, device=dev, clock=time.perf_counter)
    torch.cuda.synchronize()
    wall5 = time.perf_counter() - t0
    l7 = _kernels.launches.get("rle_lanes_mixed_blocked", 0)
    launches5 = dict(_kernels.launches)
    peak_mem = torch.cuda.max_memory_allocated()
    res5 = run5.result
    log(f"5r path: run_stream() {s5.n_docs} docs x {s5.chunks} chunks, "
        f"K=64, capacity {res5.ordp.shape[0]}, order rows "
        f"{res5.oll.shape[0]}: launches {launches5}, chunks checked "
        f"{run5.stats.checked}, resyncs {run5.stats.resyncs}, sampled docs "
        f"== oracle {run5.ok}; host wall {wall5:.2f} s (replayer set-up, "
        f"apply {run5.stats.wall_s:.3f} s, checkpoints "
        f"{run5.stats.ckpt_ms:.1f} ms, oracle check); peak device memory "
        f"{peak_mem / 2**20:.1f} MiB")
    if l7 < s5.chunks or run5.stats.checked != s5.chunks or not run5.ok:
        raise AssertionError(
            f"5r path failed: blocked launches {l7}, checked "
            f"{run5.stats.checked}, oracle {run5.ok}")

    # -- the 5r shapes: agreement, times, bound ------------------------------
    sub7 = doc_subset(stream, B, s5, PLAIN_STRIDE_A7)
    runners7 = stream.make_stream_replayers(s5, device=dev)
    t0 = time.perf_counter()
    p7 = chain(RLM.lanes_mixed_blocked_replay_plain,
               stream.make_stream_replayers(sub7, device=dev),
               lambda o: o[2:-1])
    torch.cuda.synchronize()
    plain7_ms = (time.perf_counter() - t0) * 1e3
    k7 = chain(RLM.lanes_mixed_blocked_replay_cuda, runners7,
               lambda o: o[2:-1])
    torch.cuda.synchronize()
    e7 = max(worst_err([t[:, ::PLAIN_STRIDE_A7] for t in k], q, A7_OUTPUTS)
             for k, q in zip(k7, p7))
    a7_worst = max(a7_worst, e7)
    del p7
    log(f"compare 5r blocked chain: max_abs_err {e7} over {s5.chunks} "
        f"chunks against its plain version on {sub7.n_docs} docs (one in "
        f"{PLAIN_STRIDE_A7}); plain chain {plain7_ms:.1f} ms")
    if e7 != 0:
        raise AssertionError("blocked kernel disagrees at the 5r shapes")
    ms7 = cuda_ms(torch, lambda: chain(RLM.lanes_mixed_blocked_replay_cuda,
                                       runners7, lambda o: o[2:-1]), reps=3)
    samples = []
    state = None
    for run, real in zip(runners7, s5.real_steps):
        ini = run.initial() if state is None else run.grow(state)
        t0 = time.perf_counter()
        out = RLM.lanes_mixed_blocked_replay_cuda(*run.staged, *ini,
                                                  *run.deltas, **run.shape)
        out[-1].cpu()
        samples.append((time.perf_counter() - t0) / real * 1e6)
        state = out[2:-1]
    ss = sorted(samples)
    p50 = ss[len(ss) // 2]
    p99 = ss[min(len(ss) - 1, int(round((len(ss) - 1) * 0.99)))]
    b7 = [lanes_bound(r.staged, (r.capacity, r.order_capacity), True, 64,
                      r.nbt) for r in runners7]
    bytes7, ops7 = sum(b[0] for b in b7), sum(b[1] for b in b7)
    steps7 = sum(b[2] for b in b7)
    bb7, bo7 = bytes7 / PEAK_BYTES_PER_S * 1e3, ops7 / PEAK_OPS_PER_S * 1e3
    rate7 = s5.char_ops / (ms7 / 1e3)
    log(f"5r blocked chain: median {ms7:.3f} ms over 3 reps after 1 warm-up "
        f"(CUDA events, {s5.chunks} launches with the state grown between "
        f"them); {rate7:.4g} char-ops/s ({s5.char_ops} char-ops); "
        f"per-chunk blocking time per real step p50 {p50:.2f} us, p99 "
        f"{p99:.2f} us (samples {[round(x, 2) for x in samples]}); "
        f"checkpoints {run5.stats.ckpt_ms:.1f} ms ({run5.stats.resyncs}); "
        f"{s5.steps} device steps ({steps7} doc-steps with work); plain "
        f"chain {plain7_ms:.1f} ms; bound {max(bb7, bo7):.4f} ms ({bytes7} "
        f"B, {ops7} ops); on {card}")

    # -- the un-blocked kernel on the same stream ----------------------------
    runners6 = stream.make_stream_replayers(s5, engine="unblocked",
                                            device=dev)
    k6 = chain(RLM.lanes_mixed_replay_cuda, runners6, lambda o: o[2:-1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sub6 = doc_subset(stream, B, s5, PLAIN_STRIDE_A6)
    p6 = chain(RLM.lanes_mixed_replay_plain, stream.make_stream_replayers(
        sub6, engine="unblocked", device=dev), lambda o: o[2:-1])
    torch.cuda.synchronize()
    plain6_ms = (time.perf_counter() - t0) * 1e3
    e6 = max(worst_err([t[:, ::PLAIN_STRIDE_A6] for t in k], q, A6_OUTPUTS)
             for k, q in zip(k6, p6))
    a6_worst = max(a6_worst, e6)
    del p6
    # The two engines: same origins every chunk, same tables and documents.
    same = all(torch.equal(a[i], b[i]) for a, b in zip(k6, k7)
               for i in (0, 1))
    same = same and all(torch.equal(k6[-1][i], k7[-1][j])
                        for i, j in ((5, 9), (6, 10)))
    last6 = RLM.LanesMixedResult(
        ordp=k6[-1][2].cpu(), lenp=k6[-1][3].cpu(), rows=k6[-1][4].cpu(),
        ol=None, orr=None, err=k6[-1][7].cpu(), batch=s5.n_docs)
    last7 = RLM.BlockedLanesMixedResult(
        *[t.cpu() for t in k7[-1][2:13]], ol=None, orr=None,
        err=k7[-1][13].cpu(), batch=s5.n_docs, block_k=64)
    same_docs = all(RL.expand_lane(last6, d).tolist()
                    == RL.expand_lane(last7, d).tolist()
                    for d in range(s5.n_docs))
    log(f"compare 5r un-blocked chain: max_abs_err {e6} against its plain "
        f"version on {sub6.n_docs} docs (one in {PLAIN_STRIDE_A6}; plain "
        f"chain {plain6_ms:.1f} ms); "
        f"against "
        f"the blocked kernel: origins and tables equal {same}, all "
        f"{s5.n_docs} documents equal {same_docs}")
    if e6 != 0 or not same or not same_docs:
        raise AssertionError("un-blocked kernel disagrees at the 5r shapes")
    ms6 = cuda_ms(torch, lambda: chain(RLM.lanes_mixed_replay_cuda,
                                       runners6, lambda o: o[2:-1]), reps=3)
    b6 = [lanes_bound(r.staged, (r.capacity, r.order_capacity), False, 64,
                      max(8, r.capacity // 64)) for r in runners6]
    bytes6, ops6 = sum(b[0] for b in b6), sum(b[1] for b in b6)
    bb6, bo6 = bytes6 / PEAK_BYTES_PER_S * 1e3, ops6 / PEAK_OPS_PER_S * 1e3
    log(f"5r un-blocked chain: median {ms6:.3f} ms over 3 reps after 1 "
        f"warm-up (CUDA events); {s5.char_ops / (ms6 / 1e3):.4g} "
        f"char-ops/s; bound {max(bb6, bo6):.4f} ms; on {card}")
    del k6, k7

    # -- the sync_stream example through the un-blocked kernel ---------------
    _kernels.reset_launches()
    t0 = time.perf_counter()
    counts = sync_stream.run(docs=128, chunks=3, ops_per_chunk=15,
                             device=dev, log=lambda m: log("  " + m))
    torch.cuda.synchronize()
    sync_wall = time.perf_counter() - t0
    l6 = _kernels.launches.get("rle_lanes_mixed", 0)
    log(f"sync_stream: {counts}, launches {dict(_kernels.launches)}, host "
        f"wall {sync_wall:.2f} s")
    if l6 < counts["chunks"]:
        raise AssertionError(f"sync_stream ran the un-blocked kernel {l6} "
                             f"times for {counts['chunks']} chunks")

    a6_line = {
        "name": "rle_lanes_mixed",
        "route": "cuda",
        "source": "text_crdt_rust_tpu_torch/ops/csrc/rle_lanes_mixed.cu",
        "replaces": "text_crdt_rust_tpu/ops/rle_lanes_mixed.py:105",
        "jax_counterpart":
            "text_crdt_rust_tpu/ops/rle_lanes_mixed.py::_mixed_lanes_kernel",
        "launches": l6,
        "launches_path": "examples/sync_stream (128 docs x 3 chunks)",
        "matches_plain": a6_worst == 0,
        "max_abs_err": a6_worst,
        # Timed at the 5r shapes: the chain of 8 chunk launches.
        "ms": ms6,
        "plain_ms": plain6_ms,
        "plain_docs": sub6.n_docs,
        "bound_ms": max(bb6, bo6),
        "bound_by": "bytes" if bb6 >= bo6 else "operations",
        "library_ms": None,
        "bytes": bytes6,
        "ops_lower_bound": ops6,
    }
    a7_line = {
        "name": "rle_lanes_mixed_blocked",
        "route": "cuda",
        "source":
            "text_crdt_rust_tpu_torch/ops/csrc/rle_lanes_mixed_blocked.cu",
        "replaces": "text_crdt_rust_tpu/ops/rle_lanes_mixed.py:774",
        "jax_counterpart": "text_crdt_rust_tpu/ops/rle_lanes_mixed.py::"
                           "_mixed_lanes_blocked_kernel",
        "launches": l7,
        "launches_path": "stream.run_stream (config 5r)",
        "matches_plain": a7_worst == 0,
        "max_abs_err": a7_worst,
        "ms": ms7,
        "plain_ms": plain7_ms,
        "plain_docs": sub7.n_docs,
        "bound_ms": max(bb7, bo7),
        "bound_by": "bytes" if bb7 >= bo7 else "operations",
        "library_ms": None,
        "bytes": bytes7,
        "ops_lower_bound": ops7,
        "char_ops_per_s": rate7,
        "p50_step_us": p50,
        "p99_step_us": p99,
        "checkpoint_ms": run5.stats.ckpt_ms,
        "setup_s": setup_s,
        "generation_s": gen_s,
        "compile_s": compile_s,
        "peak_device_bytes": peak_mem,
        "device_steps": s5.steps,
    }
    # -- the per-lane local replays and the config-5 path ----------------------
    a4_worst, a5_worst = local_lanes_phase(torch, dev, B, RL, randedit,
                                           TestPatch, np)
    a4_line, a5_line = config5_phase(torch, dev, card, stream, RL, _kernels,
                                     a4_worst, a5_worst)
    # -- the HBM-plane replay: kevin and the north star on A2 ----------------
    hbm_line = hbm_phase(torch, dev, card, B, R, TH, kevin, northstar,
                         randedit, TestPatch, np, _kernels)
    # -- the per-character block replays: A10, A8, A9 (the main path) ------
    # Their plain checks at the main paths' shapes run on the CPU in three
    # child processes meanwhile, one thread each: each phase does its card
    # work first and waits for its plain result last. The children start
    # only now, so that they take no core from the earlier phases' own
    # plain checks; they are stopped at exit.
    pool = multiprocessing.get_context("spawn").Pool(3)
    atexit.register(pool.terminate)
    plain_a9_async = pool.apply_async(plain_a9, (PLAIN_LANES_A9, TRACE_A9))
    plain_a10_async = pool.apply_async(plain_a10,
                                       (STORM_ROUNDS, CHAR_LANES))
    plain_a8_async = pool.apply_async(plain_a8, (PREFIX_A8, CHAR_LANES))
    a10_line = blocked_a10_phase(torch, dev, card, B, storm, TBL, TBM, np,
                                 _kernels, plain_a10_async)
    a8_line = blocked_a8_phase(torch, dev, card, B, northstar, TBL, TBH,
                               randedit, TestPatch, np, _kernels,
                               plain_a8_async)
    a9_line = blocked_a9_phase(torch, dev, card, B, northstar, TBL, TBH,
                               randedit, TestPatch, np, _kernels,
                               plain_a9_async)
    pool.close()
    pool.join()
    log(json.dumps({"kernels": [rle_line, mixed_line, a6_line, a7_line,
                                a4_line, a5_line, hbm_line, a8_line,
                                a9_line, a10_line]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
