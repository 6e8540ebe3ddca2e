"""Run the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds every CUDA kernel of the port from the sources in
   ``text_crdt_rust_tpu_torch/ops/csrc`` (timed as set-up), then starts
   the child processes of the CPU plain checks (``os.cpu_count()`` less
   one, at most seven, one thread each; printed): A9's, A10's and A8's
   at once, with configs 2 and 3's streams (their run-row dry runs are
   their set-up) and A1's plain chains on two lanes of each group; the 5r
   plain chains' shards once the 5r stream exists.
3. Holds each kernel against its plain PyTorch version on the card, on
   the same inputs, bit for bit (the replay state is integers): a fused
   trace prefix, fused prepend bursts (W > 2), two divergent doc groups
   (also at K = 2,048 and 4,096: the small cases of every kernel that
   takes a K include K = 4,096), and the two error cases (block table
   full, delete past the end).
4. Drives the main path through its entry point,
   ``northstar.run_northstar()``: the full automerge-paper trace replayed
   into 512 identical documents (capacity 20,992 run rows, K = 128,
   fuse_w = 8). With the launch counts set to 0 just before and read just
   after, it fails unless every kernel of the path launched, doc 0
   reproduces the trace's ``endContent`` and every lane equals lane 0.
5. At the main path's shapes: kernel against plain version once more,
   the plain version's time, and the kernel's median time over 3 runs
   after 1 warm-up (CUDA events), with ops/s and device steps.
5a. The north star at ``BASELINE.json``'s width, 10,240 documents (512
   lanes x 20 doc groups in one launch), through ``northstar.run_northstar(
   batch=512, groups=20)``, launch counts set to 0 just before and read
   just after: it fails unless A1 launched, doc 0 reproduces
   ``endContent``, every group equals group 0 and every lane of every
   group equals lane 0 of phase 4's 512-document run (all eight outputs,
   compared on the card; only one lane is expanded on the host) and the
   native engine's text equals ``endContent``. Then A1's median over 3
   runs after 1 warm-up (CUDA events), patches/s = 259,778 x 10,240 /
   time, µs a step, the bound by bytes and by operations, peak device
   memory and set-up (the compile) apart.
6. The mixed run replay (``rle_mixed_replay``, A3) against its plain
   version on the card, bit for bit on all eight outputs: a small delete
   storm (K = 8), a mid storm (16 peers x 20 rounds, K = 32) with the fast
   YATA scan and with the serial walk alone, a two-peer merge with
   splits and mid-run cursors, a local-only stream, a capacity
   overflow that must raise ``err[0]``, a storm whose fast-scan windows
   span many 8-row blocks, and the mid storm at K = 2,048 with the planes
   in shared memory and in device memory, and at K = 4,096; each case
   prints its windows' blocks and its hint misses.
7. Drives the storm path through its entry point, ``storm.run_storm()``:
   the config-4 insert storm and its delete-heavy variant (16 peers x
   200 rounds, 128 documents, K = 128), launch counts set to 0 just
   before and read just after. It fails unless ``rle_mixed_replay``
   launched at least twice, both texts equal the oracle receiver's and
   every lane equals lane 0.
8. At the storm shapes, per variant: host set-up (generation and
   compile), kernel against plain version once more, the plain
   version's time, the kernel's median over 3 runs after 1 warm-up
   (CUDA events), char-ops/s, device steps, µs a step and the bound by
   bytes and by operations; then the kernel's order lookups, hint misses,
   fast-scan windows (blocks spanned, mean and most) and shares of its
   cycles (``clock64``), its median at 128, 256 and 512 threads a thread
   block, and the wrapper's choice with its reason.
8a. Config 2 (``BASELINE.json`` "random_edits"): 20,000 seeded random
   patches (19,996 steps, capacity 60,416 run rows, K = 256, NB 236) into
   128 documents through ``random_edits.run_random_edits()`` on the
   stream its child process built; 8b. config 3 (the ragged rustcode +
   sveltecomponent corpus, 13,001 and 5,733 steps, two doc groups of 128
   documents, capacity 37,376, K = 256) through ``corpus.run_corpus()``.
   Each counted (A1 must launch), each group's doc 0 against its text,
   every lane against lane 0, the native engine's texts, each group's run
   rows against the dry run's final count (rustcode's 69,108-character
   paste chained in 512-character steps must fuse back); then A1 against
   its plain chain (the child's) on lanes 0-1 of each group, bit for bit
   on all eight outputs, its median over 3 runs after 1 warm-up, patches/s,
   µs a step, the bound, and its counters (splits, window loads a step,
   cycle shares) for lane 0 of each group.
9. The per-lane mixed replays, un-blocked (``rle_lanes_mixed``) and
   blocked (``rle_lanes_mixed_blocked``), against their plain versions on
   the card, bit for bit on all 8 and 14 outputs: divergent tiebreaks,
   two-peer merges, fragmented and double deletes, local and remote ops in
   one step, K = 8 storms (splits, stale hints, forward hops, the plane
   fallback), a warm-start chain growing its capacity, the error rows,
   W = 5 bursts whose splices wrap a 16-row column (err[0], ``rows`` past
   the capacity), two-peer merges at K = 2,048 and 4,096, and 32,768-row
   columns, of which the un-blocked kernel
   keeps the first 29,056 rows in shared memory (all a thread block
   may hold). Then the un-blocked kernel's own cases: warm starts whose
   documents keep their last two rows past ``rows`` (a 5r stream and a
   local one), and 11 documents at 1, 2, 4 and 8 documents a thread
   block, with the columns in shared memory, in device memory from the
   start and in a window of rows that half of them outgrow mid-launch,
   each with its launch geometry (rows on chip, blocks an SM, waves).
10. Drives the config-5r path through its entry point,
   ``stream.run_stream()``: 2,048 documents x 8 chunks x 100 patches,
   K = 64, a checkpoint every 4 chunks, launch counts set to 0 just before
   and read just after. It fails unless the blocked kernel launched once
   per chunk, every chunk's flags were clear and every sampled document
   equals the oracle. Host set-up (generation, compile) is timed apart.
11. At the 5r shapes: the chain of 8 blocked launches, its outputs on
   every 16th document kept for the plain chain (128 of 2,048, at the
   same per-document shapes: documents are independent, as the CPU tests
   hold a B-lane replay against B one-lane replays), which runs in four
   shards of neighbouring documents in the child processes and is held
   against them, bit for bit after every chunk, at the end (each shard's
   time printed); the kernel chain's median over 3 runs after 1 warm-up
   (CUDA events); char-ops/s; per-chunk blocking time per real step
   (p50, p99); the checkpoint time; peak device memory; device steps and
   the bound.
12. The un-blocked kernel on the same stream: against its plain version
   on every 8th document (256, in four shards likewise) and against the
   blocked kernel on all 2,048 (expanded lanes, origins, tables); its
   chain's median, µs a
   real step and bound (by bytes and by operations); on the last chunk
   the columns' extent and the YATA probes per remote insert (mean,
   most); the chain's median at 1, 2, 4 and 8 documents a thread block
   with each launch geometry, and the wrapper's choice with its reason;
   then ``stream.run_stream(engine="unblocked")`` with the launch counts
   set to 0 just before and read just after (once per chunk, every
   chunk's flags clear, the sampled documents equal the oracle).
13. ``examples/sync_stream`` through the un-blocked kernel (128 documents
   x 3 chunks x 15 patches per peer, every chunk oracle-checked), counted;
   its three launches are kept and timed again (CUDA events).
14. The per-lane local replays, un-blocked (``rle_lanes``) and blocked
   (``rle_lanes_blocked``), against their plain versions on the card, bit
   for bit on all 6 and 9 outputs: divergent documents (the CPU tests'
   seeds 7 and 42, K = 16 and 8, splits), pure inserts and deletes with
   the SHARED_CUM hoist, fused W-row bursts, both error rows with their
   post-error state, W = 5 bursts wrapping a 16-row column, 32,768-row
   columns, K = 2,048 and 4,096 (A5 with each document's rows in shared
   memory and in device memory, where they fit a thread block), and a
   warm-start chain growing its capacity 64 -> 128 -> 192 at K = 8;
   then the un-blocked kernel's own cases as in phase 9 (rows past
   ``rows`` on a config-5 stream, 1-8 documents a thread block in the
   three layouts).
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
   the bound by bytes and by operations; the kernel's counters over the
   chain (steps, deletes and their iterations, inserts, splits, block
   copies, head reads from device memory, ``clock64`` shares of slot
   locates, delete passes, splices, table upkeep and splits), the last
   chunk's launch geometry, and the chain's median with the rows in
   shared memory and in device memory.
17. The un-blocked kernel on the same stream: through
   ``run_stream_5(engine="unblocked")`` with the launch counts set to 0
   just before and read just after, against its plain version on all
   2,048 documents, and against the blocked kernel (origins every chunk,
   every document); its chain's median time, µs a real step and bound
   (by bytes and by operations), the columns' extent on the last chunk,
   and the chain's median at 1, 2, 4 and 8 documents a thread block with
   each launch geometry and the wrapper's choice.
18. The HBM-plane run replay (``rle_hbm_replay``, A2) against its plain
   version on the card, bit for bit on all eight outputs: random streams
   and three divergent groups at K = 8, fused prepend bursts at K = 64, a
   far-jump stream beside a raw random one at K = 512 (window misses), 20k
   prepends fused W = 64 at K = 2,048 (splits) with and without origins
   and at K = 4,096, both error rows, and the window ring's edge cases: splices and delete
   splits on both sides of a block's middle (K = 64), and full tables
   whose W = 3 and W = 7 prepends splice on past K rows with err row 0
   raised; each case prints its splits and window loads.
19. Drives kevin through its entry point, ``kevin.run_kevin()``:
   5,000,000 single-char prepends fused to 78,125 W = 64 steps, 128
   documents, K = 2,048, capacity 10,500,096 run rows (10.75 GB of
   planes), no per-op origins; launch counts set to 0 just before and
   read just after. It fails unless ``rle_hbm_replay`` launched, the
   flags are clear, lane 0 expands to orders ``n .. 1`` and every lane
   equals lane 0 over the used blocks. Host set-up (``compile_kevin``)
   apart; the kernel's median over 3 runs after 1 warm-up (CUDA events),
   prepends/s, device steps, µs a step, blocks in use, peak device memory
   above what was held before, the bound by bytes and by operations; its
   splits, window loads and share of cycles in splits (``clock64``), its
   median at 1, 2, 4, 8 and 16 warps a thread block and the wrapper's
   choice with its reason. The planes are freed after it.
20. The plain check at kevin's geometry: kernel against plain version, bit
   for bit, on all 5,000,000 prepends (78,125 steps, K = 2,048, W = 64,
   origins kept so they are checked too) at 8 of the run's 128 identical
   documents, the plain version on the CPU in a child process started at
   the top (its time; the kernel re-launched here on the child's columns).
21. Drives the north star on A2 through ``northstar.run_northstar(engine=
   "rle-hbm", batch=1024)`` (K = 512, capacity 32,768), counted the same
   way: it fails unless doc 0 reproduces ``endContent`` and every lane
   equals lane 0; then, at the same shapes, the kernel against its plain
   version and against A1's kernel on the same stream (lane 0's expanded
   runs and origins), times, µs a step and the bound, and the same warp
   sweep as kevin's.
22. The per-character block replay with the document in shared memory
   (``blocked_replay``, A8) against its plain version on the card (random
   streams with rebalances at K = 16 and 32, prepends, a delete across
   blocks, a far-jump stream, the delete past the end, K = 2,048 and
   4,096, shared with A9), then the north
   star's 19,149-patch
   prefix (16,384 inserted characters, capacity 32,768 rows, K = 512, 128
   documents) through ``northstar.run_northstar(engine="blocked")``,
   counted: it fails unless the kernel launched, doc 0 reproduces the
   prefix's text and every lane equals lane 0. At that shape: the kernel
   against its plain version on all 128 lanes, against A9's kernel on the
   same stream and geometry (``signed``, ``rows[:NB]``, ``ol``, ``orr``,
   ``err``), its median over 3 runs after 1 warm-up, patches/s, the bound.
23. The per-character replay with the rows in device memory
   (``blocked_hbm_replay``, A9): the small cases (three doc groups, K =
   2,048, and the far-jump stream that leaves the kernel's cache of
   blocks on nearly every step, with the misses printed), then the whole
   automerge-paper trace (259,778
   steps, capacity 524,288 rows, K = 512, 128 documents) through
   ``northstar.run_northstar(engine="hbm")``, counted the same way, with
   doc 0 against ``endContent`` and peak device memory. At that shape: the
   kernel against its plain version over all 259,778 steps on lanes 0-7,
   and every one of the kernel's 128 lanes equal to lane 0 (every lane
   replays the same stream, and the plain version replays each step as a
   sequence of small PyTorch operations: minutes on one CPU core even at
   8 lanes); the median over 3 runs after 1 warm-up, patches/s, the
   rebalance count and the bound, without and with the rebalances'
   traffic, the cache misses, and the replay's median at 1, 2, 4, 8 and
   16 warps a thread block, with the choice the wrapper makes.
24. The per-character mixed replay (``blocked_mixed_replay``, A10) against
   its plain version: small storms, a delete storm, storms of 40 and 48
   peers (more than 32 concurrent inserts at one origin) and tie runs
   that carry a pinned scan_start across the scan's 32-position
   sub-windows, K = 2,048 and 4,096, a document too large for the scan's
   view to
   sit beside it in shared memory, an unknown delete target (err rows 1
   and 2), a remote insert after an absent order and origin-left entries
   naming absent orders (err row 2 from the left cursor and from inside
   the scan). Then the config-4 insert storm (16 peers x 200 rounds,
   12,800 characters, capacity 32,768 rows, K = 256, 128 documents)
   through ``storm.run_storm(engine="blocked-mixed")``, counted: it fails
   unless the kernel launched, doc 0 equals the oracle receiver and every
   lane equals lane 0. The main path's outputs against the plain version
   over all 3,200 steps on all 128 lanes (its ~9.7M conflict-scan steps
   read a host copy of the state: under a minute on one CPU core), the
   kernel's conflict-scan steps (equal to the plain version's count) and
   windows, then the median over 3 runs after 1 warm-up, char-ops/s, µs a
   scan step, the bound (the scan's comparisons counted as operations).
   The plain versions of phases 22-24 at those shapes run on the CPU in
   the child processes started in phase 2; the three phases run in the
   order 24, 22, 23, each doing its card work first and waiting for its
   plain result last.
25. The document server (``serve/``) on A7, right after the 5r phases:
   ``ServeLoadGen(docs=200, agents_per_doc=3, ticks=60,
   events_per_tick=48, 10% faults, seed=7)`` on ``ServeConfig(engine=
   "rle-lanes-mixed", num_shards=2, lanes_per_shard=16)`` (K = 32,
   capacity 512 run rows, order tables of 1,536 rows, tick shapes padded
   to 8, 32 and 128 steps) at pipeline depths 1 and 2, each counted
   (launch counts set to 0 just before, read just after) and held
   against the JAX package's golden record of the same run
   (``tests/data/serve_lanes_golden.json``: the report's logical fields,
   every document's string and digest, the sha256 of the trace stream
   without its walls); it fails unless both converge, equal the record,
   evict at least 20 times and launch only the three shapes. Then the
   wide shape: 4,096 documents on 2 x 1,024 lanes, 1,024 events a tick,
   16 ticks (the per-doc queue bound raised to 1,024, see
   ``SERVE_WIDE``), which must converge. Each run prints its host wall,
   ticks, tick ms p50/p99 (the caller's clock), A7's launches and device
   ms (CUDA events around each launch, summed), item-ops/s, evictions,
   restores, lane writes, the pipeline's overlap share and stall, and
   peak device memory. A7 is held against its plain version on the
   depth-1 acceptance run's launches with a split, every S = 128 launch
   and every 8th launch of each shard (in this process), and on every 8th
   launch of each shard of the wide run (in the child processes).
26. ``ServeConfig()``'s document server on the flat kernel
   (``ops/csrc/flat_replay.cu``, the flat engine's step chain; no TPU
   kernel behind it, the JAX package runs it as an XLA program): the
   kernel against its plain version on small cases (local edits, a
   remote storm, fuzzed op kinds, a train of 4 with idle steps) at
   capacities 256 and 4,096; then the serve acceptance shape of phase 25
   on ``ServeConfig()`` (the flat engine, 2 x 16 lanes, capacity 512,
   order logs of 1,536, lmax 16) at (pipeline depth, train length) 1/1,
   2/1 and 2/4, each counted and held against the JAX package's golden
   record ``tests/data/serve_flat_golden.json`` (trains on the fields a
   train does not change); it fails unless each converges, equals the
   record, launches the flat kernel and never A7. Then the wide shape of
   phase 25 on 2 x 1,024 flat lanes, which must converge. Each run prints
   its host wall, tick ms p50/p99, the kernel's launches, device ms, us
   a device step and share of the wall, item-ops/s, evictions, the
   overlap share and stall, the train economy and peak device memory.
   The kernel is held against its plain version on every S = 128
   launch, every train with T > 1 and every 8th launch of each shard of
   the three acceptance runs (in this process; the kernel re-launched on
   the same inputs is timed there) and on every 8th launch of each shard
   of the wide run (in the child processes). Then crash recovery
   (``serve/chaos.run_crash_scenario``) at all four kill phases at the
   ``recovery`` cost-ledger cell's shape and killed post-dispatch at tick
   30 of the acceptance shape, each
   identical to its uncrashed twin (the acceptance one to the golden
   record's documents) with green crash audits; ``DeviceMirror`` on a
   3-agent history; and a ``torch.profiler`` capture (``profile_dir``)
   that must name the kernel.
26a. The port's trace analytics (``obs/analyze.py``) on the events the
   depth-1 and depth-2 acceptance runs of phase 26 kept (their walls from
   this script's clock; the runs are not repeated): the phase breakdown
   with its stall budget and the host-against-device overlap report,
   printed with the card; the recompile timeline, which fails on a
   ``device.compile`` after the first 10 ticks or on a (shard, bucket)
   compiled twice; the per-op flow census, which fails unless its
   conservation audit accounts for every span; the Chrome export, written
   to a temporary file and read back as trace-event JSON; the depth-1
   events written as JSONL, read back with ``load_events`` and diffed
   against themselves (must be None); then the phase's seconds.
27. The wide serve and flat launches and the 5r plain chains' shards
   (phases 11 and 12) against the kernels' outputs.
27a. Once the child processes have drained (no child runs: the CPU
   baseline shares the host with nothing of this script), the native C++
   engine's single-core baseline, timed as ``bench.py`` times it (the
   1-minute load average and the CPU model and core count printed, a
   warning above half the cores, each sample printed): config 1 (the
   automerge-paper trace on the native engine, which is also the north
   star's denominator, and on the text-only rope; median of 5), both
   config-4 storms, config 5r's document 0 (its txns) and config 5's (its
   patches), config 2's patches, each config-3 trace (median of 5), and
   kevin's 5,000,000 prepends (median of 3); each text checked. Then each
   cell's ratio, the device's rate over the native rate, as measured in
   this run, and one JSON line with them.
27b. Config sp and the rest of the long-context layer (``parallel/``,
   ``ops/stream_scan``), the run-row dry runs made in a child process:
   ``sp.py``'s stages on the whole automerge-paper trace (10,712 steps, 4
   chunks) in a world of one rank on the card over NCCL, on S1
   (``ops/csrc/sp_replay.cu``: one launch a chunk; the launch counts set
   to 0 just before the replay and read just after, at least one a
   chunk; a one-rank group's collectives are made in place, so the
   collectives a step count only each chunk's closing OR), then on its
   20,000-patch prefix; the text against ``endContent`` and the native
   engine's, ``expand()`` against the order column A1 gives for the same
   compile (counted: A1 must launch). After each replay, every chunk again
   through S1, and through its plain version from the same input state
   (CUDA events around each; of the whole trace, the first and the last
   chunk, the shallowest and the deepest state): every output equal, the whole ``[R]`` planes (rows
   past ``rows``), ``rows``, the tables, both logs and the error bits.
   Then a world of four ranks (one a card over NCCL where
   there are four cards, else four processes sharing the card over gloo,
   which is printed): the prefix at sp = 4 sized to take one
   ``auto_reshard`` retry, on S1 a segment between the collectives, equal
   to the sp = 1 run and, chunk by chunk, to the plain version (the
   flagged attempt included); ``make_sharded_apply`` (dp = 2, sp = 2) on 8
   documents x the 2,000-patch prefix, F1 counted in the ranks, against
   the unsharded apply; and ``dryrun_multichip(4)``'s job. Each replay's
   wall (this script's clock), steps/s and collectives a step. Last,
   ``StreamedRuns`` on a 2^27-row memmapped plane (1 GiB; the north
   star's final runs repeated with dense order offsets) in a temporary
   directory: ``live_total`` and 1,000 seeded rank and 1,000 order lookups
   against numpy, the time a lookup and a tile upload.
28. Prints ``{"kernels": [...]}`` (the ten TPU kernels' ports, the
   flat kernel and S1, its time the whole trace's 4 chunks on the card; A1's line carries the 10,240-document north star and
   configs 2 and 3, A7's the serve runs) and, as its last line,
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line; so does a host without
CUDA, and a directory without the rest of the repository.
"""
from __future__ import annotations

import atexit
import json
import multiprocessing
import os
import platform
import statistics
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate (data sheet)
PLAIN_STRIDE_A7 = 16           # 5r blocked plain chain: every 16th doc
PLAIN_STRIDE_A6 = 8            # 5r un-blocked plain chain: every 8th doc
SHARDS_5R = 4                  # child processes a 5r plain chain is cut into


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
    cases.append(("2 divergent groups, B=8, K=2,048", groups,
                  dict(capacity=4096, batch=8, block_k=2048), wants, None))
    cases.append(("2 divergent groups, B=4, K=4,096", groups,
                  dict(capacity=8192, batch=4, block_k=4096), wants, None))
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
    recv_mid = recv.to_string()
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
    # Fast-scan windows spanning many 8-row blocks, splits between them.
    txns, recv = randedit.make_storm(16, 40, 4, seed=11, del_prob=0.35)
    multi = storm.compile_storm_txns(txns, 4, 0.35)
    cases.append(("multi-block windows, storm 16x40, B=32, K=8", multi,
                  dict(capacity=storm.storm_capacity(multi, 8), batch=32,
                       block_k=8, chunk=128), recv.to_string(), None))
    # K = 2,048: the planes in shared memory (two of them), then in device
    # memory (a capacity too large for it).
    for cap, where in ((2048 * 8, "run planes in shared memory"),
                       (2048 * 16, "planes in device memory")):
        cases.append((f"mid storm 16x20, K=2048, {where}, B=32", mid,
                      dict(capacity=cap, batch=32, block_k=2048, chunk=128),
                      recv_mid, None))
    cases.append(("mid storm 16x20, K=4096, run planes in shared memory, "
                  "B=8", mid, dict(capacity=4096 * 4, batch=8, block_k=4096,
                                   chunk=128), recv_mid, None))
    return cases


def mixed_warps(torch, dev, RM, staged, shape, name, steps):
    """A3 at a storm's shape: its order lookups, hint misses, fast-scan
    windows and shares of cycles (``stats``), its median at 4, 8 and 16
    warps a thread block and the wrapper's choice."""
    Bn = shape["batch"]
    stats = torch.zeros(Bn, RM.STATS, dtype=torch.int64, device=dev)
    RM.rle_mixed_replay_cuda(*staged, **shape, stats=stats)
    torch.cuda.synchronize()
    v = [int(x) for x in stats[0]]
    tot = max(v[9], 1)
    log(f"{name}: {v[0]} order lookups, {v[1]} hint misses, {v[2]} fast "
        f"scans whose windows span {v[3] / max(v[2], 1):.3f} blocks on "
        f"average and {v[4]} at most, {v[5]} serial walks a lane; shares "
        f"of the chain's {v[9]} cycles (clock64): window passes "
        f"{v[6] / tot:.4f}, order lookups {v[7] / tot:.4f}, splices "
        f"{v[8] / tot:.4f}")
    times = {}
    for warps in (4, 8, 16):
        times[warps] = cuda_ms(torch, lambda: RM.rle_mixed_replay_cuda(
            *staged, **shape, warps=warps), reps=3)
        log(f"{name}: {warps * 32} threads a thread block, median "
            f"{times[warps]:.3f} ms, {times[warps] / steps * 1e3:.3f} us a "
            f"step")
    choice = RM.pick_warps(Bn, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"{name}: the wrapper picks {choice * 32} threads: {Bn} lanes on "
        f"{sms} SMs ({'one lane an SM, the helper warps cost no residency' if Bn <= sms else 'lanes share SMs'}); "
        f"fastest measured {min(times, key=times.get) * 32} threads")
    return {"threads": choice * 32, "ms_by_threads": {
        w * 32: t for w, t in times.items()}, "hint_misses": v[1],
        "window_blocks_mean": v[3] / max(v[2], 1), "window_blocks_max": v[4]}


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


# -- A1 at the north star's 10,240 documents and at configs 2 and 3 -------------

NS_GROUPS = 20               # BASELINE.json's 10k documents: 512 x 20 groups
NS_LANES = 512               # documents a group (the main path's batch)
PLAIN_LANES_A1 = 2           # lanes of configs 2 and 3's plain chains
#: Names of A1's ``stats`` counters (``ops/rle.py`` ``STATS``).
A1_STATS = ("splits", "window_loads", "successor_peeks", "steps",
            "cycles_slot_locate", "cycles_run_locate", "cycles_insert_splice",
            "cycles_delete", "cycles_split", "cycles_window_load",
            "cycles_write_out", "cycles_all")
BASELINE_REPS = 5            # native baseline: median of 5 (bench.py)
KEVIN_REPS = 3               # kevin's native baseline: median of 3
KEVIN_NATIVE = 5_000_000     # kevin's native prepends (bench.py:1563)


def a1_bound(staged, shape):
    """(bytes, operations) that one A1 launch must at least move and do:
    each input read once and each output written once, and per lane one
    K-row block plus the NBL live-prefix slots for every step with work
    (every group's steps counted once)."""
    G, S, Bn, CAP, K = (shape["groups"], shape["steps"], shape["batch"],
                        shape["capacity"], shape["block_k"])
    NBL = max(8, CAP // K)
    nbytes = 4 * (5 * G * S + 2 * G * CAP * Bn + 2 * G * NBL * Bn
                  + 8 * G * Bn + 2 * G * S * Bn + 8 * Bn)
    active = int(((staged[1] > 0) | (staged[2] > 0)).sum())
    return nbytes, active * Bn * (K + NBL), active


def lanes_match(torch, results, ref) -> bool:
    """Every lane of every group of ``results`` equals lane 0 of ``ref`` (a
    result of the same stream and geometry) in every output, compared on
    the card."""
    names = ("ordp", "lenp", "blkord", "rows", "meta", "ol", "orr", "err")
    for r in results:
        for name in names:
            a, b = getattr(r, name), getattr(ref, name)[..., :1]
            if a.shape[:-1] != b.shape[:-1] or \
                    not torch.equal(a, b.expand_as(a)):
                return False
    return True


def config_streams(which: str, lanes: int):
    """Runs in a child process, on the CPU: config 2's (``which`` "2") or
    config 3's ("3") stream, built as its entry point builds it (the
    run-row dry run is its set-up), then A1's plain version on ``lanes``
    lanes of it, one thread. Returns the stream, the set-up seconds, the
    staged columns, the plain outputs and the plain seconds."""
    import torch

    from text_crdt_rust_tpu_torch import corpus, random_edits
    from text_crdt_rust_tpu_torch.ops import rle as R

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if which == "2":
        st = random_edits.make_random_edits_stream()
        rep = random_edits.make_random_edits_replayer(st, lanes, "cpu")
    else:
        st = corpus.make_corpus_stream()
        rep = corpus.make_corpus_replayer(st, lanes, "cpu")
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = R.rle_replay_plain(*rep.staged, **rep.shape)
    plain_s = time.perf_counter() - t0
    return (st, setup_s, [c.numpy() for c in rep.staged],
            [o.numpy() for o in outs], plain_s)


def run_rows(res) -> int:
    """Run rows of lane 0 over the blocks in use."""
    nlog = int(res.meta[0, 0])
    return int(res.rows[:nlog, 0].sum())


def northstar_10k_phase(torch, dev, card, northstar, R, _kernels, ref):
    """The north star at 10,240 documents through ``run_northstar(batch=
    512, groups=20)``: counted, doc 0 of group 0 against ``endContent``,
    every group equal to group 0 and every lane of every group equal to
    lane 0 of the 512-document run (``ref``) on the card; then A1's
    median, rate, µs a step and bound, peak device memory and set-up
    apart. Returns A1's numbers for the kernels line."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    stream = northstar.compile_northstar()
    setup_s = time.perf_counter() - t0
    docs = NS_LANES * NS_GROUPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    run = northstar.run_northstar(batch=NS_LANES, groups=NS_GROUPS,
                                  stream=stream, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.launches.get("rle_replay", 0)
    t0 = time.perf_counter()
    lanes_ok = lanes_match(torch, run.results, ref)
    compare_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_mem
    res = run.results[0]
    log(f"north star 10k: run_northstar(batch={NS_LANES}, groups="
        f"{NS_GROUPS}) {stream.n_patches} patches -> {stream.steps} device "
        f"steps, {docs} documents, capacity {res.ordp.shape[0]}, K="
        f"{res.block_k}, blocks in use {int(res.meta[0, 0])}: launches "
        f"{dict(_kernels.launches)}; doc 0 == endContent {run.text_ok}, "
        f"every group == group 0 {run.groups_equal}, every lane == lane 0 "
        f"of the 512-document run {lanes_ok} (compared on the card in "
        f"{compare_s:.2f} s), native engine == endContent {run.native_ok}; "
        f"host wall {wall:.2f} s (replay, doc 0's readback, the native "
        f"replay); set-up {setup_s:.2f} s (load, merge, compile, fuse); "
        f"peak device memory {peak / 2**30:.3f} GiB above the "
        f"{base_mem / 2**30:.3f} GiB held before")
    if launches < 1 or not run.ok or not lanes_ok:
        raise AssertionError(
            f"north star 10k failed: launches {launches}, text "
            f"{run.text_ok}, groups {run.groups_equal}, lanes {lanes_ok}, "
            f"native {run.native_ok}")
    del run, res
    rep = northstar.make_northstar_replayer(stream, batch=NS_LANES,
                                            groups=NS_GROUPS, device=dev)
    ms = cuda_ms(torch, lambda: R.rle_replay_cuda(*rep.staged, **rep.shape),
                 reps=3)
    nbytes, nops, active = a1_bound(rep.staged, rep.shape)
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    o_ms = nops / PEAK_OPS_PER_S * 1e3
    rate = stream.n_patches * docs / (ms / 1e3)
    geometry = dict(thread_blocks=NS_GROUPS * NS_LANES, warps=R.WARPS,
                    smem=R.kernel_smem_bytes(
                        rep.shape["block_k"],
                        max(8, rep.shape["capacity"]
                            // rep.shape["block_k"])))
    phase_s = time.perf_counter() - t_phase
    log(f"replay 10k: median {ms:.3f} ms over 3 reps after 1 warm-up (CUDA "
        f"events); {rate:.4g} patches/s ({stream.n_patches} x {docs} docs); "
        f"{stream.steps} steps a chain, {ms * 1e3 / stream.steps:.3f} us a "
        f"step; bound {max(b_ms, o_ms):.4f} ms ({nbytes} B: {b_ms:.4f} ms "
        f"by bytes; {nops} ops: {o_ms:.4f} ms by operations); launch "
        f"geometry {geometry}; phase {phase_s:.1f} s; on {card}")
    return dict(launches=launches, docs=docs, groups=NS_GROUPS, ms=ms,
                patches_per_s=rate, us_per_step=ms * 1e3 / stream.steps,
                bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations",
                bound_bytes_ms=b_ms, bound_ops_ms=o_ms, bytes=nbytes,
                ops_lower_bound=nops, serial_steps=stream.steps,
                peak_device_bytes=peak, host_wall_s=wall, setup_s=setup_s,
                lanes_compare_s=compare_s, geometry=geometry,
                phase_s=phase_s)


def config_phase(torch, dev, card, label, task, run_fn, replayer, R,
                 _kernels, n_patches_of):
    """Config 2 or 3 on A1: waits for the child that built its stream and
    ran the plain chain, drives the entry point (``run_fn(stream)``)
    counted, checks texts, lanes, native texts and each group's run rows
    against the dry run, then times the kernel, prints its counters and
    holds its first lanes against the plain chain. Returns A1's numbers
    for the kernels line and the stream."""
    t_phase = time.perf_counter()
    st, setup_s, cols_np, plain_np, plain_s = task.get()
    wait_s = time.perf_counter() - t_phase
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    run = run_fn(st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.launches.get("rle_replay", 0)
    peak = torch.cuda.max_memory_allocated() - base_mem
    results = run.results if hasattr(run, "results") else [run.result]
    streams = st.streams if hasattr(st, "streams") else [st.rle]
    rows = [run_rows(r) for r in results]
    want_rows = [s.final_rows for s in streams]
    log(f"{label}: launches {dict(_kernels.launches)}; steps "
        f"{[s.steps for s in streams]}, capacity {results[0].ordp.shape[0]}"
        f" run rows, K={results[0].block_k}, B={results[0].batch}, blocks "
        f"in use {[int(r.meta[0, 0]) for r in results]} of "
        f"{results[0].num_blocks}; text ok {run.text_ok}, lanes equal "
        f"{run.lanes_ok}, native ok {run.native_ok}; run rows {rows} "
        f"(the dry run's {want_rows}); host wall {wall:.2f} s (replay, "
        f"readback, the native replays); set-up {setup_s:.2f} s in a child "
        f"process (load, merge, compile, the run-row dry run), waited "
        f"{wait_s:.1f} s for it; peak device memory "
        f"{peak / 2**20:.1f} MiB")
    if launches < 1 or not run.ok or rows != want_rows:
        raise AssertionError(f"{label} failed: launches {launches}, ok "
                             f"{run.ok}, run rows {rows} != {want_rows}")
    del run, results
    rep = replayer(st)
    if not same_inputs(torch, rep.staged, cols_np):
        raise AssertionError(f"{label}: the child staged other inputs")
    kern = R.rle_replay_cuda(*rep.staged, **rep.shape)
    torch.cuda.synchronize()
    err = char_err(torch, kern, plain_np, PLAIN_LANES_A1, OUTPUTS)
    del kern
    log(f"compare {label}: max_abs_err {err} against the plain version on "
        f"lanes 0-{PLAIN_LANES_A1 - 1} of each group (all eight outputs; "
        f"{plain_s:.1f} s in its child process)")
    if err != 0:
        raise AssertionError(f"{label}: A1 disagrees with its plain version")
    ms = cuda_ms(torch, lambda: R.rle_replay_cuda(*rep.staged, **rep.shape),
                 reps=3)
    G, Bn = rep.shape["groups"], rep.shape["batch"]
    stats = torch.zeros(G, Bn, R.STATS, dtype=torch.int64, device=dev)
    R.rle_replay_cuda(*rep.staged, **rep.shape, stats=stats)
    torch.cuda.synchronize()
    per_group = [stats[g, 0].tolist() for g in range(G)]
    for g, v in enumerate(per_group):
        log(f"  {label} counters, group {g} lane 0: {R.describe_stats(v)}")
    nbytes, nops, active = a1_bound(rep.staged, rep.shape)
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    o_ms = nops / PEAK_OPS_PER_S * 1e3
    n_patches = n_patches_of(st)
    rate = n_patches * Bn / (ms / 1e3)
    chain = max(s.steps for s in streams)
    phase_s = time.perf_counter() - t_phase
    log(f"replay {label}: median {ms:.3f} ms over 3 reps after 1 warm-up "
        f"(CUDA events); {rate:.4g} patches/s ({n_patches} x {Bn} docs); "
        f"{active} steps with work, the longest chain {chain} steps, "
        f"{ms * 1e3 / chain:.3f} us a step; bound {max(b_ms, o_ms):.4f} ms "
        f"({nbytes} B: {b_ms:.4f} ms by bytes; {nops} ops: {o_ms:.4f} ms by "
        f"operations); phase {phase_s:.1f} s; on {card}")
    return dict(launches=launches, ms=ms, patches=n_patches,
                patches_per_s=rate, us_per_step=ms * 1e3 / chain,
                steps=[s.steps for s in streams], batch=Bn,
                capacity=rep.shape["capacity"], block_k=rep.shape["block_k"],
                bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations",
                bound_bytes_ms=b_ms, bound_ops_ms=o_ms, bytes=nbytes,
                ops_lower_bound=nops, serial_steps=active,
                plain_ms=plain_s * 1e3, plain_lanes=PLAIN_LANES_A1,
                max_abs_err=err, run_rows=rows, peak_device_bytes=peak,
                host_wall_s=wall, setup_s=setup_s,
                stats=[dict(zip(A1_STATS, v)) for v in per_group],
                phase_s=phase_s), st


# -- the native single-core baseline -------------------------------------------


def host_cpu() -> str:
    """The host CPU's model (``/proc/cpuinfo``'s "model name", else
    ``lscpu``'s "Model name", else "not reported"), its architecture and
    its core count."""
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.split(":", 1)[0].strip() in ("model name", "Model"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if not model:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            model = next((ln.split(":", 1)[1].strip()
                          for ln in out.splitlines()
                          if ln.startswith("Model name")), None)
        except (OSError, subprocess.SubprocessError):
            model = None
    return (f"{model or 'model not reported'}, {platform.machine()}, "
            f"{os.cpu_count()} cores (os.cpu_count())")


def baseline_samples(fn, reps: int):
    """``bench.py``'s ``_baseline_samples``: the 1-minute load average
    (warned about above half the cores), then ``reps`` timed runs of
    ``fn``. Returns (median seconds, samples, load average, last result)."""
    load = os.getloadavg()[0]
    if load > (os.cpu_count() or 1) * 0.5:
        log(f"WARNING: loadavg {load:.2f} on {os.cpu_count()} CPUs while "
            f"measuring the CPU baseline")
    samples, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples), samples, load, out


def baseline_phase(cells):
    """The native single-core baseline, with no child process running:
    each cell's native replay (``fn``) timed as ``bench.py`` times it, its
    last result checked (``check``), its rate, samples, load average and
    the host CPU printed. ``cells``: (label, fn, ops, unit, check, reps).
    Returns {label: numbers}."""
    cpu = host_cpu()
    out = {}
    for label, fn, n_ops, unit, check, reps in cells:
        med, samples, load, result = baseline_samples(fn, reps)
        ok = check(result)
        rate = n_ops / med
        log(f"native {label}: median {med * 1e3:.3f} ms of {reps} "
            f"({[round(s * 1e3, 3) for s in samples]} ms), {rate:.6g} "
            f"{unit}/s ({n_ops} {unit}); text ok {ok}; loadavg 1m "
            f"{load:.2f}; on {cpu}")
        if not ok:
            raise AssertionError(f"native {label}: the result differs")
        out[label] = dict(median_s=med, samples_s=samples, ops=n_ops,
                          unit=unit, ops_per_s=rate, loadavg_1m=load,
                          samples_ops_per_s=[n_ops / s for s in samples],
                          cpu=cpu)
    return out


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


def burst_ops(B, randedit, np):
    """Backwards insert bursts of two documents, fused W = 5 rows a step."""
    bursts = B.stack_ops([B.compile_local_patches(
        randedit.prepend_bursts(np.random.default_rng(s), 12)[0], lmax=16,
        dmax=None, fuse_w=5)[0] for s in (3, 4)])
    if B.fused_width(bursts) <= 2:
        raise AssertionError("the burst streams must fuse wider than 2")
    return bursts


def lanes_cases(B, randedit, common, Patch, ListCRDT, export, np):
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
        ("two-peer merges, K = 2,048", lanes(two_peer(3)), 4096,
         dict(capacity=4096, block_k=2048), None),
        ("two-peer merges, K = 4,096", lanes(two_peer(3)), 8192,
         dict(capacity=8192, block_k=4096), None),
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
        # The splices of W = 5 bursts wrap past 16 rows: err[0], the
        # inserts still land, `rows` passes the capacity.
        ("W = 5 bursts wrap 16 rows -> err[0]", burst_ops(B, randedit, np),
         16, dict(capacity=16, block_k=16), 0),
        # 32,768 rows a document do not fit a thread block's shared
        # memory: the un-blocked kernel keeps the first 29,056 there.
        ("32,768-row columns (29,056 rows in shared memory), K = 1,024",
         mixed, 32768, dict(capacity=32768, block_k=1024), None),
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


def doc_subset(stream, B, s5, stride: int, lo: int = 0, hi=None):
    """The 5r stream cut to every ``stride``-th document (the ``lo``-th to
    the ``hi``-th of those), at the same per-document shapes and steps:
    what a plain chain runs on. The documents' txns and texts are left
    out: a child process gets the cut."""
    n = len(range(0, s5.n_docs, stride)[lo:hi])
    return stream.Stream5r(**{
        **vars(s5), "n_docs": n, "all_txns": [], "contents": [],
        "stacked": [B.OpTensors(**{k: v[:, ::stride][:, lo:hi]
                                   for k, v in vars(st).items()})
                    for st in s5.stacked]})


def plain_5r_shard(engine: str, sub):
    """Runs in a child process, on the CPU: the plain chain of the 5r
    engine ``engine`` (``"blocked"``: A7, ``"unblocked"``: A6) over the
    document shard ``sub`` (``doc_subset``), one thread. Returns every
    chunk's outputs as numpy arrays and the seconds."""
    import torch

    from text_crdt_rust_tpu_torch import stream
    from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as RLM

    torch.set_num_threads(1)
    plain = (RLM.lanes_mixed_blocked_replay_plain if engine == "blocked"
             else RLM.lanes_mixed_replay_plain)
    t0 = time.perf_counter()
    outs = chain(plain, stream.make_stream_replayers(
        sub, engine=engine, device="cpu"), lambda o: o[2:-1])
    secs = time.perf_counter() - t0
    return [[t.numpy() for t in o] for o in outs], secs


def start_5r_shards(pool, stream, B, s5, engine: str, stride: int):
    """The plain chain of ``engine`` on every ``stride``-th document, cut
    into ``SHARDS_5R`` shards of neighbouring documents, started in
    ``pool``. Returns ``(documents, [(first, async result), ...])``."""
    n = len(range(0, s5.n_docs, stride))
    per = -(-n // SHARDS_5R)
    return n, [(lo, pool.apply_async(plain_5r_shard, (
        engine, doc_subset(stream, B, s5, stride, lo, lo + per))))
        for lo in range(0, n, per)]


def check_5r_shards(torch, label, shards, kern_sub, names):
    """Each shard's plain chain against the kernel chain's outputs on the
    same documents (``kern_sub``: every chunk's outputs on the strided
    documents, on the CPU), bit for bit. Returns the worst difference and
    the shards' seconds."""
    n, parts = shards
    worst, secs, covered = 0, [], 0
    for lo, res in parts:
        outs, s = res.get()
        m = outs[0][0].shape[1]
        e = max(worst_err([t[:, lo:lo + m] for t in k],
                          [torch.from_numpy(x) for x in p], names)
                for k, p in zip(kern_sub, outs))
        log(f"{label}: shard of documents {lo}-{lo + m - 1} (of {n}): "
            f"plain chain {s:.1f} s in its child process, max_abs_err {e}")
        worst, covered = max(worst, e), covered + m
        secs.append(s)
    if covered != n:
        raise AssertionError(f"{label}: the shards cover {covered} of {n} "
                             f"documents")
    return worst, secs


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
    bursts = burst_ops(B, randedit, np)
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
        ("W = 5 bursts wrap 16 rows -> err[0]", bursts, 16,
         dict(capacity=16, block_k=16), 0),
        ("32,768-row columns (29,056 rows in shared memory), K = 1,024",
         divergent(7, docs=4), 32768, dict(capacity=32768, block_k=1024),
         None),
        ("K = 2,048", divergent(9, docs=5), 4096,
         dict(capacity=4096, block_k=2048), None),
        ("K = 4,096", divergent(10, docs=3), 8192,
         dict(capacity=8192, block_k=4096), None),
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


def unblocked_edges(torch, dev, mixed, RL, RLM, stream):
    """The un-blocked kernel's own edge cases against its plain version,
    bit for bit: chunk 2 of a small stream from a warm start whose
    documents keep their last two rows past ``rows`` (nonzero rows past
    the rows in use; for A6 a 5r stream and a local one), and 11
    documents at 1, 2, 4 and 8 documents a thread block, with the columns
    in shared memory (the wrapper's choice), in device memory from the
    start (``rows_on_chip=0``) and in a window of rows that half of them
    outgrow mid-launch. Returns the worst difference."""
    name = "A6" if mixed else "A4"
    kern = RLM.lanes_mixed_replay_cuda if mixed else RL.lanes_replay_cuda
    plain = RLM.lanes_mixed_replay_plain if mixed else RL.lanes_replay_plain
    names = A6_OUTPUTS if mixed else A4_OUTPUTS
    n_stats = RLM.STATS if mixed else RL.STATS
    s5 = stream.make_stream_5(n_docs=4, chunks=2, steps_per_chunk=50,
                              seed_base=500)
    local = (stream.stream_replayers_5(s5, engine="unblocked", device=dev)
             if not mixed else
             [RLM.make_replayer_lanes_mixed(st, capacity=cap, chunk=16,
                                            order_capacity=2048, device=dev)
              for st, cap in zip(s5.stacked,
                                 stream.stream_capacities_5(s5))])
    streams = [("config-5 stream", local)]
    if mixed:
        streams.append(("5r stream", stream.make_stream_replayers(
            stream.make_stream_5r(n_docs=3, chunks=2, steps_per_chunk=40,
                                  seed_base=900),
            engine="unblocked", device=dev)))
    worst = 0
    for label, (warm, run) in streams:
        state = list(plain(*warm.staged, *warm.initial(),
                           *getattr(warm, "deltas", ()),
                           **warm.shape)[2:-1])
        state[2] = torch.clamp(state[2] - 2, min=0)
        ini = run.grow(tuple(state))
        args = (*run.staged, *ini, *getattr(run, "deltas", ()))
        stats = torch.zeros(ini[0].shape[1], n_stats, dtype=torch.int64,
                            device=dev)
        k = kern(*args, **run.shape, stats=stats)
        torch.cuda.synchronize()
        e = worst_err(k, plain(*args, **run.shape), names)
        stale = int((stats[:, 0] > ini[2][0].long()).sum())
        worst = max(worst, e)
        log(f"compare {name} rows past rows ({label}, chunk 2 of 2): "
            f"{stale} of {ini[0].shape[1]} documents start with nonzero "
            f"rows past rows; extents {stats[:, 0].tolist()} -> "
            f"{stats[:, 1].tolist()}; max_abs_err {e}, "
            f"{'ok' if e == 0 and stale > 0 else 'FAILED'}")
        if e != 0 or stale == 0:
            raise AssertionError(f"{name} disagrees with rows past rows")
    if mixed:
        ops = stream.make_stream_5r(n_docs=11, chunks=1, steps_per_chunk=40,
                                    seed_base=920).stacked[0]
        run = RLM.make_replayer_lanes_mixed(ops, capacity=512, chunk=16,
                                            device=dev)
    else:
        ops = stream.make_stream_5(n_docs=11, chunks=1, steps_per_chunk=50,
                                   seed_base=520).stacked[0]
        run = RL.make_replayer_lanes(ops, capacity=512, chunk=16, device=dev)
    args = (*run.staged, *run.initial(), *getattr(run, "deltas", ()))
    want = plain(*args, **run.shape)
    stats = torch.zeros(11, n_stats, dtype=torch.int64, device=dev)
    kern(*args, **run.shape, stats=stats)
    torch.cuda.synchronize()
    # A window of rows that half the columns outgrow mid-launch.
    window = sorted(stats[:, 1].tolist())[5]
    for warps in (1, 2, 4, 8):
        for rows in (None, 0, window):
            stats.zero_()
            k = kern(*args, **run.shape, warps=warps, rows_on_chip=rows,
                     stats=stats)
            torch.cuda.synchronize()
            e = worst_err(k, want, names)
            worst = max(worst, e)
            ends = stats[:, 1].tolist()
            flags = stats[:, -1].tolist()
            on_chip = sum(flags)
            geo = RL.launch_geometry("rle_lanes_mixed" if mixed
                                     else "rle_lanes", 11, run.capacity,
                                     warps, dev, rows)
            # A column moves before a step that could pass the window, so
            # one that ends in shared memory ends within it.
            ok = e == 0 and (
                on_chip == 11 if rows is None else
                on_chip == 0 if rows == 0 else
                on_chip < 11 and all(x <= rows for x, f in zip(ends, flags)
                                     if f))
            log(f"compare {name} at {warps} documents a thread block, "
                f"{geo}: extents {sorted(ends)}, {on_chip} of 11 columns "
                f"end in shared memory; max_abs_err {e}, "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise AssertionError(f"{name} disagrees at {warps} warps, "
                                     f"{rows} rows on chip")
    return worst


def lanes_sweep(torch, dev, RL, kern, runners, kernel, n_docs, label):
    """At a main path's shapes: each document's counters on the chain's
    last chunk (the column's extent; for A6 the YATA probes per remote
    insert), the chain's median at 1, 2, 4 and 8 documents a thread
    block with the last chunk's launch geometry, and the wrapper's
    choice. Returns them for the kernels line."""
    import sys as _sys

    n_stats = _sys.modules[kern.__module__].STATS
    stats = torch.zeros(n_docs, n_stats, dtype=torch.int64, device=dev)
    last = runners[-1]
    state = None
    for run in runners:
        ini = run.initial() if state is None else run.grow(state)
        kw = dict(stats=stats) if run is last else {}
        state = kern(*run.staged, *ini, *getattr(run, "deltas", ()),
                     **run.shape, **kw)[2:-1]
    torch.cuda.synchronize()
    out = dict(extent_mean=float(stats[:, 1].float().mean()),
               extent_most=int(stats[:, 1].max()),
               capacity=last.capacity,
               columns_on_chip=int(stats[:, -1].sum()))
    msg = (f"{label}: last chunk (capacity {last.capacity}): the columns' "
           f"extent at its end mean {out['extent_mean']:.1f}, most "
           f"{out['extent_most']} rows; {out['columns_on_chip']} of "
           f"{n_docs} columns end in shared memory")
    if n_stats >= 5:
        ins, probes = int(stats[:, 2].sum()), int(stats[:, 3].sum())
        out.update(remote_inserts=ins,
                   probes_mean=probes / max(ins, 1),
                   probes_most=int(stats[:, 4].max()))
        msg += (f"; {ins} remote inserts, {out['probes_mean']:.3f} YATA "
                f"probes an insert on average, {out['probes_most']} at most")
    log(msg)
    times = {}
    for warps in (1, 2, 4, 8):
        times[warps] = cuda_ms(torch, lambda: chain(
            lambda *a, **k: kern(*a, **k, warps=warps), runners,
            lambda o: o[2:-1]), reps=3)
        geo = RL.launch_geometry(kernel, n_docs, last.capacity, warps, dev)
        log(f"{label}: {warps} documents a thread block: median "
            f"{times[warps]:.3f} ms; last chunk {geo}")
    choice = RL.WARPS
    geo = RL.launch_geometry(kernel, n_docs, last.capacity, choice, dev)
    log(f"{label}: the wrapper's choice: {choice} document a thread block "
        f"(rle_lanes.WARPS: residency per SM is set by the columns' "
        f"shared memory whatever their grouping) and "
        f"{geo['rows_on_chip']} rows of each column in shared memory "
        f"(rle_lanes.pick_rows_on_chip: all rows where every document "
        f"then fits the card at once, else the share that does), "
        f"{geo['waves']} wave(s) of {geo['blocks_per_sm']} blocks an SM "
        f"at the last chunk")
    out.update(warps_ms={str(w): t for w, t in times.items()},
               warps=choice, waves=geo["waves"],
               blocks_per_sm=geo["blocks_per_sm"],
               rows_on_chip=geo["rows_on_chip"])
    return out


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
        # A5 with each document's rows in shared memory and in device
        # memory (where they fit a thread block; else device memory only).
        fits = RL.blocked_on_chip(r5.capacity, r5.nbt)
        k5s = [RL.lanes_blocked_replay_cuda(*r5.staged, *r5.initial(),
                                            **r5.shape, on_chip=on)
               for on in ((True, False) if fits else (False,))]
        k5 = k5s[-1]
        torch.cuda.synchronize()
        e4 = worst_err(k4, RL.lanes_replay_plain(
            *r4.staged, *r4.initial(), **r4.shape), A4_OUTPUTS)
        p5 = RL.lanes_blocked_replay_plain(*r5.staged, *r5.initial(),
                                           **r5.shape)
        e5 = max(worst_err(k, p5, A5_OUTPUTS) for k in k5s)
        a4_worst, a5_worst = max(a4_worst, e4), max(a5_worst, e5)
        f4 = k4[-1][:2].amax(dim=1).tolist()
        f5 = k5[-1][:2].amax(dim=1).tolist()
        flags_ok = (f4 == f5 == [0, 0] if expect is None
                    else f4[expect] == f5[expect] == 1)
        ok = e4 == 0 and e5 == 0 and flags_ok
        log(f"compare local lanes {label}: {ops.num_steps} steps x "
            f"{ops.kind.shape[1]} docs, SHARED_CUM {r4.shape['shared_cum']}, "
            f"blocks in use {int(k5[4].max())}, max_abs_err un-blocked {e4} "
            f"blocked {e5} (rows in {'shared and device' if fits else 'device'}"
            f" memory), err flags {f4} {f5}, {'ok' if ok else 'FAILED'}")
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
    # The counters over the chain, the launch geometry, and the chain with
    # the rows in shared memory and in device memory.
    a5_stats = torch.zeros(RL.BLOCKED_STATS, dtype=torch.int64, device=dev)
    state = None
    for run in runners5:
        ini = run.initial() if state is None else run.grow(state)
        st = torch.zeros(s5.n_docs, RL.BLOCKED_STATS, dtype=torch.int64,
                         device=dev)
        state = RL.lanes_blocked_replay_cuda(*run.staged, *ini, **run.shape,
                                             stats=st)[2:-1]
        a5_stats += st.sum(dim=0)
    a5_stats = [int(v) for v in a5_stats]
    last5 = runners5[-1]
    placed = {}
    for on in (True, False):
        placed[on] = cuda_ms(torch, lambda: chain(
            lambda *a, **k: RL.lanes_blocked_replay_cuda(*a, **k,
                                                         on_chip=on),
            runners5, lambda o: o[2:-1]), reps=3)
    a5_geometry = RL.blocked_geometry(
        s5.n_docs, last5.capacity, last5.nbt, RL.BLOCKED_WARPS,
        RL.blocked_on_chip(last5.capacity, last5.nbt), dev)
    log(f"5 blocked chain counters (all documents and launches): "
        f"{RL.describe_blocked_stats(a5_stats)}; last chunk's launch "
        f"geometry {a5_geometry}; median with the rows in shared memory "
        f"{placed[True]:.3f} ms, in device memory {placed[False]:.3f} ms")
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
        f"{ops5} ops: {bb5:.4f} ms by bytes, {bo5:.4f} ms by operations); "
        f"on {card}")

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
        f"patches/s; {ms4 * 1e3 / sum(s5.real_steps):.3f} us a real step; "
        f"plain chain {plain4_ms:.1f} ms; bound {max(bb4, bo4):.4f} ms "
        f"({bb4:.4f} ms by bytes, {bo4:.4f} ms by operations); on {card}")
    sweep4 = lanes_sweep(torch, dev, RL, RL.lanes_replay_cuda, runners4,
                         "rle_lanes", s5.n_docs, "5 un-blocked chain")

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
        "bound_bytes_ms": bb4,
        "bound_ops_ms": bo4,
        "library_ms": None,
        "bytes": bytes4,
        "ops_lower_bound": ops4,
        **sweep4,
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
        "bound_bytes_ms": bb5,
        "bound_ops_ms": bo5,
        "library_ms": None,
        "bytes": bytes5,
        "ops_lower_bound": ops5,
        "stats": dict(zip((
            "steps", "deletes", "delete_iterations", "inserts", "splits",
            "block_copies", "head_reads", "cycles_slot_locates",
            "cycles_block_copies", "cycles_delete_passes",
            "cycles_insert_splices", "cycles_table_upkeep",
            "cycles_splits", "cycles_all", "blocks_in_use",
            "docs_on_chip"), a5_stats)),
        "geometry": a5_geometry,
        "ms_rows_in_shared_memory": placed[True],
        "ms_rows_in_device_memory": placed[False],
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
KEVIN_PLAIN_LANES = 8          # the plain check's documents (kevin's 128
#                                replay one stream alike)


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
        ("kevin prepends W=64, K=4096 (splits)", [prepends(20000, 64)],
         dict(capacity=65536, block_k=4096, batch=16), None),
        ("block table full -> err[0]",
         [B.compile_local_patches([TestPatch(0, 0, "ab")] * 40, lmax=2)[0]],
         dict(capacity=16, block_k=8), 0),
        ("delete past the end -> err[1]",
         [B.compile_local_patches([TestPatch(0, 0, "abc"),
                                   TestPatch(0, 10, "")], lmax=4)[0]],
         dict(capacity=32, block_k=8), 1),
        # The window ring: splices and delete splits on both sides of a
        # block's middle, and full tables whose W-row prepends splice on
        # past K rows (the rows wrap) with err row 0 raised.
        ("ring: mid-block splices on both sides, K=64",
         [merged(randedit.random_patches(rng(21), 600)[0])],
         dict(capacity=64 * 64, block_k=64), None),
        ("ring: full table, W=3 prepends wrap, K=8 -> err[0]",
         [prepends(300, 3)], dict(capacity=16, block_k=8), 0),
        ("ring: full table, W=7 prepends wrap, K=16 -> err[0]",
         [prepends(700, 7)], dict(capacity=32, block_k=16), 0),
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


def plain_kevin(lanes: int):
    """Runs in a child process, on the CPU: A2's plain version on all of
    kevin's prepends at its geometry (K, capacity, W; origins kept) on
    ``lanes`` documents. Returns the staged columns, the outputs and the
    seconds, as numpy arrays."""
    import torch

    from text_crdt_rust_tpu_torch import kevin
    from text_crdt_rust_tpu_torch.ops import rle_hbm as TH

    torch.set_num_threads(1)
    ks = kevin.compile_kevin(KEVIN_N, 64)
    rep = kevin.make_kevin_replayer(ks, batch=lanes, store_origins=True,
                                    device="cpu")
    t0 = time.perf_counter()
    outs = TH.rle_hbm_replay_plain(*rep.staged, **rep.shape)
    secs = time.perf_counter() - t0
    return ([c.numpy() for c in rep.staged], [o.numpy() for o in outs],
            secs)


def hbm_phase(torch, dev, card, B, R, TH, kevin, northstar, randedit,
              TestPatch, np, _kernels, plain_kevin_async):
    """A2: the small cases, kevin at 5M prepends through ``run_kevin()``
    (counted), the plain check at kevin's geometry (its plain half from
    ``plain_kevin`` in a child process), and the north star on A2 through
    ``run_northstar(engine="rle-hbm")`` (counted), against its plain
    version and A1. Returns the ``kernels`` entry."""
    worst = 0
    for label, streams, kw, expect in hbm_compare_cases(B, randedit,
                                                        TestPatch, np):
        kw.setdefault("batch", 32)
        rep = TH.make_replayer_rle_hbm(streams, device=dev, chunk=128, **kw)
        plain = TH.rle_hbm_replay_plain(*rep.staged, **rep.shape)
        G, Bn = rep.shape["groups"], rep.shape["batch"]
        stats = torch.zeros(G, Bn, TH.STATS, dtype=torch.int64, device=dev)
        kern = TH.rle_hbm_replay_cuda(*rep.staged, **rep.shape, stats=stats)
        torch.cuda.synchronize()
        err = max_abs_err(kern, plain)
        worst = max(worst, err)
        flags = kern[7][:2].amax(dim=1).tolist()
        flags_ok = flags == [0, 0] if expect is None else flags[expect] == 1
        ok = err == 0 and flags_ok
        log(f"compare hbm {label}: {[s.num_steps for s in streams]} steps, "
            f"blocks in use {kern[6][:, 0, 0].tolist()}, splits and window "
            f"loads per group {stats[:, 0, :2].tolist()}, "
            f"{TH.pick_warps(G * Bn, dev)} warps, max_abs_err {err}, "
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
        f"bound {max(bb, bo):.4f} ms ({nbytes} B, {nops} ops: "
        f"{bb:.4f} ms by bytes, {bo:.4f} ms by operations); on {card}")
    kwarps = hbm_warps(torch, dev, TH, rep, "kevin", active)
    del rep

    # -- the plain check at kevin's geometry ----------------------------------
    prep = kevin.make_kevin_replayer(ks, batch=KEVIN_PLAIN_LANES,
                                     store_origins=True, device=dev)
    cols_np, plain_np, plain_s = plain_kevin_async.get()
    if not same_inputs(torch, prep.staged, cols_np):
        raise AssertionError("the kevin plain check's child compiled "
                             "other inputs")
    kern = TH.rle_hbm_replay_cuda(*prep.staged, **prep.shape)
    plain = [torch.from_numpy(a).to(dev) for a in plain_np]
    del plain_np
    kplain_ms = plain_s * 1e3
    e = max_abs_err(kern, plain)
    worst = max(worst, e)
    log(f"compare kevin geometry: all {ks.n} prepends ({ks.steps} "
        f"steps, K={prep.shape['block_k']}, W=64, B={KEVIN_PLAIN_LANES} of "
        f"the run's 128 identical documents, capacity "
        f"{prep.shape['capacity']}, "
        f"origins kept): max_abs_err {e} on all eight outputs, blocks in "
        f"use {int(kern[6][0, 0, 0])}; plain version {kplain_ms:.1f} ms "
        f"(CPU, one core, in a child process)")
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
        f"steps, {nms / nact * 1e3:.3f} us a step; plain version "
        f"{nplain_ms:.1f} ms; bound {max(nbb, nbo):.4f} ms ({nb2} B, {no2} "
        f"ops: {nbb:.4f} ms by bytes, {nbo:.4f} ms by operations); on "
        f"{card}")
    nwarps = hbm_warps(torch, dev, TH, nrep, "north star on A2", nact)
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
        "plain_where": f"CPU, one core, {KEVIN_PLAIN_LANES} lanes",
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
        "warps": {"kevin": kwarps, "northstar": nwarps},
    }


def hbm_warps(torch, dev, TH, rep, label, steps):
    """A2 at ``label``'s shape: its splits, window loads and share of
    cycles in splits (``stats``), its median at 1, 2, 4, 8 and 16 warps a
    thread block and the wrapper's choice. Returns the choice and times."""
    G, Bn = rep.shape["groups"], rep.shape["batch"]
    stats = torch.zeros(G, Bn, TH.STATS, dtype=torch.int64, device=dev)
    TH.rle_hbm_replay_cuda(*rep.staged, **rep.shape, stats=stats)
    torch.cuda.synchronize()
    splits, loads, sc, tc = (int(v) for v in stats[0, 0])
    log(f"{label}: {splits} splits and {loads} window loads a lane; "
        f"{sc / max(tc, 1):.4f} of the chain's {tc} cycles in splits "
        f"({sc / max(splits, 1):.0f} cycles a split, clock64)")
    times = {}
    for warps in (1, 2, 4, 8, 16):
        times[warps] = cuda_ms(torch, lambda: TH.rle_hbm_replay_cuda(
            *rep.staged, **rep.shape, warps=warps), reps=3)
        log(f"{label}: {warps} warps ({32 * warps} threads) a thread block, "
            f"median {times[warps]:.3f} ms, "
            f"{times[warps] / steps * 1e3:.3f} us a step")
    choice = TH.pick_warps(G * Bn, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"{label}: the wrapper picks {choice} warps: {G * Bn} chains on "
        f"{sms} SMs ({'one chain an SM, the helper warps cost no residency' if G * Bn <= sms else 'chains share SMs, one warp each'}); "
        f"fastest measured {min(times, key=times.get)} warps")
    return {"choice": choice, "ms_by_warps": times, "splits": splits,
            "window_loads": loads, "split_cycle_share": sc / max(tc, 1)}


# -- the per-character block replays: A8, A9 and A10 -------------------------

CHAR_LANES = 128             # documents of the three per-character paths
PREFIX_A8 = 19_149           # the largest prefix bench.py sizes to 32,768 rows
TRACE_A9 = None              # the whole trace (259,778 patches)
STORM_ROUNDS = 200           # the config-4 insert storm: 16 peers x 200
PLAIN_LANES_A9 = 8           # A9's full-trace plain check: lanes
# A10's serial rule per scan step: other == o_right, olc < lc, olc == lc,
# rank > rank, o_right == right, and the scanning/scan_start updates.
OPS_PER_SCAN_STEP = 8
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


def char_err(torch, kern, plain, lanes=None, names=None) -> int:
    """Largest absolute difference between a kernel's outputs (lanes
    ``[:lanes]`` when given) and its plain version's (tensors or numpy
    arrays), output by output (``names``, by default the per-character
    replays'); 0 = bit-identical."""
    worst = 0
    names = CHAR_OUTPUTS if names is None else names
    if len(kern) != len(names) or len(plain) != len(names):
        raise AssertionError(f"expected {len(names)} outputs")
    for name, k, p in zip(names, kern, plain):
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
        ("far jumps, K=32", [chars(far_jump_patches(TestPatch), 16)], 8192,
         32, [0, 0, 0]),
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
        ("random, lmax 16, K=2,048", [chars(randedit.random_patches(
            random.Random(9), 600)[0], 16)], 8192, 2048, [0, 0, 0]),
        ("random, lmax 16, K=4,096", [chars(randedit.random_patches(
            random.Random(10), 600)[0], 16)], 8192, 4096, [0, 0, 0]),
    ]


def far_jump_patches(TestPatch, n=300):
    """2,048 characters typed, then single-character edits whose positions
    jump across the document: nearly every step leaves the A9 kernel's
    cache of blocks."""
    patches = [TestPatch(16 * i, 0, "x" * 16) for i in range(128)]
    size = 2048
    for i in range(n):
        at = (i * 7919) % size
        if i % 3 == 2:
            patches.append(TestPatch(at, 1, ""))
            size -= 1
        else:
            patches.append(TestPatch(at, 0, "y"))
            size += 1
    return patches


def hbm_char_cases(B, randedit):
    """A9's own cases beside ``char_compare_cases``: three doc groups and
    K = 2,048, which A8 refuses."""
    import random

    def rnd(seed, steps, lmax=4):
        patches = randedit.random_patches(random.Random(seed), steps)[0]
        return B.compile_local_patches(patches, lmax=lmax, dmax=lmax)[0]

    return [
        ("three groups, K=16", [rnd(s, 60 + 20 * s) for s in range(3)],
         1024, 16, [0, 0, 0]),
        ("random, lmax 16, K=2048", [rnd(3, 300, 16)], 8192, 2048,
         [0, 0, 0]),
    ]


def absent_left_in_scan(oll):
    """Two orders' origin-left entries set to orders no item has (one past
    the table, one inside it): the scans passing those items take the
    serial step with the search of the whole state (err row 2)."""
    oll[5] = 70000
    oll[9] = 100


def tie_run_ops(storm):
    """40 concurrent inserts at ROOT, then three agents that saw only the
    last of them insert before it: their scans pin scan_start and carry it
    past 32 positions (A10's sub-window) to the break."""
    from text_crdt_rust_tpu_torch.common import (
        ROOT_REMOTE_ID,
        RemoteId,
        RemoteIns,
        RemoteTxn,
    )

    peers = [f"p{i:02d}" for i in range(40)]
    txns = [RemoteTxn(id=RemoteId(n, 0), parents=[],
                      ops=[RemoteIns(ROOT_REMOTE_ID, ROOT_REMOTE_ID, "x")])
            for n in peers]
    last = RemoteId(peers[-1], 0)
    txns += [RemoteTxn(id=RemoteId(n, 0), parents=[last],
                       ops=[RemoteIns(ROOT_REMOTE_ID, last, "y")])
             for n in ("a", "p20x", "p35x")]
    return storm.compile_storm_txns(txns, 1, 0.0)


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
    absent = {f.name: np.asarray(getattr(small, f.name)).copy()
              for f in dataclasses.fields(small)}
    last = int(np.nonzero(absent["kind"] == B.KIND_REMOTE_INS)[0][-1])
    absent["origin_left"][last] = 60
    return [
        ("storm 4x10, K=16", stormops(4, 10, 2, 0.0), 256, 16, [0, 0, 0],
         None),
        ("storm 16x20, K=32", stormops(16, 20, 4, 0.0), 4096, 32,
         [0, 0, 0], None),
        ("delete storm 6x20, K=16", stormops(6, 20, 3, 0.3), 1024, 16,
         [0, 0, 0], None),
        ("ties: storm 40x3, K=16", stormops(40, 3, 1, 0.0), 512, 16,
         [0, 0, 0], None),
        ("ties: storm 48x4, K=32", stormops(48, 4, 2, 0.0), 1024, 32,
         [0, 0, 0], None),
        ("tie runs pinned past 32 positions, K=16", tie_run_ops(storm), 256,
         16, [0, 0, 0], None),
        ("storm 8x20, K=2048", stormops(8, 20, 4, 0.0), 4096, 2048,
         [0, 0, 0], None),
        ("storm 8x20, K=4096", stormops(8, 20, 4, 0.0), 8192, 4096,
         [0, 0, 0], None),
        ("storm 4x10, capacity 49,152: the view in device memory",
         stormops(4, 10, 2, 0.0), 49152, 256, [0, 0, 0], None),
        ("unknown delete target -> err[1], err[2]", B.OpTensors(**fields),
         256, 16, [0, 1, 1], None),
        ("insert after an absent order -> err[2]", B.OpTensors(**absent),
         256, 16, [0, 0, 1], None),
        ("absent origin-left inside the scan -> err[2]",
         stormops(4, 10, 2, 0.0), 256, 16, [0, 0, 1], absent_left_in_scan),
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
        "design": "follows blocked_ops.cuh, one warp running the step "
                  "chain",
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
    cases = (char_compare_cases(B, randedit, TestPatch, np)
             + hbm_char_cases(B, randedit))
    for label, streams, cap, k, flags in cases:
        rep = TBH.make_replayer_hbm(streams, cap, batch=32, block_k=k,
                                    chunk=128, device=dev)
        plain = TBH.blocked_hbm_replay_plain(*rep.staged, **rep.shape)
        stats = torch.zeros(len(streams), 32, dtype=torch.int32, device=dev)
        kern = TBH.blocked_hbm_replay_cuda(*rep.staged, **rep.shape,
                                           stats=stats)
        torch.cuda.synchronize()
        e = char_err(torch, kern, plain)
        worst = max(worst, e)
        got = kern[4][:3].amax(dim=1).tolist()
        ok = e == 0 and got == flags
        log(f"compare blocked-hbm {label}: "
            f"{[s.num_steps for s in streams]} steps, max_abs_err {e}, err "
            f"flags {got}, cache misses {stats[:, 0].tolist()}, "
            f"{'ok' if ok else 'FAILED'}")
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
    stats = torch.zeros(1, CHAR_LANES, dtype=torch.int32, device=dev)
    TBH.blocked_hbm_replay_cuda(*rep.staged, **rep.shape, stats=stats)
    torch.cuda.synchronize()
    misses = int(stats[0, 0])
    # The thread block's warps: warp 0 runs the chain, and every warp
    # takes part in the rebalances' device-memory passes.
    by_warps = {w: cuda_ms(torch, lambda: TBH.blocked_hbm_replay_cuda(
        *rep.staged, **rep.shape, warps=w), reps=3)
        for w in (1, 2, 4, 8, 16)}
    best = min(by_warps, key=by_warps.get)
    log(f"main path on A9 warps a thread block: " + ", ".join(
        f"{w}: {t:.3f} ms" for w, t in by_warps.items())
        + f"; fastest {best}, the wrapper's choice {TBH.WARPS} (warp 0 runs "
        f"the step chain alone; the other warps only join the rebalance's "
        f"passes over device memory, which more warps keep more loads in "
        f"flight for)")
    ms = by_warps[TBH.WARPS]
    cols, plain, counts, plain_s = plain_async.get()
    if not same_inputs(torch, rep.staged, cols):
        raise AssertionError("A9's plain check compiled other inputs")
    e = char_err(torch, kern, plain, lanes=PLAIN_LANES_A9)
    worst = max(worst, e)
    log(f"compare main path on A9: all {stream.steps} steps, max_abs_err "
        f"{e} against its plain version on lanes 0-{PLAIN_LANES_A9 - 1} "
        f"(plain {plain_s:.1f} s on one CPU core; {counts}); all "
        f"{CHAR_LANES} lanes of the kernel equal lane 0: {equal}; cache "
        f"misses {misses} a lane ({misses / stream.steps:.2%} of the "
        f"steps)")
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
        "cache_misses": misses,
        "warps": TBH.WARPS,
        "ms_by_warps": by_warps,
        "design": "one warp runs the step chain over a cache of four "
                  "blocks in shared memory",
    }


def blocked_a10_phase(torch, dev, card, B, storm, TBL, TBM, np, _kernels,
                      plain_async):
    """A10: the small cases (error rows included), the config-4 insert
    storm through ``run_storm(engine="blocked-mixed")`` (counted), and at
    that shape the main path's outputs against the plain version's over
    the whole storm, and timed. Returns the ``kernels`` entry."""
    worst = 0
    for label, ops, cap, k, flags, edit in mixed_char_cases(B, storm, np):
        rep = TBM.make_replayer_mixed(ops, cap, batch=32, block_k=k,
                                      chunk=128, device=dev)
        if edit is not None:
            oll = rep.staged[9].clone()
            edit(oll)
            rep.staged = rep.staged[:9] + (oll,) + rep.staged[10:]
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
    stats = torch.zeros(2, CHAR_LANES, dtype=torch.int32, device=dev)
    TBM.blocked_mixed_replay_cuda(*rep.staged, **rep.shape, stats=stats)
    torch.cuda.synchronize()
    scan_steps, windows = (int(stats[0, 0]), int(stats[1, 0]))
    same_stats = bool((stats == stats[:, :1]).all())
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
    log(f"storm on A10 scan: {scan_steps} conflict-scan steps and {windows} "
        f"windows of {4 * 32} positions a lane (the plain version counts "
        f"{counts.get('scan_steps')} steps; every lane the same: "
        f"{same_stats}), {ms / scan_steps * 1e3:.5f} us a scan step")
    if scan_steps != counts.get("scan_steps") or not same_stats:
        raise AssertionError("A10's scan steps differ from the plain "
                             "version's count")
    NB = rep.shape["capacity"] // rep.shape["block_k"]
    nbytes, nops, active = char_bound(
        rep.staged, rep.shape, rep.shape["block_k"] + NB, ncols=9,
        table_words=3 * rep.shape["order_rows"] * 128)
    # The conflict scan is this run's data-dependent work: each scan step
    # of each lane makes the serial rule's comparisons.
    nops += scan_steps * CHAR_LANES * OPS_PER_SCAN_STEP
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
        "scan_steps": scan_steps,
        "scan_windows": windows,
        "us_per_scan_step": ms / scan_steps * 1e3,
        "design": "a per-insert view built on the card, one warp "
                  "scanning 128 raw positions a window",
    }


# -- the document server on A7 ------------------------------------------------

SERVE_GOLDEN = os.path.join("tests", "data", "serve_lanes_golden.json")
SERVE_ACCEPTANCE = dict(docs=200, agents_per_doc=3, ticks=60,
                        events_per_tick=48, zipf_alpha=1.1, fault_rate=0.10,
                        local_prob=0.25, seed=7)
SERVE_ACCEPTANCE_CFG = dict(engine="rle-lanes-mixed", num_shards=2,
                            lanes_per_shard=16)
# A server this card would carry: 2,048 resident lanes over 4,096 docs.
# At 1,024 events a tick the default per-doc queue bound (256) livelocks
# the loadgen's final drain on the second-hottest document (its clean
# pull chunk of 128 txns plus its pending txns exceed the bound, and the
# all-or-nothing group is refused every round; the JAX package's logic,
# which the port reproduces); the bound is raised to 1,024 here.
SERVE_WIDE = dict(docs=4096, agents_per_doc=3, ticks=16,
                  events_per_tick=1024, zipf_alpha=1.1, fault_rate=0.10,
                  local_prob=0.25, seed=7)
SERVE_WIDE_CFG = dict(engine="rle-lanes-mixed", num_shards=2,
                      lanes_per_shard=1024, max_queue_per_doc=1024)
SERVE_SAMPLE_EVERY = 8         # every 8th launch of each shard is checked


def plain_serve_launch(inputs, shape):
    """Runs on the CPU (in a child process for the wide shape): A7's plain
    version on one recorded serve launch's inputs (numpy). Returns its
    outputs as numpy arrays and the seconds."""
    import torch

    from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as RLM

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = RLM.lanes_mixed_blocked_replay_plain(
        *[torch.from_numpy(a) for a in inputs], **shape)
    return [o.numpy() for o in out], time.perf_counter() - t0


class ServeLaunches:
    """Stands in for A7's launch wrapper while the server runs: CUDA
    events around every launch (the device time), and with ``keep`` set,
    a copy of each launch's inputs and outputs (taken on the card, in
    stream order: the server edits its state in place afterwards) with
    its shard and its index in that shard."""

    def __init__(self, torch, kernel):
        self.torch, self.kernel = torch, kernel
        self.events, self.kept = [], []
        self.keep = None           # (shard, index) -> keep the launch?
        self.shard = 0
        self.index = {}

    def __call__(self, *args, **shape):
        torch = self.torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.kernel(*args, **shape)
        end.record()
        self.events.append((start, end))
        k = self.index.get(self.shard, 0)
        self.index[self.shard] = k + 1
        if self.keep is not None and self.keep(args, k):
            self.kept.append(dict(
                shard=self.shard, index=k, shape=dict(shape),
                inputs=[a.clone() for a in args],
                outputs=[o.clone() for o in out]))
        return out

    def take(self):
        """(device ms summed over the launches since the last take, their
        count, the kept launches); resets."""
        self.torch.cuda.synchronize()
        ms = sum(s.elapsed_time(e) for s, e in self.events)
        out = (ms, len(self.events), self.kept)
        self.events, self.kept, self.index = [], [], {}
        return out


def serve_run(torch, ServeConfig, ServeLoadGen, launches, params, cfg_kw,
              depth, keep, dev):
    """One counted ServeLoadGen run on the card (the caller's clock:
    ``time.perf_counter``); returns the generator, its report and the
    host wall."""
    cfg = ServeConfig(pipeline_ticks=depth, trace_keep=True, **cfg_kw)
    launches.keep = keep
    gen = ServeLoadGen(cfg=cfg, device=dev, clock=time.perf_counter,
                       **params)
    for i, b in enumerate(gen.server.residency.backends):
        def apply(stacked, orig=b.apply, i=i):
            launches.shard = i
            orig(stacked)
        b.apply = apply
    t0 = time.perf_counter()
    report = gen.run()
    torch.cuda.synchronize()
    return gen, report, time.perf_counter() - t0


def serve_record(gen, report, logical_report, hashlib):
    """The golden record's fields of a run (as
    ``tests/data/make_serve_golden.py`` writes them)."""
    docs = {w.doc_id: [gen.server.doc_string(w.doc_id),
                       int(gen.server.doc_digest(w.doc_id))]
            for w in gen.worlds}
    trace = gen.server.tracer.logical_bytes()
    return {"logical": logical_report(report), "docs": docs,
            "trace_sha256": hashlib.sha256(trace).hexdigest(),
            "trace_events": trace.count(b"\n")}


def serve_numbers(torch, gen, report, wall, ms, n, launches, label, card):
    """Logs a serve run's numbers (all on ``card``) and returns them."""
    b0 = gen.server.residency.backends
    tick = report["tick_ms"]
    srv = report["server"]
    out = dict(
        host_wall_s=wall, ticks=tick["samples"], tick_ms_p50=tick["p50"],
        tick_ms_p99=tick["p99"], a7_device_ms=ms, a7_launches=n,
        kernel_launches=launches, item_ops=report["item_ops_applied"],
        item_ops_per_s=report["ops_per_sec"],
        evictions=srv.get("evictions", 0), restores=srv.get("restores", 0),
        lane_writes=sum(b.lane_writes for b in b0),
        lane_uploads=srv.get("lane_uploads", 0),
        overlap_frac=report["pipeline"]["overlap_frac"],
        stall_ms=report["pipeline"]["stall_ms_total"],
        rejected=report["rejected_submissions"],
        shapes_seen=sorted(set().union(*(b.shapes_seen for b in b0))),
        peak_device_bytes=torch.cuda.max_memory_allocated())
    log(f"serve {label}: converged {report['converged']}; host wall "
        f"{wall:.2f} s over {out['ticks']} ticks (tick ms p50 "
        f"{out['tick_ms_p50']}, p99 {out['tick_ms_p99']}, caller's clock); "
        f"A7 {n} launches, {ms:.3f} ms on the card (CUDA events, summed); "
        f"{out['item_ops']} item-ops, {out['item_ops_per_s']} item-ops/s; "
        f"evictions {out['evictions']}, restores {out['restores']}, lane "
        f"writes {out['lane_writes']} (uploads {out['lane_uploads']}); "
        f"pipeline depth {report['pipeline']['ticks']}: overlap_frac "
        f"{out['overlap_frac']}, stall {out['stall_ms']} ms; rejected "
        f"submissions {out['rejected']}; shapes {out['shapes_seen']}; "
        f"launches {launches}; peak device memory "
        f"{out['peak_device_bytes'] / 2**20:.1f} MiB; on {card}")
    return out


def serve_phase(torch, dev, card, _kernels, RLM, np, pool):
    """The document server (``serve/``) on A7: the acceptance shape at
    pipeline depths 1 and 2 against the JAX package's golden record, the
    wide shape, and A7 against its plain version on sampled serve
    launches. Returns the A7 line's serve fields and the wide shape's
    pending plain checks."""
    import hashlib

    from text_crdt_rust_tpu_torch.config import ServeConfig
    from text_crdt_rust_tpu_torch.serve.loadgen import (
        ServeLoadGen,
        logical_report,
    )

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, SERVE_GOLDEN)) as f:
        golden = json.load(f)
    if (golden["params"] != SERVE_ACCEPTANCE
            or golden["cfg"] != SERVE_ACCEPTANCE_CFG):
        raise AssertionError("the golden record is of another shape")
    launches = ServeLaunches(torch, RLM.lanes_mixed_blocked_replay_cuda)
    RLM.lanes_mixed_blocked_replay_cuda = launches
    runs, kept_acc = {}, []
    try:
        for depth in (1, 2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launches()
            gen, report, wall = serve_run(
                torch, ServeConfig, ServeLoadGen, launches,
                SERVE_ACCEPTANCE, SERVE_ACCEPTANCE_CFG, depth,
                (lambda args, k: True) if depth == 1 else None, dev)
            counts = dict(_kernels.launches)
            ms, n, kept = launches.take()
            kept_acc.extend(kept)
            rec = serve_record(gen, report, logical_report, hashlib)
            want = golden["depths"][str(depth)]
            same = {k: rec[k] == want[k] for k in rec}
            nums = serve_numbers(torch, gen, report, wall, ms, n, counts,
                                 f"acceptance (depth {depth})", card)
            log(f"serve acceptance (depth {depth}) against the JAX "
                f"package's golden record: {same}; "
                f"{len(rec['docs'])} documents, {rec['trace_events']} "
                f"trace events")
            if (not report["converged"] or not all(same.values())
                    or counts.get("rle_lanes_mixed_blocked", 0) < 1
                    or report["pipeline"]["ticks"] != depth
                    or report["server"]["evictions"] < 20
                    or not set(nums["shapes_seen"]) <= {8, 32, 128}):
                raise AssertionError(
                    f"serve acceptance (depth {depth}) failed: converged "
                    f"{report['converged']}, golden {same}, launches "
                    f"{counts}, shapes {nums['shapes_seen']}")
            runs[f"acceptance_depth{depth}"] = nums
            del gen, report

        # The wide shape: every 8th launch of each shard kept for the
        # plain check, which runs in the child processes.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        gen, report, wall = serve_run(
            torch, ServeConfig, ServeLoadGen, launches, SERVE_WIDE,
            SERVE_WIDE_CFG, 2, lambda args, k: k % SERVE_SAMPLE_EVERY == 0,
            dev)
        counts = dict(_kernels.launches)
        ms, n, kept_wide = launches.take()
        nums = serve_numbers(torch, gen, report, wall, ms, n, counts,
                             "wide (depth 2)", card)
        if (not report["converged"]
                or counts.get("rle_lanes_mixed_blocked", 0) < 1):
            raise AssertionError(f"serve wide shape failed: converged "
                                 f"{report['converged']}, launches "
                                 f"{counts}, mismatches "
                                 f"{report['mismatches'][:4]}")
        runs["wide_depth2"] = nums
        del gen, report
    finally:
        RLM.lanes_mixed_blocked_replay_cuda = launches.kernel

    # The acceptance run's launches held against the plain version: every
    # launch with a split, every S = 128 launch, every 8th of each shard.
    def chosen(kl):
        nlog_in, nlog_out = kl["inputs"][12], kl["outputs"][4]
        return (kl["index"] % SERVE_SAMPLE_EVERY == 0
                or kl["inputs"][0].shape[0] == 128
                or bool((nlog_out > nlog_in).any()))

    sample = [kl for kl in kept_acc if chosen(kl)]
    worst, secs, splits = 0, 0.0, 0
    bytes_, ops_ = 0, 0
    for kl in sample:
        inputs = [t.cpu().numpy() for t in kl["inputs"]]
        outs, s = plain_serve_launch(inputs, kl["shape"])
        secs += s
        e = worst_err([t.cpu() for t in kl["outputs"]],
                      [torch.from_numpy(x) for x in outs], A7_OUTPUTS)
        worst = max(worst, e)
        splits += bool((kl["outputs"][4] > kl["inputs"][12]).any())
    for kl in kept_acc:
        CAP, NBT, OCAP = (kl["inputs"][10].shape[0],
                          kl["inputs"][13].shape[0],
                          kl["inputs"][17].shape[0])
        b, o, _ = lanes_bound(kl["inputs"][:10], (CAP, OCAP), True,
                              kl["shape"]["block_k"], NBT)
        bytes_, ops_ = bytes_ + b, ops_ + o
    bb, bo = bytes_ / PEAK_BYTES_PER_S * 1e3, ops_ / PEAK_OPS_PER_S * 1e3
    log(f"compare serve acceptance launches (K=32) against the plain "
        f"version: {len(sample)} of {len(kept_acc)} launches ({splits} "
        f"with a split, every S = 128 one, every {SERVE_SAMPLE_EVERY}th of "
        f"each shard), max_abs_err {worst} over all 14 outputs, plain "
        f"{secs:.1f} s on the CPU; the depth-1 run's {len(kept_acc)} "
        f"launches bound {max(bb, bo):.4f} ms ({bb:.4f} ms by bytes, "
        f"{bo:.4f} ms by operations); on {card}")
    if worst != 0 or not sample:
        raise AssertionError("A7 disagrees with its plain version at the "
                             "serve shapes")
    wide_pending = [(kl["shard"], kl["index"], pool.apply_async(
        plain_serve_launch, ([t.cpu().numpy() for t in kl["inputs"]],
                             kl["shape"])),
        [t.cpu() for t in kl["outputs"]]) for kl in kept_wide]
    del kept_wide, kept_acc
    fields = {
        "launches_serve": {k: v["a7_launches"] for k, v in runs.items()},
        "serve_ms": {k: v["a7_device_ms"] for k, v in runs.items()},
        "serve_bound_ms_acceptance_depth1": max(bb, bo),
        "serve_bound_by": "bytes" if bb >= bo else "operations",
        "serve_plain_launches": len(sample),
        "serve_plain_s": secs,
        "serve_max_abs_err": worst,
        "serve": runs,
    }
    return fields, worst, wide_pending


def check_serve_wide(torch, pending):
    """The wide serve run's sampled launches against their plain version
    (run in the child processes), bit for bit."""
    worst, secs = 0, []
    for shard, index, res, kern in pending:
        outs, s = res.get()
        e = worst_err(kern, [torch.from_numpy(x) for x in outs], A7_OUTPUTS)
        worst = max(worst, e)
        secs.append(s)
        log(f"compare serve wide launch {index} of shard {shard} against "
            f"the plain version: max_abs_err {e}, plain {s:.1f} s in its "
            f"child process")
    if not pending:
        raise AssertionError("no wide serve launch was sampled")
    return worst, secs


# -- the flat engine: ServeConfig()'s document server -------------------------

FLAT_GOLDEN = os.path.join("tests", "data", "serve_flat_golden.json")
FLAT_CFG = dict(engine="flat", num_shards=2, lanes_per_shard=16)
FLAT_WIDE_CFG = dict(engine="flat", num_shards=2, lanes_per_shard=1024,
                     max_queue_per_doc=1024)
FLAT_RUNS = ((1, 1), (2, 1), (2, 4))   # (pipeline depth, train length)
FLAT_SAMPLE_EVERY = 8          # every 8th launch of each shard is checked
#: The ``recovery`` cost-ledger cell's crash shape (obs/cells.py).
FLAT_CHAOS = dict(ticks=9, docs=6, agents_per_doc=2, events_per_tick=12,
                  seed=7, fault_rate=0.10, num_shards=2, lanes_per_shard=2)
FLAT_CHAOS_TICK = 3
FLAT_ACCEPTANCE_CRASH_TICK = 30
#: Report fields that count dispatches and scatter shapes: the only
#: logical fields a tick train changes.
FLAT_TRAIN_KEYS = ("device_dispatches", "device_dispatches_per_tick",
                   "dispatch_cut_x", "train_len", "train_compiles",
                   "train_ticks", "prefill_bytes_per_tick",
                   "prefill_bytes_cut_x", "prefill_scatter_compiles")
FLAT_STATE = ("signed", "ol_log", "or_log", "n", "next_order")


def flat_train_invariant(record):
    """A golden record without its dispatch-economy fields (as
    ``tests/test_torch_serve_flat.train_invariant``)."""
    out = dict(record)
    lg = dict(record["logical"])
    lg.pop("train", None)
    lg["prefill"] = {k: v for k, v in lg["prefill"].items()
                     if k not in ("bytes_per_tick", "bytes_cut_x",
                                  "scatter_compiles")}
    lg["tick_ms"] = {k: v for k, v in lg["tick_ms"].items()
                     if k not in FLAT_TRAIN_KEYS}
    lg["server"] = {k: v for k, v in lg["server"].items()
                    if k.replace("tick_ms_", "") not in FLAT_TRAIN_KEYS}
    out["logical"] = lg
    return out


def docs_digest(docs, hashlib):
    """``serve.chaos.logical_stream_digest`` of a golden record's
    documents (doc id, string, state digest, in doc-id order)."""
    h = hashlib.sha256()
    for doc_id in sorted(docs):
        text, digest = docs[doc_id]
        for part in (doc_id, text, str(digest)):
            h.update(part.encode("utf-8"))
            h.update(b"\x00")
    return h.hexdigest()


def plain_flat_launch(inputs, cols, active, lmax):
    """Runs on the CPU (in a child process for the wide shape): the flat
    kernel's plain version on one recorded launch's inputs (numpy). Returns
    the state it leaves (``FLAT_STATE``), its flags and the seconds."""
    import torch

    from text_crdt_rust_tpu_torch.ops import flat as F

    torch.set_num_threads(1)
    st = [torch.from_numpy(a.copy()) for a in inputs]
    t0 = time.perf_counter()
    flags = F.flat_replay_plain(*st, cols.view("uint32"), active.astype(bool),
                                lmax)
    secs = time.perf_counter() - t0
    signed, ol, orr, _rank, n, nxt = st
    return ([t.numpy() for t in (signed, ol, orr, n, nxt)], flags.numpy(),
            secs)


class FlatLaunches:
    """Stands in for the flat kernel's launch wrapper while the server
    runs: CUDA events around every launch (the device time), and with
    ``keep`` set, copies of a launch's inputs and outputs (taken on the
    card, in stream order: the kernel edits the state in place) with its
    shard (found by the state's storage) and its index in that shard."""

    def __init__(self, torch, kernel):
        self.torch, self.kernel = torch, kernel
        self.events, self.kept = [], []
        self.keep = None       # (cols shape, index in shard) -> keep it?
        self.shard_of = {}     # signed.data_ptr() -> shard
        self.index = {}
        self.steps = None      # device steps of those launches, on the card
        self.last_steps = 0    # ... as of the last take()

    def __call__(self, signed, ol, orr, rank, n, nxt, cols, active, lmax):
        torch = self.torch
        shard = self.shard_of.get(signed.data_ptr(), -1)
        k = self.index.get(shard, 0)
        self.index[shard] = k + 1
        keep = self.keep is not None and self.keep(tuple(cols.shape), k)
        if keep:
            before = [t.clone() for t in (signed, ol, orr, rank, n, nxt)]
            cols_c, active_c = cols.clone(), active.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        flags = self.kernel(signed, ol, orr, rank, n, nxt, cols, active,
                            lmax)
        end.record()
        self.events.append((start, end))
        steps = active.sum()
        self.steps = steps if self.steps is None else self.steps + steps
        if keep:
            self.kept.append(dict(
                shard=shard, index=k, lmax=lmax, inputs=before,
                cols=cols_c, active=active_c,
                outputs=[t.clone() for t in (signed, ol, orr, n, nxt)],
                flags=flags.clone()))
        return flags

    def take(self):
        """(device ms summed over the launches since the last take, their
        count, the kept launches); resets. ``last_steps`` then holds the
        device steps (active steps) of those launches."""
        self.torch.cuda.synchronize()
        ms = sum(s.elapsed_time(e) for s, e in self.events)
        out = (ms, len(self.events), self.kept)
        self.last_steps = 0 if self.steps is None else int(self.steps)
        self.events, self.kept, self.index, self.steps = [], [], {}, None
        return out


def flat_bound(kl):
    """(bytes, operations) of one kept launch, from its inputs: the state
    read and written once, the op stack and mask read once, a local
    insert's log window written per step with work; operations: the
    live-prefix count, the delete compare and the splice over every row
    of every lane a step with work touches. The real floor is each lane's
    serial chain of steps, not these."""
    import numpy as np

    signed = kl["inputs"][0]
    B, CAP = signed.shape
    cols = kl["cols"].cpu().numpy().view(np.uint32)
    active = kl["active"].cpu().numpy().astype(bool)
    _, T, S, _ = cols.shape
    kind, ilen = cols[0], cols[6]
    steps = int(active.sum())
    local_ins = (kind == 0) & (ilen > 0) & active[..., None]
    window = int((1 + np.minimum(ilen, kl["lmax"]))[local_ins].sum())
    nbytes = 4 * (2 * B * CAP + 4 * B + 10 * T * S * B + T * S + B
                  + window)
    nops = 3 * steps * B * CAP
    return nbytes, nops


def flat_run(torch, ServeConfig, ServeLoadGen, launches, params, cfg_kw,
             depth, train, keep, dev):
    """One counted ServeLoadGen run on the card (the caller's clock:
    ``time.perf_counter``); returns the generator, its report and the
    host wall."""
    cfg = ServeConfig(pipeline_ticks=depth, train_ticks=train,
                      trace_keep=True, **cfg_kw)
    launches.keep = keep
    gen = ServeLoadGen(cfg=cfg, device=dev, clock=time.perf_counter,
                       **params)
    launches.shard_of = {b.docs.signed.data_ptr(): i for i, b in
                         enumerate(gen.server.residency.backends)}
    t0 = time.perf_counter()
    report = gen.run()
    torch.cuda.synchronize()
    return gen, report, time.perf_counter() - t0


def flat_numbers(torch, gen, report, wall, ms, n, launches, label, card):
    """Logs a flat serve run's numbers (all on ``card``) and returns
    them."""
    b0 = gen.server.residency.backends
    tick = report["tick_ms"]
    srv = report["server"]
    out = dict(
        host_wall_s=wall, ticks=tick["samples"], tick_ms_p50=tick["p50"],
        tick_ms_p99=tick["p99"], flat_device_ms=ms, flat_launches=n,
        kernel_launches=launches, item_ops=report["item_ops_applied"],
        item_ops_per_s=report["ops_per_sec"],
        evictions=srv.get("evictions", 0), restores=srv.get("restores", 0),
        lane_writes=sum(b.lane_writes for b in b0),
        overlap_frac=report["pipeline"]["overlap_frac"],
        stall_ms=report["pipeline"]["stall_ms_total"],
        train=report["train"], rejected=report["rejected_submissions"],
        shapes_seen=sorted(set().union(*(b.shapes_seen for b in b0))),
        train_shapes=sorted(set().union(
            *(b.train_shapes_seen for b in b0))),
        device_share=ms / 1e3 / wall if wall else None,
        peak_device_bytes=torch.cuda.max_memory_allocated())
    log(f"flat serve {label}: converged {report['converged']}; host wall "
        f"{wall:.2f} s over {out['ticks']} ticks (tick ms p50 "
        f"{out['tick_ms_p50']}, p99 {out['tick_ms_p99']}, caller's clock); "
        f"flat kernel {n} launches, {ms:.3f} ms on the card (CUDA events, "
        f"summed; {100 * (out['device_share'] or 0):.3f} % of the wall); "
        f"{out['item_ops']} item-ops, {out['item_ops_per_s']} item-ops/s; "
        f"evictions {out['evictions']}, restores {out['restores']}, lane "
        f"writes {out['lane_writes']}; pipeline depth "
        f"{report['pipeline']['ticks']}: overlap_frac "
        f"{out['overlap_frac']}, stall {out['stall_ms']} ms; train "
        f"{out['train']}; rejected submissions {out['rejected']}; shapes "
        f"{out['shapes_seen']}, trains {out['train_shapes']}; launches "
        f"{launches}; peak device memory "
        f"{out['peak_device_bytes'] / 2**20:.1f} MiB; on {card}")
    return out


def flat_check_kept(torch, kept, label):
    """The kept launches against the plain version in this process: the
    worst difference, the plain seconds, the kernel's ms re-launched on
    copies of the same inputs (median of 3, CUDA events, summed) and the
    summed bound."""
    import numpy as np

    from text_crdt_rust_tpu_torch.ops import flat as F

    worst, secs, kern_ms, nbytes, nops = 0, 0.0, 0.0, 0, 0
    for kl in kept:
        outs, flags, s = plain_flat_launch(
            [t.cpu().numpy() for t in kl["inputs"]],
            kl["cols"].cpu().numpy(), kl["active"].cpu().numpy(),
            kl["lmax"])
        secs += s
        got = [t.cpu().numpy() for t in kl["outputs"]]
        e = max(int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
                if a.size else 0 for a, b in zip(got, outs))
        e = max(e, int(np.abs(kl["flags"].cpu().numpy() - flags).max()))
        worst = max(worst, e)
        b, o = flat_bound(kl)
        nbytes, nops = nbytes + b, nops + o
        times = []
        for _ in range(4):     # 1 warm-up, then 3 timed on fresh copies
            st = [t.clone() for t in kl["inputs"]]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            F.flat_replay_cuda(*st, kl["cols"], kl["active"], kl["lmax"])
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        kern_ms += statistics.median(times[1:])
    log(f"compare {label}: {len(kept)} launches against the plain version, "
        f"max_abs_err {worst} over the state and flags; plain {secs:.2f} s "
        f"on the CPU, kernel {kern_ms:.3f} ms re-launched on the same "
        f"inputs")
    return worst, secs, kern_ms, nbytes, nops


def flat_small_cases(torch, dev, B, randedit, np):
    """The flat kernel against its plain version on small cases (local
    edits, a remote storm, fuzzed op columns, a train of 4 with idle
    steps), at capacity 256 (the flag set on the fuzz) and 4,096 (past 48
    KB of shared memory)."""
    from text_crdt_rust_tpu_torch.ops import flat as F
    from text_crdt_rust_tpu_torch.ops import span_arrays as SA

    def local(seed):
        return B.compile_local_patches(randedit.random_patches(
            np.random.default_rng(seed), 120)[0], lmax=16)[0]

    def storm_ops(seed):
        txns, _ = randedit.make_storm(4, 8, 5, seed=seed, del_prob=0.3)
        table = B.AgentTable(sorted({t.id.agent for t in txns}))
        return B.compile_remote_txns(txns, table, lmax=16)[0]

    streams = [local(1), local(2), storm_ops(3), storm_ops(4)]
    one = B.stack_ops(streams)
    half = one.num_steps // 2
    ticks = [B._map_fields(lambda a: np.asarray(a)[:half], one),
             B._map_fields(lambda a: np.asarray(a)[half:], one)]
    ticks = [B.pad_ops(t, one.num_steps - half + 3) for t in ticks]
    zero = B._map_fields(lambda a: np.zeros_like(np.asarray(a)), ticks[0])
    train = B.stack_ticks(ticks + [zero, zero])
    rng = np.random.default_rng(5)
    fuzz = B._map_fields(lambda a: np.asarray(a).copy(), one)
    fuzz.kind = rng.integers(0, 3, fuzz.kind.shape).astype(np.uint32)
    fuzz.del_target = rng.integers(0xFFFF_FF00, 0xFFFF_FFFF,
                                   fuzz.kind.shape).astype(np.uint32)
    worst = 0
    for label, ops, skip in (("local+storm", one, False),
                             ("train T=4", train, True),
                             ("fuzzed kinds", fuzz, False)):
        for cap in (256, 4096):
            docs = SA.stack_docs(SA.make_flat_doc(cap, 2048, device="cpu"),
                                 len(streams))
            plain = F._batched_copy(docs)
            kern = F._batched_copy(docs)
            for f in ("signed", "ol_log", "or_log", "rank_log", "chars_log",
                      "n", "next_order"):
                setattr(kern, f, getattr(kern, f).to(dev))
            pf = F.flat_replay(plain, ops, skip_idle=skip)
            kf = F.flat_replay(kern, ops, skip_idle=skip)
            torch.cuda.synchronize()
            e = int((kf.cpu() != pf).sum())
            for f in FLAT_STATE:
                e = max(e, int((getattr(kern, f).cpu().long()
                                - getattr(plain, f).long()).abs().max()))
            worst = max(worst, e)
            log(f"compare flat {label} at capacity {cap}: max_abs_err {e}, "
                f"flags {kf.cpu().tolist()}")
    if worst != 0:
        raise AssertionError("the flat kernel disagrees with its plain "
                             "version on the small cases")
    return worst


def flat_phase(torch, dev, card, _kernels, B, randedit, np, pool):
    """``ServeConfig()``'s document server on the flat kernel: the small
    cases, the acceptance shape at (depth, train) 1/1, 2/1 and 2/4 against
    the JAX package's golden record, the wide shape, the kernel against
    its plain version on sampled launches, crash recovery at the ledger's
    recovery shape (all four phases) and at the acceptance shape,
    ``DeviceMirror`` and a profiler capture. Returns the kernel's line,
    the wide run's pending plain checks and the depth-1 and depth-2
    acceptance runs' kept traces (phase 26a's input)."""
    import hashlib
    import tempfile

    from text_crdt_rust_tpu_torch.config import ServeConfig
    from text_crdt_rust_tpu_torch.ops import flat as F
    from text_crdt_rust_tpu_torch.serve import chaos
    from text_crdt_rust_tpu_torch.serve.loadgen import (
        ServeLoadGen,
        logical_report,
    )

    t_phase = time.perf_counter()
    small_worst = flat_small_cases(torch, dev, B, randedit, np)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, FLAT_GOLDEN)) as f:
        golden = json.load(f)
    if (golden["params"] != SERVE_ACCEPTANCE or golden["cfg"] != FLAT_CFG
            or ServeConfig().engine != "flat"):
        raise AssertionError("the flat golden record is of another shape")
    launches = FlatLaunches(torch, F.flat_replay_cuda)
    F.flat_replay_cuda = launches
    runs, kept_acc, main_counts, traces = {}, [], None, {}

    def keep_acc(shape, k):
        _, T, S, _ = shape
        return S == 128 or T > 1 or k % FLAT_SAMPLE_EVERY == 0

    try:
        for depth, train in FLAT_RUNS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launches()
            gen, report, wall = flat_run(
                torch, ServeConfig, ServeLoadGen, launches,
                SERVE_ACCEPTANCE, FLAT_CFG, depth, train, keep_acc, dev)
            counts = dict(_kernels.launches)
            ms, n, kept = launches.take()
            steps = launches.last_steps
            kept_acc.extend(kept)
            rec = serve_record(gen, report, logical_report, hashlib)
            want = golden["depths"][str(depth)]
            if train == 1:
                same = {k: rec[k] == want[k] for k in rec}
            else:
                same = {k: flat_train_invariant(rec)[k]
                        == flat_train_invariant(want)[k] for k in rec}
            label = f"acceptance (depth {depth}, train {train})"
            nums = flat_numbers(torch, gen, report, wall, ms, n, counts,
                                label, card)
            nums.update(device_steps=steps,
                        us_per_step=ms * 1e3 / max(steps, 1))
            log(f"flat serve {label}: {steps} device steps, "
                f"{nums['us_per_step']:.3f} us a step on the card")
            log(f"flat serve {label} against the JAX package's golden "
                f"record: {same}; {len(rec['docs'])} documents, "
                f"{rec['trace_events']} trace events")
            if (not report["converged"] or not all(same.values())
                    or counts.get("flat_replay", 0) < 1
                    or counts.get("rle_lanes_mixed_blocked", 0) != 0
                    or report["pipeline"]["ticks"] != depth
                    or report["train"]["ticks"] != train
                    or not set(nums["shapes_seen"]) <= {8, 32, 128}):
                raise AssertionError(
                    f"flat serve {label} failed: converged "
                    f"{report['converged']}, golden {same}, launches "
                    f"{counts}, shapes {nums['shapes_seen']}")
            if main_counts is None:
                main_counts = counts
            runs[f"acceptance_depth{depth}_train{train}"] = nums
            if train == 1:
                # Phase 26a reads these kept traces (walls from this
                # script's clock) instead of running the shape again.
                traces[depth] = gen.server.tracer.events
            del gen, report

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        gen, report, wall = flat_run(
            torch, ServeConfig, ServeLoadGen, launches, SERVE_WIDE,
            FLAT_WIDE_CFG, 2, 1,
            lambda shape, k: k % FLAT_SAMPLE_EVERY == 0, dev)
        counts = dict(_kernels.launches)
        ms, n, kept_wide = launches.take()
        nums = flat_numbers(torch, gen, report, wall, ms, n, counts,
                            "wide (depth 2)", card)
        nums.update(device_steps=launches.last_steps,
                    us_per_step=ms * 1e3 / max(launches.last_steps, 1))
        log(f"flat serve wide (depth 2): {launches.last_steps} device "
            f"steps, {nums['us_per_step']:.3f} us a step on the card")
        if not report["converged"] or counts.get("flat_replay", 0) < 1:
            raise AssertionError(f"flat serve wide shape failed: converged "
                                 f"{report['converged']}, launches "
                                 f"{counts}, mismatches "
                                 f"{report['mismatches'][:4]}")
        runs["wide_depth2"] = nums
        del gen, report
    finally:
        F.flat_replay_cuda = launches.kernel

    worst, plain_s, kern_ms, nbytes, nops = flat_check_kept(
        torch, kept_acc, "flat serve acceptance launches (every S = 128 "
        "launch, every train with T > 1, every 8th launch of each shard)")
    if worst != 0 or not kept_acc:
        raise AssertionError("the flat kernel disagrees with its plain "
                             "version at the serve shapes")
    bb, bo = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_OPS_PER_S * 1e3
    log(f"flat kernel bound over those {len(kept_acc)} launches: "
        f"{max(bb, bo):.4f} ms ({bb:.4f} ms by bytes, {nbytes} B; "
        f"{bo:.4f} ms by operations, {nops}); the real floor is each "
        f"lane's serial chain of steps; on {card}")
    wide_pending = [(kl["shard"], kl["index"], pool.apply_async(
        plain_flat_launch, ([t.cpu().numpy() for t in kl["inputs"]],
                            kl["cols"].cpu().numpy(),
                            kl["active"].cpu().numpy(), kl["lmax"])),
        [t.cpu().numpy() for t in kl["outputs"]], kl["flags"].cpu().numpy())
        for kl in kept_wide]
    del kept_wide

    # -- crash recovery ---------------------------------------------------
    crash = {}
    twin = None
    for phase in chaos.PHASES:
        t0 = time.perf_counter()
        cell = chaos.run_crash_scenario(
            phase, FLAT_CHAOS_TICK, device=dev, clock=time.perf_counter,
            twin_digest=twin, **FLAT_CHAOS)
        twin = cell["twin_digest"]
        green = (cell["identical"] and cell["converged"]
                 and cell["at_recovery_audit"]["audit_ok"]
                 and cell["final_audit"]["audit_ok"])
        crash[phase] = dict(identical=cell["identical"], green=green,
                            recover=cell["recover"],
                            recover_wall_s=cell["recover_wall_s"],
                            wall_s=time.perf_counter() - t0)
        log(f"flat crash {phase} at tick {FLAT_CHAOS_TICK} (recovery cell "
            f"shape): identical to its twin {cell['identical']}, green "
            f"{green}, replayed {cell['recover']['ops']} ops in "
            f"{cell['recover']['ticks']} ticks, recover wall "
            f"{cell['recover_wall_s']} s (caller's clock)")
        if not green:
            raise AssertionError(f"flat crash {phase} is not green")
    t0 = time.perf_counter()
    acc_twin = docs_digest(golden["depths"]["1"]["docs"], hashlib)
    p = SERVE_ACCEPTANCE
    cell = chaos.run_crash_scenario(
        "post-dispatch", FLAT_ACCEPTANCE_CRASH_TICK, ticks=p["ticks"],
        docs=p["docs"], agents_per_doc=p["agents_per_doc"],
        events_per_tick=p["events_per_tick"], seed=p["seed"],
        fault_rate=p["fault_rate"], num_shards=2, lanes_per_shard=16,
        twin_digest=acc_twin, device=dev, clock=time.perf_counter)
    green = (cell["identical"] and cell["converged"]
             and cell["at_recovery_audit"]["audit_ok"]
             and cell["final_audit"]["audit_ok"])
    crash["acceptance_post_dispatch"] = dict(
        identical=cell["identical"], green=green, recover=cell["recover"],
        recover_wall_s=cell["recover_wall_s"],
        wall_s=time.perf_counter() - t0)
    log(f"flat crash post-dispatch at tick {FLAT_ACCEPTANCE_CRASH_TICK} of "
        f"the acceptance shape: identical to the golden record's documents "
        f"{cell['identical']}, green {green}, replayed "
        f"{cell['recover']['ops']} ops in {cell['recover']['ticks']} ticks, "
        f"recover wall {cell['recover_wall_s']} s, "
        f"{crash['acceptance_post_dispatch']['wall_s']:.1f} s in all")
    if not green:
        raise AssertionError("flat crash at the acceptance shape is not "
                             "green")
    del cell

    # -- DeviceMirror --------------------------------------------------------
    from text_crdt_rust_tpu_torch.models.oracle import ListCRDT
    from text_crdt_rust_tpu_torch.models.sync import export_txns_since
    from text_crdt_rust_tpu_torch.net import codec
    from text_crdt_rust_tpu_torch.net.session import (
        DeviceMirror,
        ResyncSession,
    )
    from text_crdt_rust_tpu_torch.ops import span_arrays as SA
    from text_crdt_rust_tpu_torch.utils.metrics import memory_stats

    peer = ListCRDT()
    rng = np.random.default_rng(9)
    ids = [peer.get_or_create_agent_id(a) for a in ("amy", "bob", "cat")]
    for _ in range(60):
        a = ids[int(rng.integers(0, 3))]
        n = len(peer)
        if n > 4 and rng.random() < 0.25:
            p0 = int(rng.integers(0, n - 2))
            peer.local_delete(a, p0, 2)
        else:
            peer.local_insert(a, int(rng.integers(0, n + 1)),
                              "xyzw"[: int(rng.integers(1, 5))])
    mirror = DeviceMirror(capacity=1024, agents=("amy", "bob", "cat"),
                          device=dev)
    sess = ResyncSession(ListCRDT(), mirror=mirror)
    txns = export_txns_since(peer, 0)
    _kernels.reset_launches()
    for i in range(0, len(txns), 4):
        sess.receive(codec.encode_txns(txns[i:i + 4]))
    m_launches = _kernels.launches.get("flat_replay", 0)
    mirror_ok = (not mirror.degraded
                 and SA.doc_spans(mirror.doc) == sess.doc.doc_spans()
                 and SA.to_string(mirror.doc) == peer.to_string()
                 and m_launches >= 1)
    log(f"flat DeviceMirror: {len(txns)} txns from 3 agents, "
        f"{m_launches} launches (B = 1), degraded {mirror.degraded}, spans "
        f"and text equal to the oracle {mirror_ok}; "
        f"{memory_stats(mirror.doc)['total_bytes']} B on the card")
    if not mirror_ok:
        raise AssertionError("DeviceMirror disagrees with its oracle")

    # -- the profiler --------------------------------------------------------
    with tempfile.TemporaryDirectory() as prof_dir:
        cfg = ServeConfig(num_shards=2, lanes_per_shard=4,
                          profile_dir=prof_dir, profile_ticks=3)
        gen = ServeLoadGen(cfg=cfg, device=dev, docs=12, agents_per_doc=2,
                           ticks=6, events_per_tick=12, seed=3)
        rep = gen.run()
        path = os.path.join(prof_dir, "trace.json")
        text = open(path).read() if os.path.exists(path) else ""
        hits = text.count("flat_replay_kernel")
        prof_errors = gen.server.counters.get("profile_errors")
    log(f"flat profiler capture (ticks 1-3): converged {rep['converged']}, "
        f"{len(text)} B of Chrome trace, {hits} mentions of "
        f"flat_replay_kernel, profile_errors {prof_errors}")
    if not rep["converged"] or hits < 1 or prof_errors:
        raise AssertionError("the profiler trace holds no flat kernel "
                             "launch")

    main = runs["acceptance_depth1_train1"]
    line = {
        "name": "flat_replay",
        "route": "cuda",
        "source": "text_crdt_rust_tpu_torch/ops/csrc/flat_replay.cu",
        "replaces": "text_crdt_rust_tpu/ops/flat.py:418",
        "jax_counterpart": "text_crdt_rust_tpu/ops/flat.py::"
                           "_apply_train_batch / _apply_ops_batch (XLA "
                           "lax.scan of step; no pallas_call)",
        "launches": main_counts.get("flat_replay", 0),
        "launches_path": "serve.loadgen.ServeLoadGen on ServeConfig() "
                         "(acceptance shape, depth 1, train 1)",
        "ms": kern_ms,
        "ms_what": f"the {len(kept_acc)} sampled acceptance launches "
                   f"re-launched on their inputs (median of 3 each, "
                   f"summed)",
        "main_path_ms": main["flat_device_ms"],
        "us_per_step": main["us_per_step"],
        "us_per_step_what": f"the main path's {main['device_steps']} device "
                            f"steps (active [T, S] steps of its launches)",
        "plain_ms": plain_s * 1e3,
        "bound_ms": max(bb, bo),
        "bound_by": "bytes" if bb >= bo else "operations",
        "bound_bytes_ms": bb,
        "bound_ops_ms": bo,
        "library_ms": None,
        "library_why": "no PyTorch call computes a CRDT step chain",
        "max_abs_err": max(worst, small_worst),
        "plain_launches": len(kept_acc),
        "serve": runs,
        "crash": crash,
        "mirror_launches": m_launches,
        "profiler_hits": hits,
        "phase_s": time.perf_counter() - t_phase,
    }
    return line, wide_pending, traces


#: Phase 26a's steady-state rule: every ``device.compile`` (a shard's
#: first tick at a step bucket) lands in the first ticks of a run, each
#: (shard, bucket) at most once; a later one is a recompile.
ANALYTICS_WARMUP_TICKS = 10
#: Trace-event phases a Chrome/Perfetto importer accepts in the export.
CHROME_PHASES = ("X", "i", "M", "s", "t", "f")


def analytics_phase(traces, card):
    """Phase 26a: the port's trace analytics (``obs/analyze.py``) on the
    events phase 26's acceptance runs kept on the card (depths 1 and 2,
    walls from this script's clock): the phase breakdown with its stall
    budget and the overlap report, printed; the recompile timeline (no
    compile after the warm-up ticks, none repeated); the per-op flow
    census with its conservation audit (every span accounted); the Chrome
    export written to a temporary file and read back as trace-event JSON;
    the depth-1 events written as JSONL, read back with ``load_events``
    and diffed against themselves (must be None). Returns the phase's
    record."""
    import tempfile

    from text_crdt_rust_tpu_torch.obs import analyze as A
    from text_crdt_rust_tpu_torch.obs.flow import flow_report
    from text_crdt_rust_tpu_torch.obs.trace import event_line

    t_phase = time.perf_counter()
    if sorted(traces) != [1, 2] or not all(traces.values()):
        raise AssertionError("phase 26a needs the depth-1 and depth-2 "
                             "acceptance traces")
    rec = {}
    with tempfile.TemporaryDirectory(prefix="tcr_analytics_") as tmp:
        for depth, events in sorted(traces.items()):
            t0 = time.perf_counter()
            ph = A.phase_breakdown(events)
            budget = A.stall_budget(ph)
            ov = A.overlap_report(events)
            comp = A.recompile_timeline(events)
            flow = flow_report(events, expect_terminal=True)
            path = os.path.join(tmp, f"chrome_d{depth}.json")
            with open(path, "w") as f:
                json.dump(A.chrome_trace(events), f)
            with open(path) as f:
                chrome = json.load(f)
            tes = chrome.get("traceEvents") or []
            chrome_ok = bool(tes) and all(
                "name" in te and te.get("ph") in CHROME_PHASES
                and "pid" in te
                and (te["ph"] == "M" or isinstance(te.get("ts"),
                                                   (int, float)))
                and te.get("dur", 0) >= 0 for te in tes)
            pairs = [(c["shard"], c["bucket"]) for c in comp["timeline"]]
            late = [c for c in comp["timeline"]
                    if c["tick"] > ANALYTICS_WARMUP_TICKS]
            shares = {p: r["share_pct"] for p, r in ph["phases"].items()}
            log(f"analytics depth {depth}: {len(events)} events, "
                f"{ph['ticks']} ticks, {ph['wall_ms_total']:.3f} ms of "
                f"measured phase wall; shares {shares}; stall budget "
                f"{budget['phase']} {budget['wall_ms']:.3f} ms = "
                f"{budget['share_pct']} %; overlap: host "
                f"{ov['host_ms']:.3f} ms, dispatch {ov['dispatch_ms']:.3f} "
                f"ms, sync stall {ov['stall_ms']:.3f} ms, window "
                f"{ov['win_ms']:.3f} ms, overlap_frac {ov['overlap_frac']}, "
                f"idle gap per tick {ov['idle_gap_ms']}; on {card}")
            log(f"analytics depth {depth}: {comp['compiles']} compiles "
                f"{pairs} (last at tick {comp['last_compile_tick']} of "
                f"{comp['run_last_tick']}; warm-up "
                f"{ANALYTICS_WARMUP_TICKS} ticks); flow audit "
                f"{flow['audit_ok']}, spans {flow['spans']}, age at apply "
                f"{flow['ages_ticks']} ticks; chrome export "
                f"{len(tes)} trace events, {os.path.getsize(path)} B, "
                f"valid {chrome_ok}; {time.perf_counter() - t0:.2f} s")
            if late or len(set(pairs)) != len(pairs) or not pairs:
                raise AssertionError(
                    f"analytics depth {depth}: device.compile after the "
                    f"warm-up or repeated: {comp['timeline']}")
            if not flow["audit_ok"]:
                raise AssertionError(
                    f"analytics depth {depth}: flow audit failed: "
                    f"{flow['findings'][:3]}")
            if not chrome_ok:
                raise AssertionError(f"analytics depth {depth}: the "
                                     f"chrome export is not trace-event "
                                     f"JSON")
            rec[f"depth{depth}"] = dict(
                events=len(events), stall_budget=budget,
                overlap_frac=ov["overlap_frac"], stall_ms=ov["stall_ms"],
                win_ms=ov["win_ms"], idle_gap_ms=ov["idle_gap_ms"],
                compiles=comp["compiles"],
                last_compile_tick=comp["last_compile_tick"],
                flow_spans=flow["spans"], chrome_events=len(tes))
        path = os.path.join(tmp, "trace_d1.jsonl")
        with open(path, "w") as f:
            for ev in traces[1]:
                f.write(event_line(ev) + "\n")
        diff = A.trace_diff(traces[1], A.load_events([path]))
        log(f"analytics: depth-1 trace written ({os.path.getsize(path)} B) "
            f"and read back, diff against itself {diff}")
        if diff is not None:
            raise AssertionError(f"analytics: the depth-1 trace read back "
                                 f"differs: {diff}")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"analytics phase (26a): {rec['phase_s']:.2f} s; on {card}")
    log(json.dumps({"analytics": rec}, default=str))
    return rec


def check_flat_wide(pending):
    """The wide flat run's sampled launches against their plain version
    (run in the child processes), bit for bit."""
    import numpy as np

    worst, secs = 0, []
    for shard, index, res, kern, kflags in pending:
        outs, flags, s = res.get()
        e = max(int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
                for a, b in zip(kern, outs))
        e = max(e, int(np.abs(kflags - flags).max()))
        worst = max(worst, e)
        secs.append(s)
        log(f"compare flat wide launch {index} of shard {shard} against "
            f"the plain version: max_abs_err {e}, plain {s:.1f} s in its "
            f"child process")
    if not pending:
        raise AssertionError("no wide flat launch was sampled")
    return worst, secs


# -- config sp: the long-context layer (parallel/, ops/stream_scan) -------

SP_PREFIX = 20_000         # the sp = 4 run's trace prefix (911 steps)
SP_PLAIN_CHUNKS = (0, -1)  # the whole trace's chunks that also run on the
#                            plain version: the shallowest and the deepest
#                            state
SP_RANKS = 4               # ranks of the sp = 4 run, the sharded apply and
#                            the dry run
SHARDED = dict(patches=2000, batch=8, capacity=4096)  # F1 under the mesh
STREAM_ROWS = 1 << 27      # StreamedRuns' plane: 1 GiB in two int32 planes
STREAM_TILE = 1 << 20      # the default tile (128 tiles)
STREAM_LOOKUPS = 1000      # seeded rank lookups, and as many order lookups
FLAT_FIELDS = ("signed", "ol_log", "or_log", "rank_log", "chars_log", "n",
               "next_order")


def sp_plans():
    """Config sp's plans, each a run-row dry run (~13 s for the whole
    trace, in a child process): the whole trace at sp = 1, the prefix at
    sp = 1, and the prefix at sp = 4 with slack 1 (room for an even
    rebalance plus one chunk only, so an early chunk overflows shard 0 and
    takes the retry)."""
    from text_crdt_rust_tpu_torch import sp
    return (sp.plan_sp(None, 1), sp.plan_sp(SP_PREFIX, 1),
            sp.plan_sp(SP_PREFIX, SP_RANKS, slack=1.0))


def sharded_inputs(patches: int, batch: int, capacity: int):
    """A batch of fresh documents and the trace prefix tiled over it (lmax
    8, not prefilled: ``make_sharded_apply`` prefills), and its text."""
    from text_crdt_rust_tpu_torch import sp
    from text_crdt_rust_tpu_torch.ops import batch as B
    from text_crdt_rust_tpu_torch.ops import span_arrays as SA
    ps, want = sp.trace_patches(patches)
    ops, _ = B.compile_local_patches(ps, lmax=8)
    docs = SA.stack_docs(SA.make_flat_doc(capacity, device="cpu"), batch)
    return docs, B.tile_ops(ops, batch), want


def sharded_apply_job(ctx, dp: int, sp_n: int, patches: int, batch: int,
                      capacity: int):
    """A world job: ``sharded_inputs`` through ``make_sharded_apply`` on a
    ``(dp, sp_n)`` mesh, the launch counts set to 0 just before and read
    just after; returns the whole result gathered (numpy), rank 0's
    launches and the mesh's collective calls."""
    import torch
    from text_crdt_rust_tpu_torch.ops import _kernels
    from text_crdt_rust_tpu_torch.parallel import mesh as M
    docs, ops, _ = sharded_inputs(patches, batch, capacity)
    mesh = M.make_mesh(n_devices=dp * sp_n, dp=dp, sp=sp_n,
                       device=ctx.device)
    apply = M.make_sharded_apply(mesh)
    mine, mine_ops = M.shard_docs(docs, mesh), M.shard_ops(ops, mesh)
    _kernels.reset_launches()
    out = apply(mine, mine_ops)
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    whole = M.gather_docs(out, mesh)
    return ({f: getattr(whole, f).cpu().numpy() for f in FLAT_FIELDS},
            launches, dict(mesh.calls))


SP_OUTPUTS = ("ordp", "lenp", "rows", "oll", "orl", "rkl", "ols", "ors",
              "err")


def sp_chunks_job(ctx, plain_chunks=None):
    """A world job after ``sp.sp_prepare``: each chunk of the prepared
    stream through S1 (``SpReplay`` on the card: one launch at sp = 1, one
    a segment at sp > 1) and through the plain version from the same
    input state, each timed with CUDA events; then ``apply_stream``
    commits the chunk as the main path does (a capacity flag reshards and
    retries). These launches are comparisons, not the main path's. On a
    fresh ``SpDoc`` of the prepared geometry. Returns per chunk (rank 0's
    times; the group's worst difference over the nine outputs, the whole
    ``[R]`` planes included; S1's launches on this rank; the error bits;
    the rows before and after over all shards; the step phases with work).
    ``plain_chunks``: only these chunks (indices, negative from the end;
    an int n: the last n) go through the plain version too (all by
    default); the others record ``plain`` False."""
    import numpy as np
    import torch

    from text_crdt_rust_tpu_torch.ops import _kernels
    from text_crdt_rust_tpu_torch.parallel.sp_apply import OP_FIELDS, SpDoc

    st = ctx.store.get("sp")
    if st is None:
        return None
    old, mesh = st["doc"], st["mesh"]
    doc = SpDoc(mesh, old.R, old.OTS, auto_reshard=True)
    rep = doc._replay

    def timed(fn):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b), res

    out = []
    n_parts = len(st["parts"])
    if plain_chunks is None:
        held = set(range(n_parts))
    elif isinstance(plain_chunks, int):
        held = set(range(n_parts - plain_chunks, n_parts))
    else:
        held = {i % n_parts for i in plain_chunks}
    for part in st["parts"]:
        cols = [np.asarray(getattr(part, f), dtype=np.uint32).view(np.int32)
                for f in OP_FIELDS]
        kind, dl, il = cols[0], cols[2], cols[7]
        phases = int(((kind == 0) & (dl > 0)).sum()
                     + ((kind == 0) & (il > 0)).sum()
                     + ((kind == 2) & (dl > 0)).sum()
                     + ((kind == 1) & (il > 0)).sum())
        state = (doc.ordp, doc.lenp, doc.rows, doc.oll, doc.orl, doc.rkl)
        rows_in = int(mesh.sum(doc.rows)[0])
        _kernels.reset_launches()
        s1_ms, kern = timed(lambda: rep(*state, *cols))
        launches = _kernels.launches.get("sp_replay", 0)
        checked = len(out) in held
        plain_ms, plain = (timed(lambda: rep.plain(*state, cols)) if checked
                           else (0.0, kern))
        worst = 0
        for name, k, p in zip(SP_OUTPUTS, kern, plain):
            k, p = k.reshape(-1), p.reshape(-1)
            if k.shape != p.shape:
                raise AssertionError(f"S1's {name} has shape {k.shape}, "
                                     f"the plain version's {p.shape}")
            if k.numel():
                worst = max(worst, int((k.to(torch.int64)
                                        - p.to(torch.int64)).abs().max()))
        worst = int(mesh.all_gather(torch.tensor(
            [worst], dtype=torch.int64, device=mesh.device)).max())
        rows_out = int(mesh.sum(plain[2])[0])
        out.append(dict(steps=int(kind.shape[0]), s1_ms=s1_ms,
                        plain=checked, plain_ms=plain_ms, max_abs_err=worst,
                        launches=launches, err=int(plain[-1]),
                        rows_in=rows_in, rows_out=rows_out, phases=phases,
                        R=doc.R, OTS=doc.OTS, nsp=mesh.sp))
        doc.apply_stream(part)
    return out


def sp_bound(chunks):
    """(bytes, operations) S1 must at least move and do over ``chunks``
    (``sp_chunks_job``'s records): each rank's planes and tables read and
    written once, the op columns read and the logs written once; per step
    phase with work, 3 operations (a prefix term, a compare, a move) on
    each row in use (the mean of the chunk's rows before and after). The
    real floor is the serial chain of steps, not these."""
    nbytes = nops = 0
    for c in chunks:
        nbytes += 4 * (c["nsp"] * (4 * c["R"] + 6 * c["OTS"] + 4)
                       + 11 * c["steps"])
        nops += 3 * c["phases"] * (c["rows_in"] + c["rows_out"]) // 2
    return nbytes, nops


def sp_check(chunks, label, card):
    """Log ``sp_chunks_job``'s records; fail on any difference or a chunk
    that did not launch S1. Returns (S1 ms, plain ms, worst error)."""
    s1 = sum(c["s1_ms"] for c in chunks)
    plain = sum(c["plain_ms"] for c in chunks)
    worst = max(c["max_abs_err"] for c in chunks)
    steps = sum(c["steps"] for c in chunks)
    held = sum(c["plain"] for c in chunks)
    log(f"S1 against the plain version, {label}: {held} of {len(chunks)} "
        f"chunks held against it ({steps} steps on S1), from the same "
        f"input states: max_abs_err {worst} "
        f"over every output (whole [R] planes, rows, tables, both logs, "
        f"error bits {[c['err'] for c in chunks]}); S1 {s1:.3f} ms "
        f"({s1 / steps:.5f} ms a step; launches a chunk "
        f"{[c['launches'] for c in chunks]}), plain {plain:.1f} ms "
        f"(CUDA events); rows {[c['rows_out'] for c in chunks]}; on {card}")
    if worst or not held or any(c["launches"] < 1 for c in chunks):
        raise AssertionError(f"S1 disagrees with the plain version on "
                             f"{label}")
    return s1, plain, worst


def streamed_plane(np, o1, l1, rows: int, path: str):
    """Memmapped run planes ``[2, rows]`` int32: the north star's final
    runs repeated, each copy's orders made dense (the runs' order
    intervals closed up, without the gaps the deletes' orders leave) and
    offset by the copy's index times one copy's order count, so every
    order lives in one row and the tiles' order envelopes prune. Returns
    the memmap, one copy's rows, its orders and its dense row starts."""
    o1 = np.asarray(o1, np.int64)
    l1 = np.asarray(l1, np.int64)
    n1 = len(o1)
    by_start = np.argsort(np.abs(o1) - 1, kind="stable")
    dense = np.empty(n1, np.int64)
    dense[by_start] = np.concatenate(([0], np.cumsum(l1[by_start])[:-1]))
    per_copy = int(l1.sum())
    copies = -(-rows // n1)
    if copies * per_copy >= 2 ** 31 - 1:
        raise AssertionError("the repeated plane's orders overflow int32")
    mm = np.memmap(path, np.int32, "w+", shape=(2, rows))
    sign = np.sign(o1)
    step = 1024
    for k0 in range(0, copies, step):
        k = np.arange(k0, min(copies, k0 + step), dtype=np.int64)[:, None]
        a = k0 * n1
        b = min(rows, a + k.shape[0] * n1)
        mm[0, a:b] = (sign * (dense + 1 + k * per_copy)).ravel()[:b - a]
        mm[1, a:b] = np.broadcast_to(l1, (k.shape[0], n1)).ravel()[:b - a]
    mm.flush()
    return mm, n1, per_copy, (dense, by_start)


def streamed_runs_phase(torch, dev, np, runs, card):
    """``StreamedRuns`` on a 2^27-row memmapped plane (``streamed_plane``)
    in a temporary directory, removed after: ``live_total``, then
    ``STREAM_LOOKUPS`` seeded rank lookups and as many order lookups, and
    the out-of-range sentinels, each held against numpy on the host; the
    time a lookup, a tile upload and the host pass (the caller's clock; the
    plane was just written, so its reads are warm)."""
    import tempfile

    from text_crdt_rust_tpu_torch.ops.stream_scan import StreamedRuns
    with tempfile.TemporaryDirectory(prefix="tcr_stream_") as tmp:
        t0 = time.perf_counter()
        mm, n1, per_copy, (dense, by_start) = streamed_plane(
            np, runs[0], runs[1], STREAM_ROWS, os.path.join(tmp, "planes"))
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sr = StreamedRuns(mm[0], mm[1], tile=STREAM_TILE, device=dev)
        host_pass_s = time.perf_counter() - t0
        # numpy on the host: the global live prefix (int64).
        lv = np.where(mm[0] > 0, mm[1], 0).astype(np.int64)
        cum = np.cumsum(lv)
        total = int(cum[-1])
        if sr.live_total() != total:
            raise AssertionError(f"live_total {sr.live_total()} != {total}")
        rng = np.random.default_rng(15)
        ranks = rng.integers(1, total + 1, size=STREAM_LOOKUPS)
        want_rows = np.searchsorted(cum, ranks, side="left")
        want_offs = ranks - (cum[want_rows] - lv[want_rows])
        t0 = time.perf_counter()
        got = [sr.position_of_live_rank(int(r)) for r in ranks]
        rank_s = time.perf_counter() - t0
        rank_uploads = sr.uploads
        bad = sum(1 for g, r, o in zip(got, want_rows, want_offs)
                  if g != (int(r), int(o)))
        # Orders: the copy, then the row of the copy's dense start; each
        # row found is checked to hold its order on the plane itself.
        copies = -(-STREAM_ROWS // n1)
        orders = rng.integers(0, copies * per_copy, size=STREAM_LOOKUPS)
        sorted_starts = dense[by_start]
        want_pos = []
        for o in orders.tolist():
            k, d = divmod(o, per_copy)
            j = int(by_start[np.searchsorted(sorted_starts, d, "right") - 1])
            row = k * n1 + j
            if row >= STREAM_ROWS:
                want_pos.append(-1)
                continue
            so = abs(int(mm[0, row])) - 1
            if not so <= o < so + int(mm[1, row]):
                raise AssertionError(f"reference row {row} misses {o}")
            want_pos.append(int(cum[row] - lv[row]) + (o - so)
                            if mm[0, row] > 0 else -1)
        uploads0 = sr.uploads
        t0 = time.perf_counter()
        got_pos = [sr.order_to_position(int(o)) for o in orders]
        order_s = time.perf_counter() - t0
        order_uploads = sr.uploads - uploads0
        bad += sum(1 for g, w in zip(got_pos, want_pos) if g != w)
        edges = (sr.position_of_live_rank(0), sr.position_of_live_rank(
            total + 1), sr.order_to_position(copies * per_copy + 5),
            sr.order_to_position(-3))
        if edges != ((-1, 0), (-1, 0), -1, -1):
            raise AssertionError(f"out-of-range sentinels {edges}")
        # Each tile differs from the one before it, so each uploads (the
        # first may be the cached one: it is not timed).
        t_up = []
        for t in range(9):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sr.device_tile(t * 15)
            torch.cuda.synchronize()
            t_up.append((time.perf_counter() - t0) * 1e3)
        t_up = t_up[1:]
        out = dict(rows=STREAM_ROWS, tile=STREAM_TILE, tiles=sr.ntiles,
                   copies=copies, copy_rows=n1, live_total=total,
                   lookups=STREAM_LOOKUPS, mismatches=bad,
                   build_s=build_s, host_pass_s=host_pass_s,
                   rank_ms_per_lookup=rank_s * 1e3 / STREAM_LOOKUPS,
                   order_ms_per_lookup=order_s * 1e3 / STREAM_LOOKUPS,
                   rank_uploads=rank_uploads, order_uploads=order_uploads,
                   upload_ms_median=statistics.median(t_up),
                   upload_ms=t_up, warm=True)
        del sr, mm, lv, cum
    log(f"StreamedRuns: {STREAM_ROWS} rows ({STREAM_ROWS * 8 / 2 ** 30:.0f} "
        f"GiB memmapped, {out['tiles']} tiles of {STREAM_TILE}, "
        f"{out['copies']} copies of the north star's {n1} final runs with "
        f"dense order offsets), live total {total}; {STREAM_LOOKUPS} rank "
        f"and {STREAM_LOOKUPS} order lookups against numpy: {bad} "
        f"mismatches; {out['rank_ms_per_lookup']:.3f} ms a rank lookup "
        f"({rank_uploads} uploads), {out['order_ms_per_lookup']:.3f} ms an "
        f"order lookup ({order_uploads} uploads), a tile upload "
        f"{out['upload_ms_median']:.3f} ms (median of 8, pageable host "
        f"memory, warm page cache), host pass {host_pass_s:.2f} s, plane "
        f"build {build_s:.2f} s; on {card}")
    if bad:
        raise AssertionError(f"StreamedRuns: {bad} lookups disagree with "
                             "numpy")
    return out


def doc_on(doc, dev):
    """A copy of a batched ``FlatDoc`` on ``dev``."""
    import dataclasses
    return dataclasses.replace(doc, **{f: getattr(doc, f).to(dev)
                                       for f in FLAT_FIELDS})


def sp_stages(world, plan, label, rec, card):
    """``sp.py``'s three stages on ``world`` (the replay timed on this
    script's clock); the record goes into ``rec[label]``; returns the
    read-back."""
    from text_crdt_rust_tpu_torch import sp
    t0 = time.perf_counter()
    shape = world.run(sp.sp_prepare, plan)
    prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = world.run(sp.sp_replay)
    wall = time.perf_counter() - t0
    rd = world.run(sp.sp_read)
    steps = shape["steps"]
    what = sp.collectives_what(plan.nsp, rep["launches"])
    rec[label] = dict(
        patches=plan.patches, steps=steps, chunks=plan.chunks, sp=plan.nsp,
        shard_rows=plan.shard_rows, rows=rd["rows"],
        reshards=rep["reshards"], wall_s=wall, set_up_s=prep,
        steps_per_s=steps / wall, ms_per_step=wall * 1e3 / steps,
        patches_per_s=plan.patches / wall,
        collectives_per_step=rep["collectives"] / steps, calls=rep["calls"],
        collectives_what=what, launches=rep["launches"],
        backend=shape["backend"], device=shape["device"],
        shared_card=shape["shared_card"])
    log(f"config sp {label}: {plan.patches} patches -> {steps} steps in "
        f"{plan.chunks} chunks, sp={plan.nsp} ({shape['backend']}, "
        f"{shape['device']}"
        f"{', shared card' if shape['shared_card'] else ''}), "
        f"{plan.shard_rows} rows a shard, rows {rd['rows']}, reshards "
        f"{rep['reshards']}: replay {wall:.2f} s ({steps / wall:.0f} "
        f"steps/s, {wall * 1e3 / steps:.3f} ms a step, "
        f"{plan.patches / wall:.0f} patches/s), "
        f"{rep['collectives'] / steps:.4f} collectives a step "
        f"{rep['calls']} ({what}); rank 0's launches {rep['launches']}; "
        f"set-up {prep:.2f} s (world start and compile); on {card}")
    if rep["launches"].get("sp_replay", 0) < plan.chunks:
        raise AssertionError(f"config sp {label} did not run on S1: "
                             f"launches {rep['launches']}")
    return rd


def sp_four_ranks(torch, dev, card, np, F, plan_pre4, rd1, rec):
    """The four-rank world: the prefix at sp = 4 (one ``auto_reshard``
    retry) against the sp = 1 read-back ``rd1`` and, chunk by chunk, S1
    against the plain version; ``make_sharded_apply`` (dp = 2, sp = 2)
    against the unsharded apply, and the dry run's job. Returns (F1's
    launches in the sharded apply, in the dry run, the sharded apply's
    max_abs_err, the S1 check's chunks)."""
    from text_crdt_rust_tpu_torch import sp
    from text_crdt_rust_tpu_torch.ops import span_arrays as SA
    from text_crdt_rust_tpu_torch.parallel import dryrun, launch
    if torch.cuda.device_count() >= SP_RANKS:
        backend, device = "nccl", None
        how = "one rank a card over NCCL"
    else:
        backend, device = "gloo", "cuda:0"
        how = ("four processes sharing cuda:0 over gloo: no link between "
               "cards is measured")
    log(f"config sp, sp={SP_RANKS}: {how}")
    _, want_pre = sp.trace_patches(SP_PREFIX)
    label = f"{SP_PREFIX}-patch prefix, sp={SP_RANKS}"
    with launch.World(SP_RANKS, backend, device, timeout=600) as w4:
        rd4 = sp_stages(w4, plan_pre4, label, rec, card)
        same = dict(expand=bool(np.array_equal(rd4["expand"],
                                               rd1["expand"])),
                    text=rd4["text"] == rd1["text"] == want_pre,
                    resharded=rec[label]["reshards"] >= 1)
        log(f"config sp, sp={SP_RANKS} against sp=1 on the prefix: {same}")
        if not all(same.values()):
            raise AssertionError(f"sp={SP_RANKS} run differs: {same}")
        chunks4 = w4.run(sp_chunks_job)
        sp_check(chunks4, label, card)
        rec[label]["s1_chunks"] = chunks4
        t0 = time.perf_counter()
        got, f1_sharded, calls = w4.run(sharded_apply_job, 2, 2, **SHARDED)
        sh_s = time.perf_counter() - t0
        docs, ops, want_sh = sharded_inputs(**SHARDED)
        ref = F.apply_ops_batch(doc_on(docs, dev), ops)
        worst = max(max_abs_err([torch.as_tensor(got[f])],
                                [getattr(ref, f).cpu()])
                    for f in FLAT_FIELDS)
        text_ok = SA.to_string(SA.lane(ref, 0)) == want_sh
        log(f"make_sharded_apply (dp=2, sp=2) over the {SP_RANKS} ranks, "
            f"{SHARDED['batch']} documents x the {SHARDED['patches']}-patch "
            f"prefix, capacity {SHARDED['capacity']}: against the unsharded "
            f"apply max_abs_err {worst}, text {text_ok}, rank 0's launches "
            f"{f1_sharded}, collective calls {calls}, {sh_s:.2f} s")
        if worst or not text_ok or f1_sharded.get("flat_replay", 0) < 1:
            raise AssertionError("the sharded flat apply failed")
        t0 = time.perf_counter()
        dr = w4.run(dryrun.dryrun_job, SP_RANKS)
        dr_s = time.perf_counter() - t0
        log(f"{dryrun.summary(dr)}; rank 0's launches {dr['launches']}; "
            f"{dr_s:.2f} s")
        if dr["launches"].get("flat_replay", 0) < 1:
            raise AssertionError("the dry run did not launch the flat kernel")
    rec["sharded_apply"] = dict(max_abs_err=worst, launches=f1_sharded,
                                calls=calls, s=sh_s, backend=backend)
    rec["dryrun"] = dict(launches=dr["launches"], s=dr_s,
                         summary=dryrun.summary(dr))
    return (f1_sharded.get("flat_replay", 0),
            dr["launches"].get("flat_replay", 0), worst, chunks4)


def sp_phase(torch, dev, card, np, _kernels, F, plans):
    """Config sp and the rest of the long-context layer (docstring, 27b):
    returns (A1's parity fields, F1's fields, S1's kernels-line entry)."""
    from text_crdt_rust_tpu_torch import sp
    from text_crdt_rust_tpu_torch.baseline import native_replay
    from text_crdt_rust_tpu_torch.parallel import launch
    plan_full, plan_pre1, plan_pre4 = plans
    rec = {}
    t_phase = time.perf_counter()
    # -- sp = 1: one rank on the card over NCCL -----------------------------
    with launch.World(1, "nccl", None, timeout=600) as w1:
        rd = sp_stages(w1, plan_full, "whole trace, sp=1", rec, card)
        chunks_full = w1.run(sp_chunks_job, SP_PLAIN_CHUNKS)
        sp_check(chunks_full, "whole trace, sp=1", card)
        label1 = f"{SP_PREFIX}-patch prefix, sp=1"
        rd1 = sp_stages(w1, plan_pre1, label1, rec, card)
        chunks_pre1 = w1.run(sp_chunks_job)
        sp_check(chunks_pre1, label1, card)
    ps, want = sp.trace_patches(None)
    native_text = native_replay(ps).to_string()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    par_expand, par_text = sp.rle_parity(ps, plan_full.peak_rows, dev)
    torch.cuda.synchronize()
    par_s = time.perf_counter() - t0
    a1_launches = _kernels.launches.get("rle_replay", 0)
    checks = dict(text=rd["text"] == want, native=native_text == want,
                  a1_orders=bool(np.array_equal(par_expand, rd["expand"])),
                  a1_text=par_text == want,
                  rows=rd["rows"] == [plan_full.final_rows],
                  a1_launched=a1_launches >= 1)
    log(f"config sp whole trace: text == endContent {checks['text']}, "
        f"native engine {checks['native']}, expand() == A1's order column "
        f"of the same compile {checks['a1_orders']} (A1 text "
        f"{checks['a1_text']}, launches {a1_launches}, {par_s:.2f} s), "
        f"rows == the dry run's final {checks['rows']}")
    if not all(checks.values()):
        raise AssertionError(f"config sp failed its checks: {checks}")
    rec["whole trace checks"] = checks
    # -- sp = 4 on the prefix, the sharded apply and the dry run -------------
    f1_sharded, f1_dryrun, worst, chunks_pre4 = sp_four_ranks(
        torch, dev, card, np, F, plan_pre4, rd1, rec)
    # -- StreamedRuns on a 2^27-row memmapped plane ------------------------
    rec["streamed_runs"] = streamed_runs_phase(torch, dev, np, rd["runs"],
                                               card)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"long-context phase: {rec['phase_s']:.1f} s")
    log(json.dumps({"config_sp": rec}, default=str))
    a1 = dict(launches_sp_parity=a1_launches, sp_parity_s=par_s)
    f1 = dict(launches_sharded_apply=f1_sharded, launches_dryrun=f1_dryrun,
              sharded_apply_max_abs_err=worst)
    return a1, f1, sp_line(rec, chunks_full, chunks_pre1, chunks_pre4)


def sp_line(rec, chunks_full, chunks_pre1, chunks_pre4):
    """S1's entry of the kernels line: the main path's launches (the whole
    trace at sp = 1), the whole trace's chunks re-run on S1 and its
    ``SP_PLAIN_CHUNKS`` on the plain version (CUDA events), the bound, and
    the prefix at sp = 1 and sp = 4."""
    whole = rec["whole trace, sp=1"]
    s1 = sum(c["s1_ms"] for c in chunks_full)
    steps = sum(c["steps"] for c in chunks_full)
    nbytes, nops = sp_bound(chunks_full)
    bb = nbytes / PEAK_BYTES_PER_S * 1e3
    bo = nops / PEAK_OPS_PER_S * 1e3
    pre4 = rec[f"{SP_PREFIX}-patch prefix, sp={SP_RANKS}"]

    def prefix(chunks, r):
        return dict(steps=r["steps"], ms_per_step_wall=r["ms_per_step"],
                    reshards=r["reshards"], launches_rank0=r["launches"],
                    collectives_per_step=r["collectives_per_step"],
                    collectives_what=r["collectives_what"],
                    backend=r["backend"], shared_card=r["shared_card"],
                    s1_ms=sum(c["s1_ms"] for c in chunks),
                    plain_ms=sum(c["plain_ms"] for c in chunks),
                    max_abs_err=max(c["max_abs_err"] for c in chunks))

    return {
        "name": "sp_replay",
        "route": "cuda",
        "source": "text_crdt_rust_tpu_torch/ops/csrc/sp_replay.cu",
        "replaces": "text_crdt_rust_tpu/parallel/sp_apply.py:487",
        "jax_counterpart": "text_crdt_rust_tpu/parallel/sp_apply.py::"
                           "make_sp_apply (jax.jit of a shard_map: lax.scan "
                           "of step :454-489, lax.while_loop YATA scan "
                           ":342-402; no pallas_call)",
        "launches": whole["launches"].get("sp_replay", 0),
        "launches_path": "sp.sp_replay on config sp's whole trace at sp = 1 "
                         "(one NCCL rank, 4 chunks, one launch a chunk)",
        "ms": s1,
        "ms_per_step": s1 / steps,
        "ms_what": "the whole trace's 4 chunks re-run on S1 from their "
                   "input states (CUDA events around each SpReplay call, "
                   "summed)",
        "main_path_wall_s": whole["wall_s"],
        "plain_ms": sum(c["plain_ms"] for c in chunks_full),
        "plain_what": f"the whole trace's chunks "
                      f"{[i for i, c in enumerate(chunks_full) if c['plain']]}"
                      f" of {len(chunks_full)} (the first and the last) on "
                      f"the plain version",
        "bound_ms": max(bb, bo),
        "bound_by": "bytes" if bb >= bo else "operations",
        "bound_bytes_ms": bb,
        "bound_ops_ms": bo,
        "library_ms": None,
        "library_why": "no PyTorch call computes a CRDT step chain",
        "max_abs_err": max(c["max_abs_err"]
                           for c in chunks_full + chunks_pre1 + chunks_pre4),
        "prefix_sp1": prefix(chunks_pre1,
                             rec[f"{SP_PREFIX}-patch prefix, sp=1"]),
        "prefix_sp4": prefix(chunks_pre4, pre4),
        "phase_s": rec["phase_s"],
    }


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        import numpy as np

        from text_crdt_rust_tpu_torch import (
            baseline,
            common,
            corpus,
            kevin,
            northstar,
            random_edits,
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
        from text_crdt_rust_tpu_torch.ops import flat as F
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
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"  ptxas {name}: {line.strip()}")

    # The plain checks at the per-character paths' shapes (A9, A10, A8),
    # A2's at kevin's geometry and, once the 5r stream exists, the 5r plain chains in shards (A7,
    # A6) run on the CPU in child processes, one thread each, while the
    # card phases go on; each phase waits for its plain result last. The
    # children are stopped at exit.
    ncpu = os.cpu_count() or 1
    workers = max(3, min(7, ncpu - 1))
    pool = multiprocessing.get_context("spawn").Pool(workers)
    atexit.register(pool.terminate)
    plain_a9_async = pool.apply_async(plain_a9, (PLAIN_LANES_A9, TRACE_A9))
    plain_a10_async = pool.apply_async(plain_a10,
                                       (STORM_ROUNDS, CHAR_LANES))
    plain_a8_async = pool.apply_async(plain_a8, (PREFIX_A8, CHAR_LANES))
    plain_kevin_async = pool.apply_async(plain_kevin, (KEVIN_PLAIN_LANES,))
    # Configs 2 and 3: their streams (the run-row dry run is ~90 s of
    # config 2's set-up) and A1's plain chains on their first lanes.
    config2_async = pool.apply_async(config_streams, ("2", PLAIN_LANES_A1))
    config3_async = pool.apply_async(config_streams, ("3", PLAIN_LANES_A1))
    # Config sp's run-row dry runs (~13 s for the whole trace).
    sp_plans_async = pool.apply_async(sp_plans)
    log(f"plain checks: {workers} child processes on {ncpu} CPUs "
        f"(os.cpu_count())")

    # -- kernel vs plain version on the card, small shapes ----------------
    worst = 0
    for label, streams, shape, wants, expect_err in compare_cases(
            B, northstar, randedit, TestPatch, np):
        rep = R.make_replayer_rle(streams, device=dev, **shape)
        plain = R.rle_replay_plain(*rep.staged, **rep.shape)
        err = 0
        for warps in (1, 2, 4):
            kern = R.rle_replay_cuda(*rep.staged, **rep.shape, warps=warps)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(kern, plain))
        worst = max(worst, err)
        flags = kern[7][:2].amax(dim=1).tolist()
        if expect_err is None:
            results = rep()
            texts = [SA.to_string(R.rle_to_flat(s, r))
                     for s, r in zip(streams, results)]
            text_ok = texts == wants
        else:
            text_ok = flags[expect_err] == 1
        log(f"compare {label} (1, 2 and 4 warps): max_abs_err {err}, err "
            f"flags {flags}, {'ok' if err == 0 and text_ok else 'FAILED'}")
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
    a1_stats = torch.zeros(shape["groups"], shape["batch"], R.STATS,
                           dtype=torch.int64, device=dev)
    R.rle_replay_cuda(*staged, **shape, stats=a1_stats)
    torch.cuda.synchronize()
    a1_stats = a1_stats[0, 0].tolist()
    a1_warps = {}
    for warps in (1, 2, 4):
        a1_warps[warps] = cuda_ms(torch, lambda: R.rle_replay_cuda(
            *staged, **shape, warps=warps), reps=3)
    a1_geometry = dict(
        thread_blocks=shape["groups"] * shape["batch"], warps=R.WARPS,
        smem=R.kernel_smem_bytes(shape["block_k"],
                                 max(8, shape["capacity"]
                                     // shape["block_k"])))
    log(f"replay counters (lane 0): {R.describe_stats(a1_stats)}; launch "
        f"geometry {a1_geometry}; median at 1, 2, 4 warps a lane: "
        + ", ".join(f"{w}: {t:.3f} ms" for w, t in a1_warps.items()))

    Bn = shape["batch"]
    # Every step with work scans at least one K-row block and the NBL
    # live-prefix slots in every lane: a lower bound on the operations.
    nbytes, nops, active = a1_bound(staged, shape)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = nops / PEAK_OPS_PER_S * 1e3
    log(f"replay: median {ms:.3f} ms over 3 reps after 1 warm-up (CUDA "
        f"events); {ops_per_s:.4g} patches/s ({run.stream.n_patches} x "
        f"{Bn} docs); {active} device steps; plain version {plain_ms:.1f} "
        f"ms; bound {max(bytes_ms, ops_ms):.4f} ms ({bytes_ms:.4f} ms by "
        f"bytes, {ops_ms:.4f} ms by operations); on {card}")

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
        "bound_bytes_ms": bytes_ms,
        "bound_ops_ms": ops_ms,
        "library_ms": None,
        "bytes": nbytes,
        "ops_lower_bound": nops,
        "serial_steps": active,
        "stats": dict(zip(A1_STATS, a1_stats)),
        "geometry": a1_geometry,
        "ms_by_warps": a1_warps,
        "patches_per_s": ops_per_s,
    }
    ns_patches, ns_want = run.stream.patches, run.stream.want

    # -- the north star at 10,240 documents --------------------------------
    ns10k = northstar_10k_phase(torch, dev, card, northstar, R, _kernels,
                                run.results[0])
    del run, res

    # -- the mixed replay against its plain version, small shapes ----------
    mworst = 0
    for label, ops, kw, want, expect_err in mixed_compare_cases(
            B, storm, randedit, TestPatch, np):
        rep = RM.make_replayer_rle_mixed(ops, device=dev, **kw)
        plain = RM.rle_mixed_replay_plain(*rep.staged, **rep.shape)
        mstats = torch.zeros(rep.shape["batch"], RM.STATS,
                             dtype=torch.int64, device=dev)
        kern = RM.rle_mixed_replay_cuda(*rep.staged, **rep.shape,
                                        stats=mstats)
        torch.cuda.synchronize()
        err = max_abs_err(kern, plain)
        mworst = max(mworst, err)
        flags = kern[7][:3].amax(dim=1).tolist()
        if expect_err is None:
            text_ok = flags == [0, 0, 0] and SA.to_string(
                R.rle_to_flat(ops, rep())) == want
        else:
            text_ok = flags[expect_err] == 1
        sv = mstats[0].tolist()
        _, nsm = RM.kernel_smem_bytes(
            rep.shape["block_k"], rep.shape["capacity"] // rep.shape["block_k"],
            max(8, rep.shape["capacity"] // rep.shape["block_k"]),
            rep.shape["capacity"])
        log(f"compare mixed {label}: {ops.num_steps} steps, {nsm} of 5 "
            f"planes in shared memory, fast scans {sv[2]} spanning "
            f"{sv[3] / max(sv[2], 1):.2f} blocks on average and {sv[4]} at "
            f"most, hint misses {sv[1]} of {sv[0]}, max_abs_err "
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
            f"({mbytes} B, {mops} ops: {b_ms:.4f} ms by bytes, "
            f"{o_ms:.4f} ms by operations); on {card}")
        sweep = mixed_warps(torch, dev, RM, staged, shape, name, sst.steps)
        per_variant.append(dict(
            variant=name, steps=sst.steps, char_ops=sst.char_ops,
            batch=shape["batch"], capacity=shape["capacity"], ms=mms,
            plain_ms=mplain_ms, bound_ms=max(b_ms, o_ms),
            bound_by="bytes" if b_ms >= o_ms else "operations",
            bytes=mbytes, ops_lower_bound=mops, char_ops_per_s=rate,
            setup_s=setup_s, **sweep))

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

    # -- configs 2 and 3 on A1 (their streams built in child processes) ------
    cfg2, cfg2_stream = config_phase(
        torch, dev, card, "config 2 (random edits)", config2_async,
        lambda st: random_edits.run_random_edits(stream=st, device=dev),
        lambda st: random_edits.make_random_edits_replayer(st, device=dev),
        R, _kernels, lambda st: len(st.patches))
    cfg3, cfg3_stream = config_phase(
        torch, dev, card, "config 3 (rustcode + sveltecomponent)",
        config3_async,
        lambda st: corpus.run_corpus(stream=st, device=dev),
        lambda st: corpus.make_corpus_replayer(st, device=dev),
        R, _kernels, lambda st: st.n_patches)
    rle_line.update(
        launches_paths={"northstar (512 documents)": rle_line["launches"],
                        "northstar (10,240 documents)": ns10k["launches"],
                        "random_edits (config 2)": cfg2["launches"],
                        "corpus (config 3)": cfg3["launches"]},
        northstar_10k=ns10k, config2=cfg2, config3=cfg3,
        max_abs_err=max(worst, cfg2["max_abs_err"], cfg3["max_abs_err"]),
        matches_plain=max(worst, cfg2["max_abs_err"],
                          cfg3["max_abs_err"]) == 0)
    # -- the per-lane mixed replays against their plain versions, small --
    a6_worst = a7_worst = 0
    cases, two_peer = lanes_cases(B, randedit, common, TestPatch, ListCRDT,
                                  export_txns_since, np)
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
    a6_worst = max(a6_worst, unblocked_edges(torch, dev, True, RL, RLM,
                                             stream))

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
    shards7 = start_5r_shards(pool, stream, B, s5, "blocked",
                              PLAIN_STRIDE_A7)
    shards6 = start_5r_shards(pool, stream, B, s5, "unblocked",
                              PLAIN_STRIDE_A6)
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
    # The kernel chain's outputs on the documents of the plain chain's
    # shards are kept on the CPU; the shards are compared at the end.
    runners7 = stream.make_stream_replayers(s5, device=dev)
    k7 = chain(RLM.lanes_mixed_blocked_replay_cuda, runners7,
               lambda o: o[2:-1])
    torch.cuda.synchronize()
    k7_sub = [[t[:, ::PLAIN_STRIDE_A7].cpu() for t in k] for k in k7]
    log(f"5r blocked chain: its plain chain on {shards7[0]} docs (one in "
        f"{PLAIN_STRIDE_A7}) runs in {len(shards7[1])} shards in child "
        f"processes, compared at the end")
    ms7 = cuda_ms(torch, lambda: chain(RLM.lanes_mixed_blocked_replay_cuda,
                                       runners7, lambda o: o[2:-1]), reps=3)
    # The counters over the whole chain (the most probes: the chain's most).
    a7_stats = torch.zeros(RLM.BLOCKED_STATS, dtype=torch.int64, device=dev)
    a7_most, state = 0, None
    for run in runners7:
        ini = run.initial() if state is None else run.grow(state)
        st = torch.zeros(s5.n_docs, RLM.BLOCKED_STATS, dtype=torch.int64,
                         device=dev)
        out = RLM.lanes_mixed_blocked_replay_cuda(
            *run.staged, *ini, *run.deltas, **run.shape, stats=st)
        a7_stats += st.sum(dim=0)
        a7_most = max(a7_most, int(st[:, 7].max()))
        state = out[2:-1]
    a7_stats = [int(v) for v in a7_stats]
    a7_stats[7] = a7_most
    a7_geometry = RLM.blocked_geometry(s5.n_docs, runners7[-1].capacity, 64,
                                       RLM.BLOCKED_WARPS, dev)
    look, ins = max(a7_stats[1], 1), max(a7_stats[5], 1)
    log(f"5r blocked chain counters (all documents and launches): "
        f"{a7_stats[0]} steps with work; {a7_stats[1]} order lookups "
        f"(hint hits {a7_stats[2] / look:.4f}, forward hops "
        f"{a7_stats[3] / look:.4f}, searches over the blocks in use "
        f"{a7_stats[4] / look:.4f}); {a7_stats[6] / ins:.3f} YATA probes a "
        f"remote insert ({a7_stats[7]} at most); {a7_stats[8]} splits; "
        f"{a7_stats[9] / max(a7_stats[0], 1):.3f} block gathers a step; "
        f"cycle shares: lookups {a7_stats[11] / max(a7_stats[15], 1):.4f}, "
        f"YATA walk {a7_stats[12] / max(a7_stats[15], 1):.4f}, splices "
        f"{a7_stats[13] / max(a7_stats[15], 1):.4f}, deletes "
        f"{a7_stats[14] / max(a7_stats[15], 1):.4f}; "
        f"whole-plane searches passed {a7_stats[18]} blocks in use "
        f"({a7_stats[18] / max(a7_stats[4], 1):.2f} a search); last "
        f"chunk's launch geometry {a7_geometry}")
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
        f"{s5.steps} device steps ({steps7} doc-steps with work); "
        f"bound {max(bb7, bo7):.4f} ms ({bytes7} "
        f"B, {ops7} ops: {bb7:.4f} ms by bytes, {bo7:.4f} ms by "
        f"operations); on {card}")

    # -- the un-blocked kernel on the same stream ----------------------------
    runners6 = stream.make_stream_replayers(s5, engine="unblocked",
                                            device=dev)
    k6 = chain(RLM.lanes_mixed_replay_cuda, runners6, lambda o: o[2:-1])
    torch.cuda.synchronize()
    k6_sub = [[t[:, ::PLAIN_STRIDE_A6].cpu() for t in k] for k in k6]
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
    log(f"compare 5r un-blocked chain against the blocked kernel: origins "
        f"and tables equal {same}, all {s5.n_docs} documents equal "
        f"{same_docs}; its plain chain on {shards6[0]} docs (one in "
        f"{PLAIN_STRIDE_A6}) runs in {len(shards6[1])} shards in child "
        f"processes, compared at the end")
    if not same or not same_docs:
        raise AssertionError("un-blocked kernel disagrees at the 5r shapes")
    ms6 = cuda_ms(torch, lambda: chain(RLM.lanes_mixed_replay_cuda,
                                       runners6, lambda o: o[2:-1]), reps=3)
    b6 = [lanes_bound(r.staged, (r.capacity, r.order_capacity), False, 64,
                      max(8, r.capacity // 64)) for r in runners6]
    bytes6, ops6 = sum(b[0] for b in b6), sum(b[1] for b in b6)
    bb6, bo6 = bytes6 / PEAK_BYTES_PER_S * 1e3, ops6 / PEAK_OPS_PER_S * 1e3
    log(f"5r un-blocked chain: median {ms6:.3f} ms over 3 reps after 1 "
        f"warm-up (CUDA events); {s5.char_ops / (ms6 / 1e3):.4g} "
        f"char-ops/s; {ms6 * 1e3 / sum(s5.real_steps):.3f} us a real step; "
        f"bound {max(bb6, bo6):.4f} ms ({bb6:.4f} ms by bytes, {bo6:.4f} ms "
        f"by operations); on {card}")
    del k6, k7
    sweep6 = lanes_sweep(torch, dev, RL, RLM.lanes_mixed_replay_cuda,
                         runners6, "rle_lanes_mixed", s5.n_docs,
                         "5r un-blocked chain")
    _kernels.reset_launches()
    run6 = stream.run_stream(stream=s5, device=dev, engine="unblocked")
    torch.cuda.synchronize()
    l6_5r = _kernels.launches.get("rle_lanes_mixed", 0)
    log(f"5r path, un-blocked engine: run_stream(engine='unblocked') "
        f"launches {dict(_kernels.launches)}, chunks checked "
        f"{run6.stats.checked}, sampled docs == oracle {run6.ok}")
    if l6_5r != s5.chunks or run6.stats.checked != s5.chunks or not run6.ok:
        raise AssertionError(f"5r path (un-blocked) failed: launches "
                             f"{l6_5r}, oracle {run6.ok}")
    del run6

    # -- the sync_stream example through the un-blocked kernel ---------------
    # Each launch's inputs are kept (the kernel writes only new tensors) so
    # that the same launches can be timed after the counted run.
    launched = []
    a6_kernel = RLM.lanes_mixed_replay_cuda

    def keep(*a, **k):
        launched.append((a, k))
        return a6_kernel(*a, **k)

    RLM.lanes_mixed_replay_cuda = keep
    _kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        counts = sync_stream.run(docs=128, chunks=3, ops_per_chunk=15,
                                 device=dev, log=lambda m: log("  " + m))
        torch.cuda.synchronize()
    finally:
        RLM.lanes_mixed_replay_cuda = a6_kernel
    sync_wall = time.perf_counter() - t0
    l6 = _kernels.launches.get("rle_lanes_mixed", 0)
    sync_launches = dict(_kernels.launches)
    sync_ms = cuda_ms(torch, lambda: [a6_kernel(*a, **k)
                                      for a, k in launched], reps=3)
    log(f"sync_stream: {counts}, launches {sync_launches}, host "
        f"wall {sync_wall:.2f} s; its {len(launched)} A6 launches again: "
        f"median {sync_ms:.3f} ms over 3 reps after 1 warm-up (CUDA "
        f"events); on {card}")
    if l6 < counts["chunks"] or len(launched) != l6:
        raise AssertionError(f"sync_stream ran the un-blocked kernel {l6} "
                             f"times for {counts['chunks']} chunks")
    del launched

    a6_line = {
        "name": "rle_lanes_mixed",
        "route": "cuda",
        "source": "text_crdt_rust_tpu_torch/ops/csrc/rle_lanes_mixed.cu",
        "replaces": "text_crdt_rust_tpu/ops/rle_lanes_mixed.py:105",
        "jax_counterpart":
            "text_crdt_rust_tpu/ops/rle_lanes_mixed.py::_mixed_lanes_kernel",
        "launches": l6_5r,
        "launches_path": "stream.run_stream(engine='unblocked') (config "
                         "5r, one per chunk, where it is timed); "
                         "examples/sync_stream (128 docs x 3 chunks)",
        "launches_sync_stream": l6,
        "sync_stream_ms": sync_ms,
        # Timed at the 5r shapes: the chain of 8 chunk launches. The
        # plain chain's fields are set when its shards are compared.
        "ms": ms6,
        "plain_docs": shards6[0],
        "bound_ms": max(bb6, bo6),
        "bound_by": "bytes" if bb6 >= bo6 else "operations",
        "bound_bytes_ms": bb6,
        "bound_ops_ms": bo6,
        "library_ms": None,
        "bytes": bytes6,
        "ops_lower_bound": ops6,
        **sweep6,
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
        "ms": ms7,
        "plain_docs": shards7[0],
        "bound_ms": max(bb7, bo7),
        "bound_by": "bytes" if bb7 >= bo7 else "operations",
        "bound_bytes_ms": bb7,
        "bound_ops_ms": bo7,
        "library_ms": None,
        "bytes": bytes7,
        "ops_lower_bound": ops7,
        "stats": dict(zip((
            "steps", "lookups", "hint_hits", "hop_hits", "searches",
            "remote_inserts", "probes", "most_probes", "splits", "gathers",
            "verifies", "cycles_lookups", "cycles_yata", "cycles_splices",
            "cycles_deletes", "cycles_all", "blocks_in_use",
            "blocks_holding_runs", "blocks_searched"), a7_stats)),
        "geometry": a7_geometry,
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
    # -- the document server (serve/) on A7 ----------------------------------
    t0 = time.perf_counter()
    serve_fields, serve_worst, serve_wide = serve_phase(
        torch, dev, card, _kernels, RLM, np, pool)
    a7_worst = max(a7_worst, serve_worst)
    a7_line.update(serve_fields)
    a7_line["launches_path"] = ("stream.run_stream (config 5r); the serve "
                                "loadgen runs: see launches_serve")
    log(f"serve phase: {time.perf_counter() - t0:.1f} s")
    # -- ServeConfig()'s document server on the flat kernel --------------------
    t0 = time.perf_counter()
    flat_line, flat_wide, flat_traces = flat_phase(
        torch, dev, card, _kernels, B, randedit, np, pool)
    log(f"flat serve phase: {time.perf_counter() - t0:.1f} s")
    # -- 26a: the trace analytics on the flat runs' kept traces -------------
    analytics_phase(flat_traces, card)
    del flat_traces
    # -- the per-lane local replays and the config-5 path ----------------------
    a4_worst, a5_worst = local_lanes_phase(torch, dev, B, RL, randedit,
                                           TestPatch, np)
    a4_worst = max(a4_worst, unblocked_edges(torch, dev, False, RL, RLM,
                                             stream))
    a4_line, a5_line = config5_phase(torch, dev, card, stream, RL, _kernels,
                                     a4_worst, a5_worst)
    # -- the HBM-plane replay: kevin and the north star on A2 ----------------
    hbm_line = hbm_phase(torch, dev, card, B, R, TH, kevin, northstar,
                         randedit, TestPatch, np, _kernels,
                         plain_kevin_async)
    # -- the per-character block replays: A10, A8, A9 (the main path) ------
    # Their plain checks run in the child processes started at the top.
    a10_line = blocked_a10_phase(torch, dev, card, B, storm, TBL, TBM, np,
                                 _kernels, plain_a10_async)
    a8_line = blocked_a8_phase(torch, dev, card, B, northstar, TBL, TBH,
                               randedit, TestPatch, np, _kernels,
                               plain_a8_async)
    a9_line = blocked_a9_phase(torch, dev, card, B, northstar, TBL, TBH,
                               randedit, TestPatch, np, _kernels,
                               plain_a9_async)
    # -- the wide serve run's sampled launches, then the 5r plain chains ------
    e, secs = check_serve_wide(torch, serve_wide)
    a7_worst = max(a7_worst, e)
    a7_line.update(serve_wide_plain_launches=len(secs),
                   serve_wide_plain_s=secs)
    log(f"compare serve wide launches: max_abs_err {e} over {len(secs)} "
        f"launches against the plain version")
    if e != 0:
        raise AssertionError("A7 disagrees with its plain version on the "
                             "wide serve launches")
    e, secs = check_flat_wide(flat_wide)
    flat_line.update(wide_plain_launches=len(secs), wide_plain_s=secs,
                     max_abs_err=max(flat_line["max_abs_err"], e))
    log(f"compare flat wide launches: max_abs_err {e} over {len(secs)} "
        f"launches against the plain version")
    if e != 0:
        raise AssertionError("the flat kernel disagrees with its plain "
                             "version on the wide serve launches")
    for line, label, shards, k_sub, names, worst in (
            (a7_line, "5r blocked chain (A7)", shards7, k7_sub, A7_OUTPUTS,
             a7_worst),
            (a6_line, "5r un-blocked chain (A6)", shards6, k6_sub,
             A6_OUTPUTS, a6_worst)):
        e, secs = check_5r_shards(torch, label, shards, k_sub, names)
        worst = max(worst, e)
        log(f"compare {label}: max_abs_err {e} over {s5.chunks} chunks "
            f"against its plain version on {shards[0]} docs; plain chain "
            f"{sum(secs):.1f} s over {len(secs)} shards "
            f"({[round(x, 1) for x in secs]} s)")
        line.update(matches_plain=worst == 0, max_abs_err=worst,
                    plain_ms=sum(secs) * 1e3,
                    plain_shard_s=secs)
        if e != 0:
            raise AssertionError(f"{label} disagrees with its plain version "
                                 f"at the 5r shapes")
    sp_plan_list = sp_plans_async.get()
    pool.close()
    pool.join()

    # -- the native single-core baseline, no child process running -------------
    t0 = time.perf_counter()
    ns_lists = baseline.patch_lists(ns_patches)
    ns_cols = baseline.patch_columns(ns_patches)
    five, five_contents = stream.generate_5(n_docs=1)
    five_lists = baseline.patch_lists(
        [p for per_doc in five for p in per_doc[0]])
    cfg2_lists = baseline.patch_lists(cfg2_stream.patches)
    k_cols = kevin.kevin_columns(KEVIN_NATIVE)
    n_kevin = len(k_cols[0])
    cells = [
        ("config 1 / north star: automerge-paper on the native engine",
         lambda: baseline.replay_trace(ns_lists), len(ns_patches),
         "patches", lambda d: d.to_string() == ns_want, BASELINE_REPS),
        ("config 1: automerge-paper on the rope (text only)",
         # bench.py's rope timing: u32 columns, no text read back.
         lambda: baseline.rope_replay(*ns_cols, want_content=False)[0],
         len(ns_patches), "patches",
         lambda n: n == len(ns_want)
         and baseline.rope_text(ns_cols) == ns_want, BASELINE_REPS),
    ]
    for (name, _), r in zip(variants, runs):
        cells.append((f"config 4: {name}",
                      lambda txns=r.stream.txns:
                      baseline.native_remote_replay(txns),
                      r.stream.char_ops, "char-ops",
                      lambda d, want=r.stream.want: d.to_string() == want,
                      BASELINE_REPS))
    cells += [
        ("config 5r: document 0's txns",
         lambda: baseline.native_remote_replay(s5.all_txns[0]),
         sum(common.txn_len(t) for t in s5.all_txns[0]), "char-ops",
         lambda d: d.to_string() == s5.contents[0], BASELINE_REPS),
        ("config 5: document 0's patches",
         lambda: baseline.replay_trace(five_lists), len(five_lists[0]),
         "patches", lambda d: d.to_string() == five_contents[0],
         BASELINE_REPS),
        ("config 2: random edits",
         lambda: baseline.replay_trace(cfg2_lists),
         len(cfg2_stream.patches), "patches",
         lambda d: d.to_string() == cfg2_stream.want, BASELINE_REPS),
    ]
    for name, ps, want in zip(cfg3_stream.names, cfg3_stream.patches,
                              cfg3_stream.wants):
        cells.append((f"config 3: {name}",
                      lambda cols=baseline.patch_lists(ps):
                      baseline.replay_trace(cols), len(ps),
                      "patches", lambda d, want=want: d.to_string() == want,
                      BASELINE_REPS))
    cells.append((f"kevin: {n_kevin} prepends",
                  lambda: baseline.replay_trace(k_cols), n_kevin,
                  "prepends",
                  lambda d: len(d) == n_kevin
                  and d.to_string() == " " * n_kevin, KEVIN_REPS))
    native = baseline_phase(cells)
    ns_native = native[cells[0][0]]["ops_per_s"]
    ratios = {
        "northstar (512 documents)": rle_line["patches_per_s"] / ns_native,
        "northstar (10,240 documents)": ns10k["patches_per_s"] / ns_native,
        "config 2": cfg2["patches_per_s"]
        / native["config 2: random edits"]["ops_per_s"],
        "config 3": cfg3["patches_per_s"] / statistics.mean(
            native[f"config 3: {n}"]["ops_per_s"]
            for n in cfg3_stream.names),
        "config 4, insert storm": mixed_line["variants"][0]["char_ops_per_s"]
        / native["config 4: insert storm"]["ops_per_s"],
        "config 4, delete-heavy storm":
            mixed_line["variants"][1]["char_ops_per_s"]
            / native["config 4: delete-heavy storm"]["ops_per_s"],
        "config 5r": a7_line["char_ops_per_s"]
        / native["config 5r: document 0's txns"]["ops_per_s"],
        "config 5": a5_line["patches_per_s"]
        / native["config 5: document 0's patches"]["ops_per_s"],
        "kevin": hbm_line["prepends_per_s"]
        / native[f"kevin: {n_kevin} prepends"]["ops_per_s"],
    }
    for k, v in ratios.items():
        log(f"ratio {k}: {v:.1f}x the native engine's single-core rate "
            f"(device rate over native rate; this run's measurements)")
    log(f"native baseline phase: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"native_baseline": native, "ratios": ratios},
                   default=str))
    # -- config sp: parallel/ and ops/stream_scan on the card ----------------
    a1_sp, f1_sp, s1_line = sp_phase(torch, dev, card, np, _kernels, F,
                                     sp_plan_list)
    rle_line.update(a1_sp)
    flat_line.update(f1_sp)
    s1_line["ptxas"] = [ln.strip() for ln in reports.get(
        "sp_replay", "").splitlines() if "registers" in ln or "spill" in ln]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to "
        f"end")
    log(json.dumps({"kernels": [rle_line, mixed_line, a6_line, a7_line,
                                a4_line, a5_line, hbm_line, a8_line,
                                a9_line, a10_line, flat_line,
                                s1_line]},
                    default=str))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
