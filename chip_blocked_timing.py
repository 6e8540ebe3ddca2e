"""Time the redesigned kernels (A1-A10) on one NVIDIA card.

    python3 chip_blocked_timing.py [tests] [a10] [a8] [a9] [a2] [a3] [a4]
        [a6] [a1] [a7] [a5] [serve] [flat] [configs] [sp] [sp-times]
        [sp-threads] [l2] [--reps N] [--parent DIR]

A quicker loop than ``chip_smoke.py`` while redesigning those kernels:
it builds them (printing ptxas's registers and spills), then runs the
named phases, all by default:

- ``tests``: the card tests of the seven kernels
  (``tests/test_torch_cuda.py -k "blocked or hbm or mixed_kernel or
  lanes"``, against their plain versions);
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
  windows span;
- ``a4``: config 5 (2,048 documents x 8 chunks x 100 local patches)
  through ``run_stream_5(engine="unblocked")``, the chain of 8 A4
  launches against its plain chain on all documents, then the chain's
  median time at 1, 2, 4 and 8 documents (warps) a thread block, with
  each launch geometry (layout, blocks an SM holds, waves) and the
  columns' extents;
- ``a6``: config 5r (2,048 documents x 8 chunks x 100 patches) through
  ``run_stream(engine="unblocked")``, the chain of 8 A6 launches against
  its plain chain on every 64th document, then the chain's median time
  at 1, 2, 4 and 8 warps, the geometry, the extents and the YATA probes
  per remote insert (mean and most);
- ``a1``: the north star on A1 (512 documents, K = 128) against its plain
  version, its counters, and its median time at 1, 2 and 4 warps;
- ``a7``: config 5r through ``run_stream()``, the chain of 8 A7 launches
  against its plain chain on every 256th document, its counters summed
  over the chain, and its median time at 1-4 documents a thread block
  and on every 16th document alone;
- ``a5``: config 5 (2,048 documents x 8 chunks x 100 local patches)
  through ``run_stream_5()``, the chain of 8 A5 launches against its
  plain chain on all documents, its counters summed over the chain, and
  its median time at 1-4 documents a thread block, with the rows in
  shared memory and in device memory, and on every 16th document alone;
  each chain also timed with its launches queued ahead of the card (a
  sleep kernel first), which leaves out the gaps in which the card waits
  for the host between launches;
- ``serve``: the serve lanes backend's card tests (``-k
  serve_lanes_backend``), then ``chip_smoke.py``'s serve phase (the
  document server on A7: the acceptance shape at pipeline depths 1 and 2
  against the JAX package's golden record, the wide shape, A7 against
  its plain version on sampled serve launches);
- ``flat``: the flat kernel's card tests (``-k flat``); the kernel's
  ptxas registers and spills for each build (with and without
  counters); then every launch of the serve acceptance shape at depth 1,
  at depth 2 with trains of 4 and of the wide shape, recorded and
  re-launched on their inputs: ms summed over the launches and us a
  device step, beside the kernel of ``--parent-source`` on the same
  inputs, a ``flat_replay.cu`` with the one-block-a-lane interface of
  ``PARENT_FLAT_ABI`` (``git show 24d2bd8:text_crdt_rust_tpu_torch/ops/
  csrc/flat_replay.cu > _scratch/parent_flat_replay.cu``; any other is
  refused), in the order parent, change, change, parent, every output
  compared; the counting build's shares over those launches; then
  ``chip_smoke.py``'s flat
  phase (``ServeConfig()``'s document server on the flat kernel: its
  small cases, the acceptance shape at depth 1 and at depth 2 with
  trains of 1 and 4 against the JAX package's golden record, the wide
  shape, the kernel against its plain version on sampled launches, crash
  recovery, ``DeviceMirror`` and a profiler capture), then its phase 26a
  (the trace analytics on the depth-1 and depth-2 acceptance runs' kept
  traces);
- ``configs``: A1's card tests at configs 2 and 3's shapes and at 20
  doc groups (``-k "config2 or config3 or groups-20"``), then
  ``chip_smoke.py``'s phases on A1 at the new shapes: the north star at
  10,240 documents (512 x 20 groups) against the 512-document run, configs
  2 and 3 (their streams and plain chains built in child processes), and
  the native baseline of configs 1, 2 and 3 and kevin with no child
  running;
- ``sp``: the long-context card tests (``-k "sp_doc or sp_kernel or
  streamed"``: S1 against the plain version at sp = 1 and 2, the tile
  index's edge cases and full passes, the ``stats`` build), which
  collectives gloo takes on CUDA tensors, S1's ptxas registers and
  spills (main and ``stats`` builds),
  then ``sp-times``, then ``chip_smoke.py``'s phase 27b alone: config
  ``sp`` at sp = 1 over NCCL on S1 (the whole trace, its first and last
  chunks against the plain version, the 20,000-patch prefix, A1's
  parity), the four-rank world (one NCCL rank a card on a machine with
  four, else four processes sharing the card over gloo; S1 a segment,
  each chunk against the plain version), the sharded flat apply, the dry
  run and ``StreamedRuns`` on a 2^27-row memmapped plane, and S1's entry
  of the kernels line;
- ``l2``: what one SM gets from the memory system (``L2_PROBE_SRC``):
  one block's barrier and a dependent L2 load in cycles, and the rates
  of coalesced int4 reads, writes and reads-then-writes of the same rows
  in bytes a cycle, at 256, 512 and 1,024 threads;
- ``sp-times``: S1 on config ``sp``: the whole trace's 4 chunks, each
  from its input state (CUDA events, median of ``--reps``, summed) and
  us a step, the 20,000-patch prefix at sp = 1, a digest of each run's
  outputs, and the prefix at sp = 4 (ms a step of the replay's wall,
  rank 0's S1 time; NCCL one rank a card where the machine has four
  cards, else four processes sharing one over gloo); this checkout's
  thread count a block and its ``stats`` shares over the whole trace. With
  ``--parent DIR`` (a checkout of another commit, e.g. ``git archive
  PARENT | tar -x -C _scratch/parent``; ``_scratch/`` is gitignored but
  copied to the card) the same measurements run in that checkout, in a
  process of their own that imports its package and builds its kernel
  through its own wrapper, in the order parent, this, this, parent; the
  digests must agree.
- ``sp-threads``: the experiment that chose S1's threads a block:
  ``sp_replay.cu`` built at 256, 512 and 1,024 threads (``-DSP_THREADS``,
  beside the committed build), each timed on the whole trace's 4 chunks
  as ``sp-times`` times them, with its ptxas registers and spills and
  whether its outputs equal the committed build's.

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
import json
import re
import statistics
import subprocess
import sys
import time


def cuda_ms(torch, fn, reps: int, queued: bool = False) -> float:
    """Median time of ``fn`` over ``reps`` runs after 1 warm-up, CUDA
    events. ``queued``: a 50 ms sleep kernel is queued before each run, so
    that the host has queued all of ``fn``'s launches before the card
    reaches them: the time is then the card's alone, without the gaps in
    which it waits for the host between launches."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(100_000_000)
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


def run_chain(fn, runners, **kw):
    """The chunk launches of a stream, the state grown between them.
    Returns every chunk's outputs."""
    outs, state = [], None
    for run in runners:
        ini = run.initial() if state is None else run.grow(state)
        out = fn(*run.staged, *ini, *getattr(run, "deltas", ()), **run.shape,
                 **kw)
        outs.append(out)
        state = out[2:-1]
    return outs


def chain_equal(torch, kern, plain, stride=1) -> bool:
    return all(torch.equal(k[:, ::stride].cpu(), p.cpu())
               for ko, po in zip(kern, plain) for k, p in zip(ko, po))


def doc_subset(stream, s5, stride: int):
    """A config-5 or 5r stream cut to every ``stride``-th document."""
    from text_crdt_rust_tpu_torch.ops import batch as B

    return type(s5)(**{
        **vars(s5), "n_docs": len(range(0, s5.n_docs, stride)),
        "stacked": [B.OpTensors(**{k: v[:, ::stride]
                                   for k, v in vars(st).items()})
                    for st in s5.stacked]})


def lanes_sweep(torch, dev, wrapper, runners, label, real_steps, reps,
                kernel, n_docs, sub_runners):
    """Time a chain of un-blocked lane launches at 1, 2, 4 and 8 warps, with
    each launch geometry of its last chunk, and on every 16th document
    alone (``sub_runners``: how fast one document's chain runs with an SM
    nearly to itself), and print its counters."""
    from text_crdt_rust_tpu_torch.ops import rle_lanes as RL

    ms = cuda_ms(torch, lambda: run_chain(wrapper, runners), reps)
    print(f"{label}: {ms:.3f} ms, {ms * 1e3 / real_steps:.3f} us a real "
          f"step", flush=True)
    ms = cuda_ms(torch, lambda: run_chain(wrapper, sub_runners), reps)
    print(f"{label}: every 16th document alone ({len(range(0, n_docs, 16))} "
          f"documents, about one an SM): {ms:.3f} ms, "
          f"{ms * 1e3 / real_steps:.3f} us a real step", flush=True)
    if not takes(wrapper, "warps"):
        return
    last = runners[-1]
    n_stats = sys.modules[wrapper.__module__].STATS
    stats = torch.zeros(n_docs, n_stats, dtype=torch.int64, device=dev)
    state = None
    for run in runners:
        ini = run.initial() if state is None else run.grow(state)
        kw = dict(stats=stats) if run is last else {}
        out = wrapper(*run.staged, *ini, *getattr(run, "deltas", ()),
                      **run.shape, **kw)
        state = out[2:-1]
    torch.cuda.synchronize()
    ext = stats[:, 1].float()
    print(f"{label}: last chunk (capacity {last.capacity}): extent at its "
          f"end mean {ext.mean():.1f}, most {int(ext.max())} rows; at its "
          f"start mean {stats[:, 0].float().mean():.1f}; "
          f"{int(stats[:, -1].sum())} of {n_docs} columns end in shared "
          f"memory", flush=True)
    if n_stats >= 5:
        ins, probes = int(stats[:, 2].sum()), int(stats[:, 3].sum())
        print(f"{label}: last chunk: {ins} remote inserts, "
              f"{probes / max(ins, 1):.3f} YATA probes an insert on "
              f"average, {int(stats[:, 4].max())} at most", flush=True)
    for warps in (1, 2, 4, 8):
        geo = RL.launch_geometry(kernel, n_docs, last.capacity, warps, dev)
        ms = cuda_ms(torch, lambda: run_chain(wrapper, runners, warps=warps),
                     reps)
        print(f"{label}: {warps} warps, {ms:.3f} ms, "
              f"{ms * 1e3 / real_steps:.3f} us a real step; last chunk "
              f"{geo}", flush=True)
    print(f"{label}: the wrapper's choice: {RL.WARPS} warps, "
          f"{RL.launch_geometry(kernel, n_docs, last.capacity, RL.WARPS, dev)}"
          , flush=True)


def phase_a4(torch, dev, reps):
    from text_crdt_rust_tpu_torch import stream
    from text_crdt_rust_tpu_torch.ops import _kernels
    from text_crdt_rust_tpu_torch.ops import rle_lanes as RL

    s5 = stream.make_stream_5()
    _kernels.reset_launches()
    run = stream.run_stream_5(stream=s5, device=dev, engine="unblocked")
    torch.cuda.synchronize()
    print(f"A4 config 5: launches {dict(_kernels.launches)}, texts ok "
          f"{run.ok}", flush=True)
    del run
    runners = stream.stream_replayers_5(s5, engine="unblocked", device=dev)
    kern = run_chain(RL.lanes_replay_cuda, runners)
    plain = run_chain(RL.lanes_replay_plain, runners)
    ok = chain_equal(torch, kern, plain)
    print(f"A4 config 5: the chain equals its plain chain on all "
          f"{s5.n_docs} documents: {ok}", flush=True)
    del kern, plain
    lanes_sweep(torch, dev, RL.lanes_replay_cuda, runners, "A4 config 5",
                sum(s5.real_steps), reps, "rle_lanes", s5.n_docs,
                stream.stream_replayers_5(doc_subset(stream, s5, 16),
                                          engine="unblocked", device=dev))
    if not ok:
        raise AssertionError("A4 disagrees with its plain version")


def phase_a6(torch, dev, reps):
    from text_crdt_rust_tpu_torch import stream
    from text_crdt_rust_tpu_torch.ops import _kernels
    from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as RLM

    s5 = stream.make_stream_5r()
    _kernels.reset_launches()
    run = stream.run_stream(stream=s5, device=dev, engine="unblocked")
    torch.cuda.synchronize()
    print(f"A6 5r: launches {dict(_kernels.launches)}, sampled docs ok "
          f"{run.ok}", flush=True)
    del run
    runners = stream.make_stream_replayers(s5, engine="unblocked",
                                           device=dev)
    stride = 64
    sub = doc_subset(stream, s5, stride)
    kern = run_chain(RLM.lanes_mixed_replay_cuda, runners)
    plain = run_chain(RLM.lanes_mixed_replay_plain,
                      stream.make_stream_replayers(sub, engine="unblocked",
                                                   device=dev))
    ok = chain_equal(torch, kern, plain, stride)
    print(f"A6 5r: the chain equals its plain chain on every {stride}th "
          f"document ({sub.n_docs}): {ok}", flush=True)
    del kern, plain
    lanes_sweep(torch, dev, RLM.lanes_mixed_replay_cuda, runners, "A6 5r",
                sum(s5.real_steps), reps, "rle_lanes_mixed", s5.n_docs,
                stream.make_stream_replayers(doc_subset(stream, s5, 16),
                                             engine="unblocked",
                                             device=dev))
    if not ok:
        raise AssertionError("A6 disagrees with its plain version")


def phase_a1(torch, dev, reps):
    """The north star on A1 (512 documents, K = 128) through its entry
    point, then the replay's median time at 1, 2 and 4 warps a lane, with
    its counters."""
    from text_crdt_rust_tpu_torch import northstar
    from text_crdt_rust_tpu_torch.ops import rle as R

    run = northstar.run_northstar(device=dev)
    torch.cuda.synchronize()
    print(f"A1 north star: text ok {run.ok}", flush=True)
    rep = northstar.make_northstar_replayer(run.stream, device=dev)
    del run
    steps = int(((rep.staged[1] > 0) | (rep.staged[2] > 0)).sum())
    kern = R.rle_replay_cuda(*rep.staged, **rep.shape)
    plain = R.rle_replay_plain(*rep.staged, **rep.shape)
    ok = all(torch.equal(k, p) for k, p in zip(kern, plain))
    print(f"A1 north star: the replay equals its plain version on all "
          f"{rep.shape['batch']} lanes: {ok}", flush=True)
    del kern, plain

    def fn(**kw):
        return R.rle_replay_cuda(*rep.staged, **rep.shape, **kw)

    stats = stats_for(torch, R.rle_replay_cuda, fn,
                      (rep.shape["groups"], rep.shape["batch"]),
                      getattr(R, "STATS", 0), dev)
    if stats is not None:
        print(f"A1 north star: {R.describe_stats(stats[0, 0].tolist())}",
              flush=True)
    time_warps(torch, R.rle_replay_cuda, fn, "A1 north star", steps,
               (1, 2, 4), reps)
    if not ok:
        raise AssertionError("A1 disagrees with its plain version")


def a7_stats_line(v) -> str:
    """One line of the blocked kernel's counters ``v`` (summed over the
    documents and launches of a chain)."""
    look = max(v[1], 1)
    ins = max(v[5], 1)
    tot = max(v[15], 1)
    return (f"{v[0]} steps with work; {v[1]} order lookups: hint hits "
            f"{v[2] / look:.4f}, forward-hop hits {v[3] / look:.4f}, "
            f"whole-plane searches {v[4] / look:.4f}; {v[5]} remote inserts, "
            f"{v[6] / ins:.3f} YATA probes an insert, {v[7]} at most; "
            f"{v[8]} splits; {v[9] / max(v[0], 1):.3f} block gathers and "
            f"{v[10] / max(v[0], 1):.3f} block verifies a step; cycle "
            f"shares: lookups {v[11] / tot:.4f}, YATA walk (its lookups "
            f"included) {v[12] / tot:.4f}, inserts' splices "
            f"{v[13] / tot:.4f}, deletes {v[14] / tot:.4f}; "
            f"{tot / max(v[0], 1):.0f} cycles a step with work"
            + ("" if len(v) <= 16 else
               f"; blocks in use at the ends of the launches {v[16]}, "
               f"holding a run {v[17]}; whole-plane searches passed "
               f"{v[18]} blocks ({v[18] / max(v[4], 1):.2f} a search)"))


def phase_a7(torch, dev, reps):
    """Config 5r (2,048 documents x 8 chunks x 100 patches) through
    ``run_stream()``, the chain of 8 A7 launches against its plain chain
    on every 256th document, its counters, then the chain's median time
    at 1-4 documents a thread block and on every 16th document alone."""
    from text_crdt_rust_tpu_torch import stream
    from text_crdt_rust_tpu_torch.ops import _kernels
    from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as RLM

    s5 = stream.make_stream_5r()
    _kernels.reset_launches()
    run = stream.run_stream(stream=s5, device=dev)
    torch.cuda.synchronize()
    print(f"A7 5r: launches {dict(_kernels.launches)}, sampled docs ok "
          f"{run.ok}", flush=True)
    del run
    runners = stream.make_stream_replayers(s5, device=dev)
    wrapper = RLM.lanes_mixed_blocked_replay_cuda
    stride = 256
    sub = doc_subset(stream, s5, stride)
    kern = run_chain(wrapper, runners)
    plain = run_chain(RLM.lanes_mixed_blocked_replay_plain,
                      stream.make_stream_replayers(sub, device=dev))
    ok = chain_equal(torch, kern, plain, stride)
    print(f"A7 5r: the chain equals its plain chain on every {stride}th "
          f"document ({sub.n_docs}): {ok}", flush=True)
    del kern, plain
    real = sum(s5.real_steps)
    n_stats = getattr(RLM, "BLOCKED_STATS", 0)
    if takes(wrapper, "stats") and n_stats:
        total = torch.zeros(n_stats, dtype=torch.int64, device=dev)
        most, state = 0, None
        for run in runners:
            ini = run.initial() if state is None else run.grow(state)
            st = torch.zeros(s5.n_docs, n_stats, dtype=torch.int64,
                             device=dev)
            out = wrapper(*run.staged, *ini, *run.deltas, **run.shape,
                          stats=st)
            state = out[2:-1]
            total += st.sum(dim=0)
            most = max(most, int(st[:, 7].max()))
        v = [int(x) for x in total]
        v[7] = most
        print(f"A7 5r chain, all documents and launches: "
              f"{a7_stats_line(v)}", flush=True)
        if hasattr(RLM, "blocked_geometry"):
            last = runners[-1]
            print("A7 5r last chunk: " + str(RLM.blocked_geometry(
                s5.n_docs, last.capacity, 64, RLM.BLOCKED_WARPS, dev)),
                flush=True)
    ms = cuda_ms(torch, lambda: run_chain(wrapper, runners), reps)
    print(f"A7 5r: {ms:.3f} ms, {ms * 1e3 / real:.3f} us a real step",
          flush=True)
    alone = stream.make_stream_replayers(doc_subset(stream, s5, 16),
                                         device=dev)
    ms = cuda_ms(torch, lambda: run_chain(wrapper, alone), reps)
    print(f"A7 5r: every 16th document alone "
          f"({len(range(0, s5.n_docs, 16))} documents, about one an SM): "
          f"{ms:.3f} ms, {ms * 1e3 / real:.3f} us a real step", flush=True)
    if takes(wrapper, "warps"):
        for warps in (1, 2, 3, 4):
            ms = cuda_ms(torch, lambda: run_chain(wrapper, runners,
                                                  warps=warps), reps)
            print(f"A7 5r: {warps} documents a block, {ms:.3f} ms, "
                  f"{ms * 1e3 / real:.3f} us a real step", flush=True)

    if not ok:
        raise AssertionError("A7 disagrees with its plain version")


def phase_a5(torch, dev, reps):
    """Config 5 (2,048 documents x 8 chunks x 100 local patches) through
    ``run_stream_5()``, the chain of 8 A5 launches against its plain chain
    on all documents, its counters, then the chain's median time at 1-4
    documents a thread block (with the rows in shared memory and in
    device memory, where the wrapper offers both) and on every 16th
    document alone."""
    from text_crdt_rust_tpu_torch import stream
    from text_crdt_rust_tpu_torch.ops import _kernels
    from text_crdt_rust_tpu_torch.ops import rle_lanes as RL

    s5 = stream.make_stream_5()
    _kernels.reset_launches()
    run = stream.run_stream_5(stream=s5, device=dev)
    torch.cuda.synchronize()
    print(f"A5 config 5: launches {dict(_kernels.launches)}, texts ok "
          f"{run.ok}", flush=True)
    del run
    runners = stream.stream_replayers_5(s5, device=dev)
    wrapper = RL.lanes_blocked_replay_cuda
    kern = run_chain(wrapper, runners)
    plain = run_chain(RL.lanes_blocked_replay_plain, runners)
    ok = chain_equal(torch, kern, plain)
    print(f"A5 config 5: the chain equals its plain chain on all "
          f"{s5.n_docs} documents: {ok}", flush=True)
    del kern, plain
    real = sum(s5.real_steps)
    n_stats = getattr(RL, "BLOCKED_STATS", 0)
    if takes(wrapper, "stats") and n_stats:
        total = torch.zeros(n_stats, dtype=torch.int64, device=dev)
        state = None
        for run in runners:
            ini = run.initial() if state is None else run.grow(state)
            st = torch.zeros(s5.n_docs, n_stats, dtype=torch.int64,
                             device=dev)
            state = wrapper(*run.staged, *ini, **run.shape, stats=st)[2:-1]
            total += st.sum(dim=0)
        print(f"A5 config 5 chain, all documents and launches: "
              f"{RL.describe_blocked_stats(total.tolist())}", flush=True)
    ms = cuda_ms(torch, lambda: run_chain(wrapper, runners), reps)
    print(f"A5 config 5: {ms:.3f} ms, {ms * 1e3 / real:.3f} us a real step",
          flush=True)
    alone = stream.stream_replayers_5(doc_subset(stream, s5, 16), device=dev)
    ms = cuda_ms(torch, lambda: run_chain(wrapper, alone), reps)
    print(f"A5 config 5: every 16th document alone "
          f"({len(range(0, s5.n_docs, 16))} documents, about one an SM): "
          f"{ms:.3f} ms, {ms * 1e3 / real:.3f} us a real step", flush=True)
    ms = cuda_ms(torch, lambda: run_chain(wrapper, runners), reps,
                 queued=True)
    print(f"A5 config 5: {ms:.3f} ms with the launches queued ahead (the "
          f"card's time alone)", flush=True)
    if takes(wrapper, "warps"):
        places = (True, False) if takes(wrapper, "on_chip") else (None,)
        for on_chip in places:
            kw = {} if on_chip is None else dict(on_chip=on_chip)
            where = {None: "", True: ", rows in shared memory",
                     False: ", rows in device memory"}[on_chip]
            for warps in (1, 2, 3, 4):
                ms = cuda_ms(torch, lambda: run_chain(
                    wrapper, runners, warps=warps, **kw), reps)
                mq = cuda_ms(torch, lambda: run_chain(
                    wrapper, runners, warps=warps, **kw), reps, queued=True)
                print(f"A5 config 5: {warps} documents a block{where}, "
                      f"{ms:.3f} ms, {ms * 1e3 / real:.3f} us a real step; "
                      f"queued ahead {mq:.3f} ms", flush=True)
    if not ok:
        raise AssertionError("A5 disagrees with its plain version")


def main(argv=None) -> int:
    phases = ("tests", "a10", "a8", "a9", "a2", "a3", "a4", "a6", "a1",
              "a7", "a5", "serve", "flat", "configs", "sp", "sp-times",
              "sp-threads", "l2")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="*", help=f"any of {phases} (all)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--parent-source", default=None,
                    help="a flat_replay.cu with PARENT_FLAT_ABI's interface, "
                         "timed beside this one in the flat phase")
    ap.add_argument("--parent", default=None,
                    help="a checkout of another commit whose S1 is timed "
                         "beside this one (sp, sp-times)")
    ap.add_argument("--sp4", action="store_true",
                    help="sp, sp-times: also the prefix at sp = 4 (NCCL on "
                         "a machine with four cards)")
    ap.add_argument("--json", action="store_true",
                    help="sp-times only: print its record as one JSON line "
                         "and nothing else of the phases")
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

    if args.json:
        print(SP_TIMES_TAG + json.dumps(sp_times(torch, torch.device(
            "cuda"), args.reps, args.sp4)), flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    reports = _kernels.build([n for n in (
        "blocked_replay", "blocked_hbm_replay", "blocked_mixed_replay",
        "rle_hbm_replay", "rle_mixed_replay", "rle_lanes", "rle_lanes_mixed",
        "rle_replay", "rle_lanes_mixed_blocked", "rle_lanes_blocked",
        "flat_replay")
        if n in _kernels.sources()])
    for name, report in reports.items():
        print(name, [line.strip() for line in report.splitlines()
                     if "registers" in line or "spill" in line
                     or "entry function" in line], flush=True)
    dev = torch.device("cuda")

    if "tests" in args.phases:
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
             "-q", "-x", "tests/test_torch_cuda.py", "-k",
             "blocked or hbm or mixed_kernel or lanes", "-p",
             "no:cacheprovider"],
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
    if "a4" in args.phases:
        phase_a4(torch, dev, args.reps)
    if "a6" in args.phases:
        phase_a6(torch, dev, args.reps)
    if "a1" in args.phases:
        phase_a1(torch, dev, args.reps)
    if "a7" in args.phases:
        phase_a7(torch, dev, args.reps)
    if "a5" in args.phases:
        phase_a5(torch, dev, args.reps)
    if "serve" in args.phases:
        phase_serve(torch, dev)
    if "flat" in args.phases:
        phase_flat(torch, dev, reports.get("flat_replay", ""),
                   args.parent_source, args.reps)
    if "configs" in args.phases:
        phase_configs(torch, dev)
    if "l2" in args.phases:
        phase_l2(torch)
    if "sp" in args.phases or "sp-times" in args.phases:
        phase_sp(torch, dev, args.reps, args.parent, args.sp4,
                 tests_and_smoke="sp" in args.phases)
    if "sp-threads" in args.phases:
        phase_sp_threads(torch, dev, args.reps)
    return 0


def phase_serve(torch, dev) -> None:
    import multiprocessing

    import numpy as np

    import chip_smoke
    from text_crdt_rust_tpu_torch.ops import _kernels
    from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as RLM

    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
         "-q", "tests/test_torch_cuda.py", "-k", "serve_lanes_backend",
         "-p", "no:cacheprovider"], capture_output=True, text=True)
    print(r.stdout[-3000:], r.stderr[-2000:], flush=True)
    card = chip_smoke.card_line()
    pool = multiprocessing.get_context("spawn").Pool(4)
    try:
        t0 = time.perf_counter()
        fields, worst, pending = chip_smoke.serve_phase(
            torch, dev, card, _kernels, RLM, np, pool)
        e, secs = chip_smoke.check_serve_wide(torch, pending)
        print(f"serve phase: {time.perf_counter() - t0:.1f} s, max_abs_err "
              f"{max(worst, e)}; {json.dumps(fields, default=str)}",
              flush=True)
    finally:
        pool.terminate()
    if r.returncode != 0 or max(worst, e) != 0:
        raise SystemExit(1)


def ptxas_table(report: str, kernel: str, stack: bool = False):
    """(entry, registers, spill stores, spill loads) of each entry of
    ``kernel`` in an ``nvcc -Xptxas -v`` report, and its stack frame in
    bytes last where ``stack``."""
    rows, entry = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None or kernel not in entry:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = int(m.group(1))
            spills = (int(m.group(2)), int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            t = re.search(r"ILb([01])E", entry)
            name = (("counters" if t.group(1) == "1" else "main build")
                    if t else "one block a lane (parent)")
            rows.append((name, int(m.group(1))) + spills
                        + ((frame,) if stack else ()))
            entry = None
    return rows


#: The C interface ``parent_flat_kernel`` calls: the one-block-a-lane F1
#: (``flat_replay.cu`` before its Hopper redesign), whitespace collapsed.
PARENT_FLAT_ABI = (
    'extern "C" int flat_replay_launch(int* signed_, int* ol, int* orr, '
    'const int* rank, int* n, int* next_order, const int* ops, '
    'const int* active, int* flags, int T, int S, int B, int CAP, '
    'int OCAP, int LMAX, int smem, void* stream)')


def parent_flat_kernel(torch, src: str):
    """The parent commit's flat kernel, built from its source beside this
    one's (nvcc, the same flags), as a callable with
    ``flat_replay_cuda``'s positional arguments; and its ptxas report.
    Refuses, before any build, a source whose launch function is not
    ``PARENT_FLAT_ABI``: ctypes would call it with the wrong arguments."""
    import ctypes
    import os

    from text_crdt_rust_tpu_torch.ops import _kernels

    text = open(src).read()
    m = re.search(r'extern "C" int flat_replay_launch\([^)]*\)', text)
    if m is None or " ".join(m.group(0).split()) != PARENT_FLAT_ABI:
        raise SystemExit(f"{src}: flat_replay_launch is not the interface "
                         f"--parent-source takes ({PARENT_FLAT_ABI})")
    out = os.path.join(str(_kernels.BUILD), "libparent_flat_replay.so")
    os.makedirs(str(_kernels.BUILD), exist_ok=True)
    r = subprocess.run([_kernels.nvcc(), "-gencode", _kernels.ARCH,
                        "-std=c++17", "-O3", "-shared", "-Xcompiler",
                        "-fPIC", "-Xptxas", "-v", "-o", out, src],
                       capture_output=True, text=True, check=True)
    fn = ctypes.CDLL(out).flat_replay_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(signed, ol, orr, rank, n, nxt, cols, active, lmax):
        B, CAP = signed.shape
        _, T, S, _ = cols.shape
        flags = torch.zeros(B, dtype=torch.int32, device=signed.device)
        code = fn(*(t.data_ptr() for t in (signed, ol, orr, rank, n, nxt,
                                           cols, active, flags)),
                  T, S, B, CAP, ol.shape[1], lmax, 4 * (3 * CAP + 64),
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"the parent's flat kernel: CUDA error {code}")
        return flags

    return call, r.stdout + r.stderr


def time_launches(torch, kernel, kept, reps: int = 3, queued=True):
    """Each kept launch re-run on fresh copies of its inputs: the summed
    medians of ``reps`` runs after 1 warm-up (CUDA events), and whether
    every run left the recorded outputs and flags. ``queued``: a ~0.5 ms
    sleep kernel goes first, so that the host has queued the launch
    before the card reaches it and the time is the card's alone; else
    the time also holds the host's work in the wrapper while the card
    waits (as the serve run's events do)."""
    total, same = 0.0, True
    for kl in kept:
        times = []
        for i in range(reps + 1):
            st = [t.clone() for t in kl["inputs"]]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if queued:
                torch.cuda._sleep(1_000_000)
            start.record()
            flags = kernel(*st, kl["cols"], kl["active"], kl["lmax"])
            end.record()
            end.synchronize()
            if i:
                times.append(start.elapsed_time(end))
            out = [st[0], st[1], st[2], st[4], st[5]]
            same = same and torch.equal(flags, kl["flags"]) and all(
                torch.equal(a, b) for a, b in zip(out, kl["outputs"]))
        total += statistics.median(times)
    return total, same


def sm_clock() -> str:
    """The card's SM clock now and at most, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def flat_timings(torch, dev, parent_source, reps: int) -> None:
    """Every launch of the acceptance shape at depth 1, at depth 2 with
    trains of 4 and of the wide shape, re-launched on its inputs by this
    kernel and by the parent's, in the order parent, change, change,
    parent; then the counting build's shares over the same launches."""
    import chip_smoke
    from text_crdt_rust_tpu_torch.config import ServeConfig
    from text_crdt_rust_tpu_torch.ops import flat as F
    from text_crdt_rust_tpu_torch.serve.loadgen import ServeLoadGen

    card = chip_smoke.card_line()
    base = "change"
    calls = {base: F.flat_replay_cuda}
    if parent_source:
        parent, report = parent_flat_kernel(torch, parent_source)
        calls = {"parent": parent, **calls}
        for row in ptxas_table(report, "flat_replay_kernel"):
            print(f"flat ptxas, parent: {row[0]}: {row[1]} registers, "
                  f"{row[2]} B spill stores, {row[3]} B spill loads",
                  flush=True)
    order = list(calls) + list(reversed(list(calls)))
    shapes = (("acceptance, depth 1", chip_smoke.SERVE_ACCEPTANCE,
               chip_smoke.FLAT_CFG, 1, 1),
              ("acceptance, depth 2, trains of 4",
               chip_smoke.SERVE_ACCEPTANCE, chip_smoke.FLAT_CFG, 2, 4),
              ("wide, depth 2", chip_smoke.SERVE_WIDE,
               chip_smoke.FLAT_WIDE_CFG, 2, 1))
    launches = chip_smoke.FlatLaunches(torch, F.flat_replay_cuda)
    for label, params, cfg, depth, train in shapes:
        F.flat_replay_cuda = launches
        try:
            gen, report, wall = chip_smoke.flat_run(
                torch, ServeConfig, ServeLoadGen, launches, params, cfg,
                depth, train, lambda shape, k: True, dev)
        finally:
            F.flat_replay_cuda = launches.kernel
        ms_run, n, kept = launches.take()
        steps = sum(int(kl["active"].sum()) for kl in kept)
        print(f"flat {label}: converged {report['converged']}, {n} "
              f"launches ({len(kept)} kept), {steps} device steps, "
              f"{ms_run:.3f} ms on the card in the run; {card}", flush=True)
        del gen, report
        for k in order:
            ms, same = time_launches(torch, calls[k], kept, reps)
            ms_host, same_host = time_launches(torch, calls[k], kept, reps,
                                               queued=False)
            print(f"flat {label}: {k}: {ms:.3f} ms over {len(kept)} "
                  f"launches queued ahead of the card, "
                  f"{ms * 1e3 / max(steps, 1):.3f} us a step; "
                  f"{ms_host:.3f} ms launched one by one; outputs equal "
                  f"the run's {same and same_host}", flush=True)
            if not (same and same_host):
                raise AssertionError(f"flat {label}: {k} disagrees")
        idle = [dict(kl, active=torch.zeros_like(kl["active"]))
                for kl in kept]
        ms_idle, _ = time_launches(torch, calls[base], idle, reps)
        print(f"flat {label}: {base} on the same launches with every "
              f"step marked idle (the launch's fixed cost): {ms_idle:.3f} "
              f"ms queued ahead of the card", flush=True)
        stats = [torch.zeros(kl["inputs"][0].shape[0], F.FLAT_STATS,
                             dtype=torch.int64, device=dev) for kl in kept]
        for kl, st in zip(kept, stats):
            inputs = [t.clone() for t in kl["inputs"]]
            F.flat_replay_cuda(*inputs, kl["cols"], kl["active"], kl["lmax"],
                               stats=st)
        torch.cuda.synchronize()
        cy = F.FLAT_STAT_NAMES.index("cy_all")
        slowest = sum(int(st[:, cy].max()) for st in stats)
        print(f"flat {label}: counters over its launches: "
              f"{F.describe_stats(torch.cat(stats).cpu())}; the slowest "
              f"lane of each launch, summed: {slowest} cycles (SM clock "
              f"{sm_clock()})", flush=True)
        del kept, stats
        torch.cuda.empty_cache()


#: A probe of what one SM gets from the card's memory system (the ``l2``
#: phase): one block's barrier, a dependent L2 load, and the rates of
#: coalesced int4 reads, writes, and reads then writes of the same rows
#: (a shift's pattern) within a 2 MiB L2-resident buffer, each timed with
#: clock64 on thread 0 and a barrier after the traffic. The write rates
#: include the stores' drain: a shared-memory store and a barrier follow.
L2_PROBE_SRC = r"""
#include <cuda_runtime.h>
__global__ void l2_probe(long long* out, int4* buf, int* chase, int n4,
                         int iters) {
  __shared__ int sink[32];
  const int T = blockDim.x, tid = threadIdx.x;
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) __syncthreads();
  long long t1 = clock64();
  int j = 0;
  if (tid == 0) {
    for (int i = 0; i < iters; ++i) j = chase[j];
    sink[0] = j;
  }
  __syncthreads();
  long long t2 = clock64();
  int4 acc = make_int4(0, 0, 0, 0);
  for (int i = 0; i < iters; ++i) {
    int4 v[16];
    const int base = (i * 16 * T) % n4;
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = buf[(base + k * T + tid) % n4];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 16; ++k) acc.x += v[k].x;
  }
  long long t3 = clock64();
  for (int i = 0; i < iters; ++i) {
    const int base = (i * 16 * T) % n4;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      buf[(base + k * T + tid) % n4] = make_int4(i, k, tid, acc.x);
    __syncthreads();
    if (tid == 0) sink[1] = i;
    __syncthreads();
  }
  long long t4 = clock64();
  for (int i = 0; i < iters; ++i) {
    int4 v[16];
    const int base = (i * 16 * T) % n4;
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = buf[(base + k * T + tid) % n4];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      v[k].x += 1;
      buf[(base + k * T + tid) % n4] = v[k];
    }
    __syncthreads();
    if (tid == 0) sink[2] = i;
    __syncthreads();
  }
  long long t5 = clock64();
  if (tid == 0) {
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = t3 - t2;
    out[3] = t4 - t3;
    out[4] = t5 - t4;
    out[5] = acc.x + sink[0] + sink[1] + sink[2];
  }
}
extern "C" int l2_probe_launch(long long* out, int4* buf, int* chase, int n4,
                               int iters, int threads) {
  l2_probe<<<1, threads>>>(out, buf, chase, n4, iters);
  return (int)cudaDeviceSynchronize();
}
"""


def phase_l2(torch) -> None:
    """Run ``L2_PROBE_SRC`` at 256, 512 and 1,024 threads."""
    import ctypes

    from text_crdt_rust_tpu_torch.ops import _kernels
    out_dir = _kernels.BUILD / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "l2_probe.cu", out_dir / "libl2_probe.so"
    src.write_text(L2_PROBE_SRC)
    subprocess.run([_kernels.nvcc(), "-gencode", _kernels.ARCH, "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.l2_probe_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    dev = torch.device("cuda")
    n4 = 1 << 17                     # 2 MiB of int4
    buf = torch.zeros(4 * n4, dtype=torch.int32, device=dev)
    n = 1 << 16
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    chase = torch.empty(n, dtype=torch.int32)
    chase[perm] = torch.roll(perm, -1).to(torch.int32)
    chase = chase.to(dev)
    out = torch.zeros(6, dtype=torch.int64, device=dev)
    iters = 256
    for threads in (256, 512, 1024):
        for _ in range(2):           # the second run is kept (warm)
            if lib.l2_probe_launch(out.data_ptr(), buf.data_ptr(),
                                   chase.data_ptr(), n4, iters, threads):
                raise RuntimeError("l2_probe failed")
        v = [int(x) for x in out.tolist()]
        moved = 16 * 16 * threads * iters  # bytes a pass
        print(f"l2 probe, one block of {threads} threads: barrier "
              f"{v[0] / iters:.1f} cycles, dependent L2 load "
              f"{v[1] / iters:.1f} cycles, reads {moved / v[2]:.1f} B a "
              f"cycle, writes {moved / v[3]:.1f} B a cycle, reads then "
              f"writes of the same rows {2 * moved / v[4]:.1f} B a cycle "
              f"({sm_clock()})", flush=True)


def phase_flat(torch, dev, report: str = "", parent_source=None,
               reps: int = 3) -> None:
    import multiprocessing

    import numpy as np

    import chip_smoke
    from text_crdt_rust_tpu_torch.ops import _kernels
    from text_crdt_rust_tpu_torch.ops import batch as B
    from text_crdt_rust_tpu_torch.utils import randedit

    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
         "-q", "tests/test_torch_cuda.py", "-k", "flat",
         "-p", "no:cacheprovider"], capture_output=True, text=True)
    print(r.stdout[-3000:], r.stderr[-2000:], flush=True)
    for row in ptxas_table(report, "flat_replay_kernel"):
        print(f"flat ptxas: {row[0]}: {row[1]} registers, {row[2]} B spill "
              f"stores, {row[3]} B spill loads", flush=True)
    flat_timings(torch, dev, parent_source, reps)
    card = chip_smoke.card_line()
    pool = multiprocessing.get_context("spawn").Pool(4)
    try:
        t0 = time.perf_counter()
        line, pending, traces = chip_smoke.flat_phase(
            torch, dev, card, _kernels, B, randedit, np, pool)
        chip_smoke.analytics_phase(traces, card)
        e, secs = chip_smoke.check_flat_wide(pending)
        line.update(wide_plain_s=secs)
        print(f"flat phase: {time.perf_counter() - t0:.1f} s, max_abs_err "
              f"{max(line['max_abs_err'], e)}; "
              f"{json.dumps(line, default=str)}", flush=True)
    finally:
        pool.terminate()
    if r.returncode != 0 or max(line["max_abs_err"], e) != 0:
        raise SystemExit(1)


def phase_configs(torch, dev) -> None:
    import multiprocessing

    import chip_smoke
    from text_crdt_rust_tpu_torch import (
        baseline,
        corpus,
        kevin,
        northstar,
        random_edits,
    )
    from text_crdt_rust_tpu_torch.ops import _kernels
    from text_crdt_rust_tpu_torch.ops import rle as R

    t_start = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
         "-q", "tests/test_torch_cuda.py", "-k",
         "config2 or config3 or groups-20", "-p", "no:cacheprovider"],
        capture_output=True, text=True)
    print(r.stdout[-3000:], r.stderr[-2000:], flush=True)
    card = chip_smoke.card_line()
    pool = multiprocessing.get_context("spawn").Pool(2)
    try:
        tasks = [pool.apply_async(chip_smoke.config_streams,
                                  (which, chip_smoke.PLAIN_LANES_A1))
                 for which in ("2", "3")]
        run = northstar.run_northstar(batch=chip_smoke.NS_LANES, device=dev)
        ns = chip_smoke.northstar_10k_phase(torch, dev, card, northstar, R,
                                            _kernels, run.results[0])
        patches, want = run.stream.patches, run.stream.want
        del run
        cfg2, st2 = chip_smoke.config_phase(
            torch, dev, card, "config 2 (random edits)", tasks[0],
            lambda st: random_edits.run_random_edits(stream=st, device=dev),
            lambda st: random_edits.make_random_edits_replayer(
                st, device=dev), R, _kernels, lambda st: len(st.patches))
        cfg3, st3 = chip_smoke.config_phase(
            torch, dev, card, "config 3 (rustcode + sveltecomponent)",
            tasks[1], lambda st: corpus.run_corpus(stream=st, device=dev),
            lambda st: corpus.make_corpus_replayer(st, device=dev), R,
            _kernels, lambda st: st.n_patches)
        pool.close()
        pool.join()
    finally:
        pool.terminate()
    lists, cols = baseline.patch_lists(patches), baseline.patch_columns(
        patches)
    k_cols = kevin.kevin_columns(chip_smoke.KEVIN_NATIVE)
    n_kevin = chip_smoke.KEVIN_NATIVE
    cells = [
        ("config 1: automerge-paper", lambda: baseline.replay_trace(lists),
         len(patches), "patches", lambda d: d.to_string() == want, 5),
        ("config 1: rope",
         lambda: baseline.rope_replay(*cols, want_content=False)[0],
         len(patches), "patches", lambda n: n == len(want), 5),
        ("config 2", lambda c=baseline.patch_lists(st2.patches):
         baseline.replay_trace(c), len(st2.patches), "patches",
         lambda d: d.to_string() == st2.want, 5)]
    cells += [(f"config 3: {n}", lambda c=baseline.patch_lists(ps):
               baseline.replay_trace(c), len(ps), "patches",
               lambda d, w=w: d.to_string() == w, 5)
              for n, ps, w in zip(st3.names, st3.patches, st3.wants)]
    cells.append(("kevin", lambda: baseline.replay_trace(k_cols), n_kevin,
                  "prepends", lambda d: len(d) == n_kevin, 3))
    native = chip_smoke.baseline_phase(cells)
    print(f"configs phase: {time.perf_counter() - t_start:.1f} s; "
          + json.dumps({"northstar_10k": ns, "config2": cfg2,
                        "config3": cfg3, "native": native}, default=str),
          flush=True)
    if r.returncode != 0:
        raise SystemExit(1)


def gloo_cuda_job(ctx) -> dict:
    """Which collectives this PyTorch's gloo takes on CUDA tensors (a
    world job: every rank tries each on its card)."""
    import torch
    import torch.distributed as dist
    x = torch.arange(3, dtype=torch.int32, device=ctx.device) + ctx.rank
    out = {}
    for name, fn in (
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(ctx.world_size)], x)),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                x.new_empty(ctx.world_size * 3), x)),
            ("all_reduce", lambda: dist.all_reduce(x.clone()))):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # the error is the answer
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
    return out


SP_TIMES_TAG = "SP_TIMES "
SP_PREFIX = 20_000      # config sp's prefix at sp = 1 and at sp = 4
SP_RANKS = 4
SP_SWEEP = (256, 512, 1024)    # sp-threads: the thread counts tried


def sp_digest(torch, outs) -> str:
    """sha256 of S1's outputs (every plane and table, the logs, rows and
    error bits)."""
    import hashlib
    h = hashlib.sha256()
    for t in outs:
        h.update(t.reshape(-1).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def sp_blocks(patches):
    """Config sp's plan at sp = 1 and its chunks' op columns ``[9, S]``."""
    import numpy as np

    from text_crdt_rust_tpu_torch import sp
    from text_crdt_rust_tpu_torch.parallel.sp_apply import OP_FIELDS
    plan = sp.plan_sp(patches, 1)
    ps, _ = sp.trace_patches(patches)
    ops, parts, _ = sp.compile_sp(ps, plan.chunks)
    return plan, ops.num_steps, [
        np.stack([np.asarray(getattr(p, f), np.uint32).view(np.int32)
                  for f in OP_FIELDS]) for p in parts]


def sp_inputs(torch, dev, plan, blocks):
    """Each chunk's input state at sp = 1 (S1 run chunk after chunk from
    the empty document), and the digest of the last chunk's outputs."""
    from text_crdt_rust_tpu_torch import sp
    from text_crdt_rust_tpu_torch.parallel import sp_kernel as SK
    from text_crdt_rust_tpu_torch.parallel.sp_apply import TAB_UNKNOWN
    R, OTS = plan.shard_rows, sp.ORDER_ROWS
    i32 = torch.int32
    state = (torch.zeros(R, dtype=i32, device=dev),
             torch.zeros(R, dtype=i32, device=dev),
             torch.zeros(1, dtype=i32, device=dev),
             torch.full((OTS,), TAB_UNKNOWN, dtype=i32, device=dev),
             torch.full((OTS,), TAB_UNKNOWN, dtype=i32, device=dev),
             torch.zeros(OTS, dtype=i32, device=dev))
    inputs, out = [], None
    for cols in blocks:
        inputs.append(state)
        out = SK.sp_replay_cuda(*state, cols)
        if int(out[-1]):
            raise AssertionError(f"S1 flagged config sp: {int(out[-1])}")
        state = tuple(t.clone() for t in out[:6])
    return inputs, sp_digest(torch, out)


def sp_run_times(torch, inputs, blocks, reps):
    """Each chunk's median time from its input state (CUDA events)."""
    from text_crdt_rust_tpu_torch.parallel import sp_kernel as SK
    return [cuda_ms(torch, lambda st=st, c=c: SK.sp_replay_cuda(*st, c),
                    reps) for st, c in zip(inputs, blocks)]


def sp_sweep_libs(threads):
    """``sp_replay.cu`` built at each thread count (``-DSP_THREADS``) beside
    the committed build, all ``nvcc`` processes at once: {threads:
    (library path, ptxas registers and spills)}."""
    from text_crdt_rust_tpu_torch.ops import _kernels
    src = _kernels.sources()["sp_replay"]
    out_dir = _kernels.BUILD / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for t in threads:
        lib = out_dir / f"libsp_replay_{t}.so"
        procs[t] = (lib, subprocess.Popen(
            [_kernels.nvcc(), "-gencode", _kernels.ARCH, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             f"-DSP_THREADS={t}", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for t, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc at {t} threads:\n{log}")
        libs[t] = (str(lib), ptxas_table(log, "sp_replay", stack=True))
    return libs


def phase_sp_threads(torch, dev, reps: int) -> None:
    """S1 on config sp's whole trace at each of ``SP_SWEEP`` threads a
    block, beside the committed build (see ``sp-threads``)."""
    import ctypes

    import chip_smoke
    from text_crdt_rust_tpu_torch.ops import _kernels
    plan, steps, blocks = sp_blocks(None)
    inputs, digest = sp_inputs(torch, dev, plan, blocks)
    lib0 = _kernels.library("sp_replay")
    committed = sum(sp_run_times(torch, inputs, blocks, reps))
    sweep = {}
    try:
        for t, (path, ptx) in sp_sweep_libs(SP_SWEEP).items():
            lib = ctypes.CDLL(path)
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _kernels._libs["sp_replay"] = lib
            _, dg = sp_inputs(torch, dev, plan, blocks)
            ms = sum(sp_run_times(torch, inputs, blocks, reps))
            sweep[t] = dict(ms=ms, us_per_step=ms * 1e3 / steps,
                            digest_same=dg == digest, ptxas=ptx)
    finally:
        _kernels._libs["sp_replay"] = lib0
    card = chip_smoke.card_line()
    print(f"S1 threads a block on the whole trace ({card}): committed "
          f"build ({lib0.sp_replay_threads()} threads) "
          f"{committed:.3f} ms; {json.dumps(sweep)}", flush=True)
    if not all(v["digest_same"] for v in sweep.values()):
        raise AssertionError("a thread count changed S1's outputs")


def sp_times(torch, dev, reps: int, sp4: bool) -> dict:
    """S1 on config sp with whichever checkout's package is imported (see
    ``sp-times`` in the docstring): times, digests, and where this
    checkout's wrapper takes them, its thread count a block and the
    ``stats`` shares."""
    from text_crdt_rust_tpu_torch.ops import _kernels
    from text_crdt_rust_tpu_torch.parallel import sp_kernel as SK
    rec = {}
    for label, patches in (("whole", None), ("prefix", SP_PREFIX)):
        t0 = time.perf_counter()
        plan, steps, blocks = sp_blocks(patches)
        inputs, digest = sp_inputs(torch, dev, plan, blocks)
        set_up = time.perf_counter() - t0
        ms = sp_run_times(torch, inputs, blocks, reps)
        r = dict(R=plan.shard_rows, steps=steps, chunks=len(blocks),
                 chunk_ms=ms, ms=sum(ms), us_per_step=sum(ms) * 1e3 / steps,
                 digest=digest, set_up_s=set_up)
        if label == "whole" and hasattr(SK, "SP_STAT_NAMES"):
            stats = torch.zeros(SK.SP_STATS, dtype=torch.int64, device=dev)
            for st, c in zip(inputs, blocks):
                out = SK.sp_replay_cuda(*st, c, stats=stats)
            torch.cuda.synchronize()
            r["stats"] = dict(zip(SK.SP_STAT_NAMES, stats.tolist()))
            r["stats_line"] = SK.describe_stats(stats, steps)
            r["stats_digest_same"] = sp_digest(torch, out) == digest
            r["threads"] = _kernels.library("sp_replay").sp_replay_threads()
        rec[label] = r
    rec["sp4"] = sp4_times() if sp4 else None
    return rec


def sp4_times() -> dict:
    """The prefix at sp = 4 through ``chip_smoke.py``'s stages (the
    imported checkout's): the replay's wall a step and rank 0's S1 time
    over the chunks (CUDA events, from each chunk's input state)."""
    import chip_smoke
    import torch

    from text_crdt_rust_tpu_torch import sp
    from text_crdt_rust_tpu_torch.parallel import launch
    if torch.cuda.device_count() >= SP_RANKS:
        backend, device = "nccl", None
    else:
        backend, device = "gloo", "cuda:0"
    plan = sp.plan_sp(SP_PREFIX, SP_RANKS, slack=1.0)
    rec = {}
    with launch.World(SP_RANKS, backend, device, timeout=600) as w:
        chip_smoke.sp_stages(w, plan, "sp4", rec, "")
        chunks = w.run(chip_smoke.sp_chunks_job, 0)
    r = rec["sp4"]
    return dict(backend=backend, steps=r["steps"], wall_s=r["wall_s"],
                ms_per_step_wall=r["ms_per_step"], reshards=r["reshards"],
                collectives_per_step=r["collectives_per_step"],
                launches_rank0=r["launches"],
                s1_ms_rank0=sum(c["s1_ms"] for c in chunks),
                s1_launches_rank0=sum(c["launches"] for c in chunks))


def parent_sp_times(parent: str, reps: int, sp4: bool) -> dict:
    """``sp_times`` in the checkout ``parent``: a process of its own whose
    imports are that checkout's package (its wrapper builds and binds its
    own kernel)."""
    import os
    code = ("import runpy, sys; sys.argv = ['chip_blocked_timing.py', "
            f"'sp-times', '--json', '--reps', '{reps}'"
            f"{', ' + repr('--sp4') if sp4 else ''}]; "
            f"runpy.run_path({os.path.abspath(__file__)!r}, "
            "run_name='__main__')")
    r = subprocess.run([sys.executable, "-c", code], cwd=parent,
                       capture_output=True, text=True)
    for line in r.stdout.splitlines():
        if line.startswith(SP_TIMES_TAG):
            return json.loads(line[len(SP_TIMES_TAG):])
    raise RuntimeError(f"the parent's sp-times failed ({r.returncode}):\n"
                       f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")


def sp_times_line(who: str, r: dict) -> str:
    w, p, s4 = r["whole"], r["prefix"], r["sp4"]
    line = (f"S1 {who}: whole trace {w['ms']:.3f} ms over {w['chunks']} "
            f"chunks ({w['us_per_step']:.3f} us a step of {w['steps']}; "
            f"chunks {[round(x, 3) for x in w['chunk_ms']]}), digest "
            f"{w['digest']}; prefix {p['ms']:.3f} ms ({p['us_per_step']:.3f}"
            f" us a step), digest {p['digest']}")
    if s4:
        line += (f"; sp={SP_RANKS} ({s4['backend']}) "
                 f"{s4['ms_per_step_wall']:.4f} ms a step of wall, rank 0's "
                 f"S1 {s4['s1_ms_rank0']:.3f} ms in "
                 f"{s4['s1_launches_rank0']} launches, reshards "
                 f"{s4['reshards']}")
    return line


def phase_sp(torch, dev, reps: int, parent=None, sp4: bool = False,
             tests_and_smoke: bool = True) -> None:
    import numpy as np

    import chip_smoke
    from text_crdt_rust_tpu_torch.ops import _kernels
    from text_crdt_rust_tpu_torch.ops import flat as F
    from text_crdt_rust_tpu_torch.parallel import launch

    card = chip_smoke.card_line()
    rc = 0
    if tests_and_smoke:
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
             "-q", "tests/test_torch_cuda.py", "-k",
             "sp_doc or sp_kernel or streamed", "-p", "no:cacheprovider"],
            capture_output=True, text=True)
        print(r.stdout[-3000:], r.stderr[-2000:], flush=True)
        rc = r.returncode
        with launch.World(2, "gloo", "cuda:0", timeout=120) as w:
            print(f"gloo on CUDA tensors ({torch.__version__}): "
                  f"{w.run(gloo_cuda_job)}", flush=True)
    # The committed build's ptxas report: build it anew if the card tests
    # (another process) built it already.
    lib = _kernels._lib_path(_kernels.sources()["sp_replay"])
    if lib.exists() and "sp_replay" not in _kernels._libs:
        lib.unlink()
    report = _kernels.build(["sp_replay"]).get("sp_replay", "")
    print(f"S1 ptxas (entry, registers, spill stores, spill loads, stack "
          f"frame): {ptxas_table(report, 'sp_replay', stack=True)}",
          flush=True)
    runs = []
    order = ["parent", "this", "this", "parent"] if parent else ["this"]
    for who in order:
        t0 = time.perf_counter()
        r = (parent_sp_times(parent, reps, sp4) if who == "parent"
             else sp_times(torch, dev, reps, sp4))
        runs.append((who, r))
        print(f"{sp_times_line(who, r)} ({time.perf_counter() - t0:.1f} s; "
              f"{card})", flush=True)
    mine = [r for who, r in runs if who == "this"][-1]
    w = mine["whole"]
    print(f"S1 threads a block: {w['threads']}", flush=True)
    print(f"S1 stats over the whole trace (outputs as the main build's: "
          f"{w['stats_digest_same']}): {w['stats_line']}", flush=True)
    digests = {(r["whole"]["digest"], r["prefix"]["digest"])
               for _, r in runs}
    same = len(digests) == 1 and w["stats_digest_same"]
    print(f"S1 outputs equal across the runs, builds and checkouts: {same}",
          flush=True)
    print(json.dumps({"sp_times": runs}, default=str), flush=True)
    if tests_and_smoke:
        t0 = time.perf_counter()
        plans = chip_smoke.sp_plans()
        print(f"config sp plans (run-row dry runs): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        a1, f1, s1 = chip_smoke.sp_phase(torch, dev, card, np, _kernels, F,
                                         plans)
        print(f"sp phase: A1 {a1}, F1 {f1}", flush=True)
        print(json.dumps({"kernels": [s1]}, default=str), flush=True)
    if rc != 0 or not same:
        raise SystemExit(1)


if __name__ == "__main__":
    sys.exit(main())
