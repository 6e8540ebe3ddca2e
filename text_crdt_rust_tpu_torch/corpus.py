"""Configuration 3 on the port: a ragged mixed corpus, rustcode and
sveltecomponent, replayed as two divergent doc groups of identical
documents by the run-block replay (``ops/rle.py``, A1) in one launch.

The pipeline of the JAX package's ``bench.py`` ``cfg_3``
(``bench.py:766-815``), with its ``_compile_rle`` (``:722-733``) as
``compile_rle``: each trace's patches are RLE-merged and compiled at
``lmax`` = min(longest insert, 512), so rustcode's 69,108-character paste
becomes 135 chained insert steps that the kernel's append-merge fuses back
into one run; the capacity is 2.5 times ``simulate_run_rows``' peak in
whole 256-row blocks (at least 512), the larger of the two groups'. The
two streams differ in length (13,001 and 5,733 steps), so the shorter is
padded with no-op steps. K = 256, 128 documents a group.

    python -m text_crdt_rust_tpu_torch.corpus [--batch 128] [--prefix N]
        [--device cpu]

prints one JSON line: each group's steps, whether its doc 0 reproduced
the trace (``endContent``, or the plain string splice of a prefix),
whether every lane equals lane 0, and whether the native engine's text
equals the trace's (``chip_smoke.py`` times the replay).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional, Sequence

import torch

from . import resolve_device
from .baseline import native_replay
from .northstar import apply_patches
from .ops import batch as B
from .ops import span_arrays as SA
from .ops.rle import RleResult, make_replayer_rle, rle_to_flat, \
    simulate_run_rows
from .ops.rle_hbm import lanes_equal
from .utils.testdata import TestPatch, flatten_patches, load_testing_data, \
    trace_path

#: The corpus of config 3, one doc group each.
TRACES = ("rustcode", "sveltecomponent")
#: Rows per block of configs 2 and 3 (``bench.py``'s ``block_k=256``).
BLOCK_K = 256
#: Longest insert step of a compiled stream: longer inserts chain.
LMAX_CAP = 512


@dataclasses.dataclass
class RleStream:
    """One patch list compiled for the run-block replay, with the capacity
    ``bench.py``'s ``_compile_rle`` gives it."""

    ops: B.OpTensors
    capacity: int         # run rows: 2.5 x peak in 256-row blocks, >= 512
    peak_rows: int        # simulate_run_rows' peak
    final_rows: int       # simulate_run_rows' final count: the replay's
    #                       run rows at the end
    lmax: int             # insert chunk the stream was compiled at
    n_patches: int        # original patches (the ops/s numerator)

    @property
    def steps(self) -> int:
        return self.ops.num_steps


def compile_rle(patches: Sequence[TestPatch],
                lmax_cap: int = LMAX_CAP) -> RleStream:
    """Merge a patch list, compile it at ``lmax`` = min(longest merged
    insert, ``lmax_cap``) with whole deletes, and size its capacity from
    the run-row dry run (the reference's list walk, quadratic in the
    runs: ~90 s on one core for config 2's 20,000 random patches): 2.5 x
    its peak in whole 256-row blocks, at least 512."""
    merged = B.merge_patches(list(patches))
    lmax = min(max([len(p.ins_content) for p in merged] + [1]), lmax_cap)
    ops, _ = B.compile_local_patches(merged, lmax=lmax, dmax=None)
    peak, final = simulate_run_rows(merged)
    capacity = max(((int(peak * 2.5) + 255) // 256) * 256, 512)
    return RleStream(ops=ops, capacity=capacity, peak_rows=peak,
                     final_rows=final, lmax=lmax, n_patches=len(patches))


@dataclasses.dataclass
class CorpusStream:
    """Config 3's compiled groups and what each must reproduce."""

    names: List[str]
    patches: List[List[TestPatch]]
    streams: List[RleStream]
    wants: List[str]

    @property
    def capacity(self) -> int:
        return max(s.capacity for s in self.streams)

    @property
    def n_patches(self) -> int:
        return sum(len(p) for p in self.patches)


def make_corpus_stream(prefix: Optional[int] = None,
                       names: Sequence[str] = TRACES) -> CorpusStream:
    """Load and compile each trace of the corpus (its first ``prefix``
    patches when given)."""
    datas = [load_testing_data(trace_path(n)) for n in names]
    plists = [flatten_patches(d) for d in datas]
    if prefix:
        plists = [p[:prefix] for p in plists]
    wants = [d.end_content if not prefix else apply_patches(p)
             for d, p in zip(datas, plists)]
    return CorpusStream(names=list(names), patches=plists,
                        streams=[compile_rle(p) for p in plists],
                        wants=wants)


@dataclasses.dataclass
class CorpusRun:
    """One replay of config 3 and its checks."""

    stream: CorpusStream
    results: List[RleResult]    # one per group
    text_ok: List[bool]         # each group's doc 0 reproduced its trace
    lanes_ok: List[bool]        # each group's lanes equal its lane 0
    native_ok: List[bool]       # the native engine reproduced each trace

    @property
    def ok(self) -> bool:
        return all(self.text_ok + self.lanes_ok + self.native_ok)


def make_corpus_replayer(stream: CorpusStream, batch: int = 128,
                         device=None):
    """The replayer of both groups in one launch at config 3's geometry."""
    return make_replayer_rle([s.ops for s in stream.streams],
                             capacity=stream.capacity, batch=batch,
                             block_k=BLOCK_K, chunk=1024, device=device)


def run_corpus(batch: int = 128, device=None, prefix: Optional[int] = None,
               stream: Optional[CorpusStream] = None) -> CorpusRun:
    """Compile (unless a compiled ``stream`` is given) and replay config 3,
    then check each group's doc 0 and lanes and the native engine's texts.
    A capacity or bad-delete error flag raises."""
    dev = resolve_device(device)
    if stream is None:
        stream = make_corpus_stream(prefix)
    results = make_corpus_replayer(stream, batch, dev)()
    results[0].check()
    text_ok = [SA.to_string(rle_to_flat(s.ops, r)) == want
               for s, r, want in zip(stream.streams, results, stream.wants)]
    native_ok = [native_replay(p).to_string() == want
                 for p, want in zip(stream.patches, stream.wants)]
    return CorpusRun(stream=stream, results=results, text_ok=text_ok,
                     lanes_ok=[lanes_equal(r) for r in results],
                     native_ok=native_ok)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--prefix", type=int, default=0,
                    help="replay only each trace's first N patches "
                         "(0 = all)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run = run_corpus(args.batch, dev, args.prefix or None)
    print(json.dumps({
        "groups": run.stream.names,
        "patches": [len(p) for p in run.stream.patches],
        "steps": [s.steps for s in run.stream.streams],
        "capacity": run.stream.capacity, "batch": args.batch,
        "blocks_used": [int(r.meta[0, 0]) for r in run.results],
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "text_ok": run.text_ok, "lanes_ok": run.lanes_ok,
        "native_ok": run.native_ok, "ok": run.ok}))
    return 0 if run.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
