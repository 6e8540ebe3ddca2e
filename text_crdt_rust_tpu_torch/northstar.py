"""The north-star replay on the port: a whole editing trace replayed into
a batch of identical documents by the run-block replay.

The pipeline of the JAX package's ``bench.py`` ``cfg_northstar``: load the
trace, replay its original patches on the native C++ engine
(``baseline.native_replay``) and check that text against the trace's
``endContent``, RLE-merge the patches, compile them into op tensors, fuse
steps (W-row bursts, replace pairs), replay on ``batch`` lanes x
``groups`` doc groups, expand doc 0 of group 0 to a ``FlatDoc`` and check
its text against ``endContent``. Every other group replays the same
stream and must equal group 0 in every output, compared on the device, so
no other lane is expanded on the host: ``run_northstar(batch=512,
groups=20)`` is the ``BASELINE.json`` north star at 10,240 documents in
one launch (``bench.py:619-627``).

    python -m text_crdt_rust_tpu_torch.northstar [--batch 512] [--device cpu]
        [--engine rle|rle-hbm|blocked|hbm]

prints one JSON line with the step counts, whether doc 0 reproduced the
trace, whether every group equals group 0 and whether the native engine's
text equals the trace's (``chip_smoke.py`` times the replay).

Two engines replay it: ``rle`` (``ops/rle.py``, K = 128, capacity 20,992
run rows, the default) and ``rle-hbm`` (``ops/rle_hbm.py``, the planes in
device memory: K = 512, capacity 32,768, as the JAX package's ``bench.py
--engine rle-hbm`` sizes it for 1,024 documents and more).

Two per-character engines replay the trace as ``bench.py --engine
blocked|hbm`` does: the patches neither merged nor fused, compiled at
``lmax`` = ``dmax`` = 16, capacity ``2 << ceil(log2(inserted chars))``
character rows (524,288 for the full trace) and K = min(512, capacity /
2); their results are ``BlockedResult``s, read by ``blocked_to_flat``.
``blocked`` (``ops/blocked.py``) keeps a document in one thread block's
shared memory and takes prefixes up to 32,768 rows; ``hbm``
(``ops/blocked_hbm.py``) keeps it in device memory and takes the full
trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

import torch

from . import resolve_device
from .baseline import native_replay
from .ops import batch as B
from .ops import span_arrays as SA
from .ops.rle import make_replayer_rle, rle_to_flat
from .ops.blocked import blocked_to_flat, make_replayer
from .ops.blocked_hbm import make_replayer_hbm
from .ops.rle_hbm import make_replayer_rle_hbm
from .utils.testdata import TestPatch, flatten_patches, load_testing_data, \
    trace_path


#: Engine -> (replayer, default block_k, default capacity in run rows).
ENGINES = {
    "rle": (make_replayer_rle, 128, 20992),
    "rle-hbm": (make_replayer_rle_hbm, 512, 32768),
}

#: Per-character engine -> replayer (geometry from the stream, see
#: ``char_geometry``).
CHAR_ENGINES = {
    "blocked": make_replayer,
    "hbm": make_replayer_hbm,
}
#: Insert and delete chunk of the per-character engines (``bench.py
#: --lmax``).
CHAR_LMAX = 16


@dataclasses.dataclass
class NorthstarStream:
    """A compiled trace: the op stream and what it must reproduce."""

    ops: B.OpTensors
    want: str             # text the replay must end with
    n_patches: int        # original patches (the ops/s numerator)
    steps_merged: int     # steps after merge_patches + compile
    fuse: Optional[B.FuseStats]
    ins_total: int = 0    # inserted characters
    patches: List[TestPatch] = dataclasses.field(default_factory=list)
    #                       the original patches (the native replay's)

    @property
    def steps(self) -> int:
        return self.ops.num_steps


@dataclasses.dataclass
class NorthstarRun:
    """One replay of a compiled trace."""

    stream: NorthstarStream
    results: list              # one per doc group: RleResult or BlockedResult
    doc: SA.FlatDoc            # doc 0 of group 0, expanded
    text_ok: bool              # doc 0 of group 0 reproduced ``want``
    groups_equal: bool         # every group equals group 0 on the device
    native_text: str           # the native engine's text

    @property
    def native_ok(self) -> bool:
        return self.native_text == self.stream.want

    @property
    def ok(self) -> bool:
        return self.text_ok and self.groups_equal and self.native_ok


def apply_patches(patches) -> str:
    """The text a patch list produces, by plain string splicing (the
    oracle for trace prefixes, which have no shipped ``endContent``)."""
    s = ""
    for p in patches:
        s = s[:p.pos] + p.ins_content + s[p.pos + p.del_len:]
    return s


def compile_northstar(trace: str = "automerge-paper",
                      patches: Optional[int] = None,
                      fuse_w: int = 8, engine: str = "rle") -> NorthstarStream:
    """Load and compile a trace (or its first ``patches`` patches): for
    the run engines ``merge_patches`` -> ``compile_local_patches(lmax=
    longest insert)`` -> ``fuse_steps(fuse_w)``; for the per-character
    engines ``compile_local_patches(lmax=16, dmax=16)`` alone."""
    data = load_testing_data(trace_path(trace))
    plist = flatten_patches(data)
    if patches:
        plist = plist[:patches]
    want = data.end_content if not patches else apply_patches(plist)
    ins_total = sum(len(p.ins_content) for p in plist)
    if engine in CHAR_ENGINES:
        ops, _ = B.compile_local_patches(plist, lmax=CHAR_LMAX,
                                         dmax=CHAR_LMAX)
        return NorthstarStream(ops=ops, want=want, n_patches=len(plist),
                               steps_merged=ops.num_steps, fuse=None,
                               ins_total=ins_total, patches=plist)
    merged = B.merge_patches(plist)
    lmax = max([len(p.ins_content) for p in merged] + [1])
    ops, _ = B.compile_local_patches(merged, lmax=lmax, dmax=None)
    steps_merged = ops.num_steps
    fstats = None
    if fuse_w > 1:
        ops, fstats = B.fuse_steps(ops, fuse_w=fuse_w)
    return NorthstarStream(ops=ops, want=want, n_patches=len(plist),
                           steps_merged=steps_merged, fuse=fstats,
                           ins_total=ins_total, patches=plist)


def char_geometry(ins_total: int, capacity: Optional[int] = None):
    """``(capacity, block_k)`` of the per-character engines (bench.py's
    rule): ``capacity`` (default ``2 << ceil(log2(max(ins_total, 64)))``
    rows) and K = min(512, capacity / 2)."""
    capacity = capacity or 2 << (max(ins_total, 64) - 1).bit_length()
    return capacity, min(512, capacity // 2)


def make_northstar_replayer(stream: NorthstarStream, batch: int = 512,
                            capacity: Optional[int] = None,
                            block_k: Optional[int] = None, groups: int = 1,
                            device=None, engine: str = "rle"):
    """The replayer of a compiled trace on ``engine`` (``capacity`` and
    ``block_k`` default to the engine's geometry; ``capacity`` is rounded
    up to whole blocks); every group replays the same stream. The
    replayers return a list of results, one a group, except ``blocked``'s,
    which takes one group and returns its one result."""
    if engine in CHAR_ENGINES:
        capacity, k_default = char_geometry(stream.ins_total, capacity)
        if engine == "blocked" and groups != 1:
            raise ValueError("the blocked engine replays one group")
        ops = [stream.ops] * groups if engine == "hbm" else stream.ops
        return CHAR_ENGINES[engine](ops, capacity=capacity, batch=batch,
                                    block_k=block_k or k_default,
                                    device=device)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of "
                         f"{sorted(ENGINES) + sorted(CHAR_ENGINES)}")
    make, k_default, cap_default = ENGINES[engine]
    block_k = block_k or k_default
    capacity = capacity or cap_default
    capacity = ((capacity + block_k - 1) // block_k) * block_k
    return make([stream.ops] * groups, capacity=capacity, batch=batch,
                block_k=block_k, device=device)


def groups_equal(results) -> bool:
    """Every group's result equals group 0's in every tensor output,
    compared on their device (the groups replay one stream)."""
    first = results[0]
    for r in results[1:]:
        for f in dataclasses.fields(first):
            a, b = getattr(first, f.name), getattr(r, f.name)
            if isinstance(a, torch.Tensor) and not torch.equal(a, b):
                return False
    return True


def run_northstar(trace: str = "automerge-paper", batch: int = 512,
                  capacity: Optional[int] = None,
                  block_k: Optional[int] = None, fuse_w: int = 8,
                  groups: int = 1, patches: Optional[int] = None,
                  device=None, engine: str = "rle",
                  stream: Optional[NorthstarStream] = None) -> NorthstarRun:
    """Compile (unless a compiled ``stream`` is given) and replay a trace
    into ``batch`` x ``groups`` identical documents on ``engine``; check
    doc 0 of group 0 against the trace, every group against group 0 on the
    device, and the native engine's text against the trace."""
    dev = resolve_device(device)
    if stream is None:
        stream = compile_northstar(trace, patches, fuse_w, engine)
    results = make_northstar_replayer(stream, batch, capacity, block_k,
                                      groups, dev, engine)()
    if not isinstance(results, list):
        results = [results]
    to_flat = blocked_to_flat if engine in CHAR_ENGINES else rle_to_flat
    doc = to_flat(stream.ops, results[0])
    return NorthstarRun(stream=stream, results=results, doc=doc,
                        text_ok=SA.to_string(doc) == stream.want,
                        groups_equal=groups_equal(results),
                        native_text=native_replay(stream.patches).to_string())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default="automerge-paper")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--engine", default="rle",
                    choices=sorted(ENGINES) + sorted(CHAR_ENGINES))
    ap.add_argument("--capacity", type=int, default=None,
                    help="run rows (default: the engine's, 20,992 / "
                         "32,768), or character rows (default: 2 << "
                         "ceil(log2(inserted chars)))")
    ap.add_argument("--block-k", type=int, default=None,
                    help="rows per block (default: the engine's, 128 / "
                         "512, or min(512, capacity / 2))")
    ap.add_argument("--fuse-w", type=int, default=8)
    ap.add_argument("--groups", type=int, default=1)
    ap.add_argument("--patches", type=int, default=0,
                    help="replay only the first N patches (0 = all)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run = run_northstar(args.trace, args.batch, args.capacity, args.block_k,
                        args.fuse_w, args.groups, args.patches or None, dev,
                        args.engine)
    print(json.dumps({
        "trace": args.trace, "patches": run.stream.n_patches,
        "steps": run.stream.steps, "steps_merged": run.stream.steps_merged,
        "engine": args.engine, "batch": args.batch, "groups": args.groups,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "text_ok": run.text_ok, "groups_equal": run.groups_equal,
        "native_ok": run.native_ok, "ok": run.ok}))
    return 0 if run.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
