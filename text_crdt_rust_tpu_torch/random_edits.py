"""Configuration 2 on the port: a seeded random-edit stream replayed into a
batch of identical documents by the run-block replay (``ops/rle.py``,
A1).

The pipeline of the JAX package's ``bench.py`` ``cfg_2``
(``bench.py:736-763``): ``random_patches(random.Random(42), 20000)``
(inserts of 1-5 characters and deletes of 1-4 at uniform positions),
``corpus.compile_rle`` (merge, ``lmax`` = min(longest insert, 512), the
capacity from the run-row dry run), K = 256, 128 documents. Random edits
barely merge (20,000 patches -> 19,996 steps) and runs stay short, so this
configuration stresses the kernel's splices and splits, not the merge.
The dry run is the reference's quadratic list walk, ~90 s on one core at
20,000 patches: pass a stream built elsewhere (``make_random_edits_stream``)
to keep it apart.

    python -m text_crdt_rust_tpu_torch.random_edits [--steps 20000]
        [--batch 128] [--device cpu]

prints one JSON line: the steps, the capacity, whether doc 0 reproduced
the generator's text, whether every lane equals lane 0 and whether the
native engine's text equals it (``chip_smoke.py`` times the replay).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random
from typing import List, Optional

import torch

from . import resolve_device
from .baseline import native_replay
from .corpus import BLOCK_K, RleStream, compile_rle
from .ops import span_arrays as SA
from .ops.rle import RleResult, make_replayer_rle, rle_to_flat
from .ops.rle_hbm import lanes_equal
from .utils.randedit import random_patches
from .utils.testdata import TestPatch

#: Config 2's patches and seed (``bench.py``; 2,000 at ``--smoke``).
STEPS = 20000
SEED = 42


@dataclasses.dataclass
class RandomEditsStream:
    """Config 2's generated and compiled stream."""

    patches: List[TestPatch]
    want: str             # the generator's text
    rle: RleStream

    @property
    def steps(self) -> int:
        return self.rle.steps


def make_random_edits_stream(steps: int = STEPS,
                             seed: int = SEED) -> RandomEditsStream:
    """Draw config 2's patches as the JAX package draws them and compile
    them (``compile_rle``)."""
    patches, content = random_patches(random.Random(seed), steps)
    return RandomEditsStream(patches=patches, want=content,
                             rle=compile_rle(patches))


@dataclasses.dataclass
class RandomEditsRun:
    """One replay of config 2 and its checks."""

    stream: RandomEditsStream
    result: RleResult
    text_ok: bool         # doc 0 reproduced the generator's text
    lanes_ok: bool        # every lane equals lane 0
    native_text: str      # the native engine's text

    @property
    def native_ok(self) -> bool:
        return self.native_text == self.stream.want

    @property
    def ok(self) -> bool:
        return self.text_ok and self.lanes_ok and self.native_ok


def make_random_edits_replayer(stream: RandomEditsStream, batch: int = 128,
                               device=None):
    """The replayer of config 2's stream at its geometry."""
    return make_replayer_rle(stream.rle.ops, capacity=stream.rle.capacity,
                             batch=batch, block_k=BLOCK_K, chunk=1024,
                             device=device)


def run_random_edits(steps: int = STEPS, batch: int = 128, seed: int = SEED,
                     device=None,
                     stream: Optional[RandomEditsStream] = None
                     ) -> RandomEditsRun:
    """Generate and compile (unless a ``stream`` is given) and replay
    config 2, then check doc 0, the lanes and the native engine's text. A
    capacity or bad-delete error flag raises."""
    dev = resolve_device(device)
    if stream is None:
        stream = make_random_edits_stream(steps, seed)
    res = make_random_edits_replayer(stream, batch, dev)()
    res.check()
    text = SA.to_string(rle_to_flat(stream.rle.ops, res))
    return RandomEditsRun(stream=stream, result=res,
                          text_ok=text == stream.want,
                          lanes_ok=lanes_equal(res),
                          native_text=native_replay(
                              stream.patches).to_string())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="random patches (2,000 at bench.py's smoke size)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run = run_random_edits(args.steps, args.batch, args.seed, dev)
    print(json.dumps({
        "patches": len(run.stream.patches), "steps": run.stream.steps,
        "capacity": run.stream.rle.capacity,
        "peak_rows": run.stream.rle.peak_rows, "batch": args.batch,
        "blocks_used": int(run.result.meta[0, 0]),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "text_ok": run.text_ok, "lanes_ok": run.lanes_ok,
        "native_ok": run.native_ok, "ok": run.ok}))
    return 0 if run.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
