"""kevin on the port: millions of single-character prepends into one
document, replayed into a batch of identical documents by the HBM-plane
run engine (``ops/rle_hbm.py``).

The workload of upstream ``benches/yjs.rs:51-62``, as the JAX package's
``bench.py`` ``cfg_kevin`` runs it: ``n`` prepends of ``" "`` at position
0, once on the native C++ engine (``baseline.replay_trace`` of
``kevin_columns``, checked to hold ``n`` spaces; ~3 s at 5M prepends;
``chip_smoke.py`` times it) and on the device engine. Runs cannot merge
backwards (each char precedes the previous one), so the state is one run
row per prepend; the whole stream is one backwards-contiguous burst, so
``compile_local_patches`` fuses it into ``n / fuse_w`` W-row steps.
Geometry (``bench.py:1590-1607``): K = 2,048 above 2M prepends, else 512;
capacity ``ceil(2.1 n / K) K`` run rows (splits leave blocks half full);
128 documents; no per-op origins above 2M prepends (at 5M they would take
5.1 GB beside the 10.75 GB of planes).

    python -m text_crdt_rust_tpu_torch.kevin [--n 5000000] [--device cpu]

prints one JSON line with the step count, the geometry, whether lane 0
reads the orders ``n .. 1`` (prepends reverse insertion order) with every
lane equal to lane 0, and whether the native engine holds ``n`` spaces
(``chip_smoke.py`` times the replay).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .baseline import replay_trace
from .ops import batch as B
from .ops.rle import RleResult, expand_runs
from .ops.rle_hbm import lanes_equal, make_replayer_rle_hbm
from .utils.testdata import TestPatch

#: Above this many prepends kevin takes the large geometry.
BIG = 2_000_000


@dataclasses.dataclass
class KevinStream:
    """A compiled kevin stream."""

    ops: B.OpTensors
    n: int          # prepends
    fuse_w: int     # rows per fused step

    @property
    def steps(self) -> int:
        return self.ops.num_steps


@dataclasses.dataclass
class KevinRun:
    """One kevin replay and its check."""

    stream: KevinStream
    result: RleResult
    order_ok: bool      # lane 0 expands to orders n .. 1
    lanes_equal: bool   # every lane equals lane 0 over the used blocks
    native_text: str    # the native engine's text after the n prepends

    @property
    def native_ok(self) -> bool:
        return self.native_text == " " * self.stream.n

    @property
    def ok(self) -> bool:
        return self.order_ok and self.lanes_equal and self.native_ok


def compile_kevin(n: int = 5_000_000, fuse_w: int = 64) -> KevinStream:
    """``n`` single-char prepends, fused into W-row steps."""
    ops, _ = B.compile_local_patches([TestPatch(0, 0, " ")] * n,
                                     lmax=fuse_w, fuse_w=fuse_w)
    return KevinStream(ops=ops, n=n, fuse_w=fuse_w)


def kevin_columns(n: int):
    """The native replay's four u32 columns of ``n`` prepends of ``" "``
    (``bench.py:1563-1567``)."""
    return (np.zeros(n, np.uint32), np.zeros(n, np.uint32),
            np.ones(n, np.uint32), np.full(n, ord(" "), np.uint32))


def kevin_capacity(n: int, block_k: int) -> int:
    """Run rows for ``n`` prepends: 2.1 n rounded up to whole blocks."""
    return ((n * 21 // 10 + block_k - 1) // block_k) * block_k


def kevin_geometry(n: int):
    """``(block_k, capacity, store_origins)`` of an ``n``-prepend run."""
    big = n > BIG
    block_k = 2048 if big else 512
    return block_k, kevin_capacity(n, block_k), not big


def make_kevin_replayer(stream: KevinStream, batch: int = 128,
                        block_k: Optional[int] = None,
                        store_origins: Optional[bool] = None, device=None):
    """The replayer of a compiled kevin stream; unset geometry comes from
    ``kevin_geometry`` (the capacity from ``n`` and ``block_k``)."""
    k0, _, store0 = kevin_geometry(stream.n)
    block_k = block_k or k0
    store = store0 if store_origins is None else store_origins
    return make_replayer_rle_hbm(stream.ops,
                                 capacity=kevin_capacity(stream.n, block_k),
                                 batch=batch, block_k=block_k,
                                 store_origins=store, device=device)


def check_kevin(res: RleResult, n: int):
    """``(order_ok, lanes_equal)``: lane 0 reads ``arange(n, 0, -1)`` (the
    check of ``bench.py:1608-1613``), every lane equals lane 0."""
    flat = expand_runs(res)
    order_ok = len(flat) == n and bool(
        (flat == np.arange(n, 0, -1, dtype=np.int32)).all())
    return order_ok, lanes_equal(res)


def run_kevin(n: int = 5_000_000, batch: int = 128, fuse_w: int = 64,
              block_k: Optional[int] = None, device=None,
              stream: Optional[KevinStream] = None) -> KevinRun:
    """Compile (unless a compiled ``stream`` is given) and replay kevin
    into ``batch`` identical documents, check them, and replay the
    prepends once on the native engine."""
    dev = resolve_device(device)
    if stream is None:
        stream = compile_kevin(n, fuse_w)
    res = make_kevin_replayer(stream, batch, block_k, device=dev)()
    order_ok, equal = check_kevin(res, stream.n)
    return KevinRun(stream=stream, result=res, order_ok=order_ok,
                    lanes_equal=equal,
                    native_text=replay_trace(
                        kevin_columns(stream.n)).to_string())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=5_000_000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--fuse-w", type=int, default=64)
    ap.add_argument("--block-k", type=int, default=None,
                    help="rows per block (default: 2,048 above 2M "
                         "prepends, else 512)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run = run_kevin(args.n, args.batch, args.fuse_w, args.block_k,
                    device=dev)
    res = run.result
    print(json.dumps({
        "n": args.n, "steps": run.stream.steps, "fuse_w": args.fuse_w,
        "batch": args.batch, "block_k": res.block_k,
        "capacity": res.ordp.shape[0], "blocks_used": int(res.meta[0, 0]),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "order_ok": run.order_ok, "lanes_equal": run.lanes_equal,
        "native_ok": run.native_ok, "ok": run.ok}))
    return 0 if run.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
