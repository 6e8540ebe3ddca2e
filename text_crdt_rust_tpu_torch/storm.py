"""The config-4 concurrent-insert storm on the port: N peers' remote
transactions replayed into a batch of identical documents by the mixed
run replay (``ops.rle_mixed``).

The pipeline of the JAX package's ``bench.py`` ``cfg_4`` (its C++ native
baseline left out): generate the storm with the oracle
(``utils.randedit.make_storm``), compile its txns against the sorted
agent table (``lmax = min(16, 2*run_len)``; deletes chunked at 16 orders
in the insert storm, whole in the delete-heavy one), size the run
capacity by bench.py's rule (3 rows per step, whole blocks), replay on
``batch`` lanes, expand doc 0 to a ``FlatDoc`` and check its text against
the oracle receiver's.

    python -m text_crdt_rust_tpu_torch.storm [--del-prob 0.35] [--device cpu]
        [--rounds 200] [--batch 128] [--engine rle-mixed|blocked-mixed]

prints one JSON line with the step and op counts and whether doc 0
reproduced the oracle (``chip_smoke.py`` times the replay).

``--engine blocked-mixed`` replays the insert storm on the per-character
engine (``ops/blocked_mixed.py``) at ``bench.py --engine
blocked-mixed``'s geometry: capacity ``2 << ceil(log2(inserted chars))``
character rows, K = min(256, capacity / 2), at most 128 documents.
``bench.py`` runs the insert storm there; the delete-heavy one replays
too, as long as its delete runs stay within the engine's 16 targets a
step.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional, Union

import numpy as np
import torch

from . import resolve_device
from .common import RemoteTxn, txn_len
from .ops import batch as B
from .ops import span_arrays as SA
from .ops.blocked import BlockedResult, blocked_to_flat
from .ops.blocked_mixed import make_replayer_mixed
from .ops.rle import rle_to_flat
from .ops.rle_mixed import RleMixedResult, make_replayer_rle_mixed
from .utils.randedit import make_storm


@dataclasses.dataclass
class StormStream:
    """A generated and compiled storm: the txns, their op stream and what
    the replay must reproduce."""

    txns: List[RemoteTxn]
    ops: B.OpTensors
    want: str           # the oracle receiver's text
    char_ops: int       # chars inserted + chars deleted (the ops/s numerator)

    @property
    def steps(self) -> int:
        return self.ops.num_steps


@dataclasses.dataclass
class StormRun:
    """One replay of a compiled storm."""

    stream: StormStream
    result: Union[RleMixedResult, BlockedResult]
    doc: SA.FlatDoc      # doc 0, expanded
    ok: bool             # doc 0 reproduced ``want``


def storm_capacity(ops: B.OpTensors, block_k: int) -> int:
    """Run rows for a storm (bench.py's rule): every step splices at most
    3 rows, at least 256, rounded up to whole blocks."""
    return ((max(ops.num_steps * 3, 256) + block_k - 1) // block_k) * block_k


def compile_storm_txns(txns, run_len: int, del_prob: float) -> B.OpTensors:
    """Compile storm txns as ``cfg_4`` does: sorted agent table,
    ``lmax = min(16, 2*run_len)``, ``dmax`` 16 for the insert storm and
    None (one-pass interval deletes) for the delete-heavy one."""
    table = B.AgentTable(sorted({t.id.agent for t in txns}))
    ops, _ = B.compile_remote_txns(
        txns, table, lmax=min(16, 2 * run_len),
        dmax=16 if del_prob == 0 else None)
    return ops


def make_storm_stream(n_peers: int = 16, rounds: int = 200,
                      run_len: int = 4, seed: int = 7,
                      del_prob: float = 0.0) -> StormStream:
    """Generate a storm with the oracle and compile it."""
    txns, receiver = make_storm(n_peers, rounds, run_len, seed=seed,
                                del_prob=del_prob)
    return StormStream(
        txns=txns, ops=compile_storm_txns(txns, run_len, del_prob),
        want=receiver.to_string(), char_ops=sum(txn_len(t) for t in txns))


def char_capacity(ops: B.OpTensors) -> int:
    """Character rows for a storm on ``blocked-mixed`` (bench.py's rule):
    ``2 << ceil(log2(max(inserted chars, 256)))``."""
    total = int(np.asarray(ops.ins_len, dtype=np.int64).sum())
    return 2 << (max(total, 256) - 1).bit_length()


#: Storm engines: the run replay (the default) and the per-character one.
ENGINES = ("rle-mixed", "blocked-mixed")


def make_storm_replayer(stream: StormStream, batch: int = 128,
                        block_k: Optional[int] = None,
                        fast_integrate: bool = True, device=None,
                        engine: str = "rle-mixed"):
    """The replayer of a compiled storm at bench.py's geometry for
    ``engine`` (``block_k`` defaults to 128 on ``rle-mixed`` and to
    min(256, capacity / 2) on ``blocked-mixed``, whose batch is at most
    128)."""
    if engine == "blocked-mixed":
        capacity = char_capacity(stream.ops)
        return make_replayer_mixed(
            stream.ops, capacity=capacity, batch=min(batch, 128),
            block_k=block_k or min(256, capacity // 2), chunk=1024,
            device=device)
    if engine != "rle-mixed":
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    block_k = block_k or 128
    return make_replayer_rle_mixed(
        stream.ops, capacity=storm_capacity(stream.ops, block_k),
        batch=batch, block_k=block_k, chunk=1024,
        fast_integrate=fast_integrate, device=device)


def run_storm(n_peers: int = 16, rounds: int = 200, run_len: int = 4,
              seed: int = 7, del_prob: float = 0.0, batch: int = 128,
              block_k: Optional[int] = None, fast_integrate: bool = True,
              device=None, engine: str = "rle-mixed") -> StormRun:
    """Generate, compile and replay a storm into ``batch`` identical
    documents on ``engine``, and check doc 0 against the oracle
    receiver."""
    dev = resolve_device(device)
    stream = make_storm_stream(n_peers, rounds, run_len, seed, del_prob)
    res = make_storm_replayer(stream, batch, block_k, fast_integrate, dev,
                              engine)()
    res.check()
    to_flat = blocked_to_flat if engine == "blocked-mixed" else rle_to_flat
    doc = to_flat(stream.ops, res)
    return StormRun(stream=stream, result=res, doc=doc,
                    ok=SA.to_string(doc) == stream.want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--del-prob", type=float, default=0.0,
                    help="0.35 for the delete-heavy variant")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--engine", default="rle-mixed", choices=ENGINES)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run = run_storm(rounds=args.rounds, del_prob=args.del_prob,
                    batch=args.batch, device=dev, engine=args.engine)
    print(json.dumps({
        "engine": args.engine, "rounds": args.rounds,
        "del_prob": args.del_prob,
        "txns": len(run.stream.txns), "steps": run.stream.steps,
        "char_ops": run.stream.char_ops, "batch": args.batch,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "ok": run.ok}))
    return 0 if run.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
