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
        [--rounds 200] [--batch 128]

prints one JSON line with the step and op counts and whether doc 0
reproduced the oracle (``chip_smoke.py`` times the replay).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List

import torch

from . import resolve_device
from .common import RemoteTxn, txn_len
from .ops import batch as B
from .ops import span_arrays as SA
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
    result: RleMixedResult
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


def make_storm_replayer(stream: StormStream, batch: int = 128,
                        block_k: int = 128, fast_integrate: bool = True,
                        device=None):
    """The replayer of a compiled storm at bench.py's capacity."""
    return make_replayer_rle_mixed(
        stream.ops, capacity=storm_capacity(stream.ops, block_k),
        batch=batch, block_k=block_k, chunk=1024,
        fast_integrate=fast_integrate, device=device)


def run_storm(n_peers: int = 16, rounds: int = 200, run_len: int = 4,
              seed: int = 7, del_prob: float = 0.0, batch: int = 128,
              block_k: int = 128, fast_integrate: bool = True,
              device=None) -> StormRun:
    """Generate, compile and replay a storm into ``batch`` identical
    documents, and check doc 0 against the oracle receiver."""
    dev = resolve_device(device)
    stream = make_storm_stream(n_peers, rounds, run_len, seed, del_prob)
    res = make_storm_replayer(stream, batch, block_k, fast_integrate, dev)()
    res.check()
    doc = rle_to_flat(stream.ops, res)
    return StormRun(stream=stream, result=res, doc=doc,
                    ok=SA.to_string(doc) == stream.want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--del-prob", type=float, default=0.0,
                    help="0.35 for the delete-heavy variant")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run = run_storm(rounds=args.rounds, del_prob=args.del_prob,
                    batch=args.batch, device=dev)
    print(json.dumps({
        "rounds": args.rounds, "del_prob": args.del_prob,
        "txns": len(run.stream.txns), "steps": run.stream.steps,
        "char_ops": run.stream.char_ops, "batch": args.batch,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "ok": run.ok}))
    return 0 if run.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
