"""Sync pipeline demo on the port: N documents, each streaming three
peers' remote ops through the causal buffer onto the per-lane engine
(counterpart of ``text_crdt_rust_tpu/examples/sync_stream.py``).

Per document, three peers edit concurrently; their RemoteTxns arrive
interleaved and OUT OF ORDER, ``parallel.causal.CausalBuffer`` holds them
until causally ready, ``ops.batch.compile_remote_txns`` turns the released
stream into device steps, and the un-blocked per-lane mixed engine
(``ops.rle_lanes_mixed``) applies every document's own stream, one op per
document per step, with the state (runs and by-order tables) carried
across chunks on the device. Every chunk is checked against the oracle.
The peers' edits are drawn from ``random.Random(seed)`` exactly as the
JAX package's demo draws them.

Usage::

    python -m text_crdt_rust_tpu_torch.examples.sync_stream \\
        [--docs N] [--chunks C] [--ops-per-chunk K] [--seed S] \\
        [--device cpu]

The device defaults to CUDA; without a card pass ``--device cpu``.
"""
from __future__ import annotations

import argparse
import random
import sys

import numpy as np

from .. import resolve_device
from ..common import txn_len
from ..models.oracle import ListCRDT
from ..models.sync import export_txns_since
from ..ops import batch as B
from ..ops import rle_lanes_mixed as RLM
from ..ops.rle_lanes import expand_lane
from ..parallel.causal import CausalBuffer
from ..utils.randedit import random_patches


def run(docs: int = 8, chunks: int = 3, ops_per_chunk: int = 15,
        seed: int = 7, device=None, log=print) -> dict:
    """Run the demo; raises if a document diverges from the oracle.
    Returns the counts of what was applied."""
    dev = resolve_device(device)
    rng = random.Random(seed)
    n = docs
    log(f"sync_stream: {n} docs x {chunks} chunks x 3 peers x "
        f"{ops_per_chunk} patches (seed={seed}) on {dev}")

    # Each doc's "network": three peer replicas editing concurrently;
    # their txn streams interleave and arrive shuffled per chunk.
    peers = []
    for _ in range(n):
        trio = []
        for name in ("ann", "bob", "cyd"):
            doc = ListCRDT()
            agent = doc.get_or_create_agent_id(name)
            trio.append((doc, agent, [0]))  # [watermark]
        peers.append(trio)

    def peer_chunk(doc, agent, wm):
        patches, _ = random_patches(rng, ops_per_chunk)
        # Continue this peer's own replica with fresh random edits.
        for p in patches:
            ln = len(doc)
            pos = min(p.pos, ln)
            if p.del_len and ln:
                doc.local_delete(agent, min(pos, ln - 1),
                                 min(p.del_len, ln - min(pos, ln - 1)))
            if p.ins_content:
                doc.local_insert(agent, min(pos, len(doc)), p.ins_content)
        txns = export_txns_since(doc, wm[0])
        wm[0] = doc.get_next_order()
        return txns

    buffers = [CausalBuffer() for _ in range(n)]
    tables = [B.AgentTable() for _ in range(n)]
    assigners = [None] * n
    oracles = [ListCRDT() for _ in range(n)]
    state = None
    rkl_acc = None  # host-accumulated author ranks: the YATA tiebreak
    #                 reads EXISTING items' ranks from the read-only rkl
    #                 input, so earlier chunks' entries must stay visible
    applied_txns = applied_ops = total_steps = launches = 0
    for c in range(chunks):
        opses = []
        for d in range(n):
            arrivals = []
            for doc, agent, wm in peers[d]:
                arrivals.extend(peer_chunk(doc, agent, wm))
            rng.shuffle(arrivals)  # the network reorders
            released = buffers[d].add_all(arrivals)
            for t in released:
                tables[d].add(t.id.agent)
                oracles[d].apply_remote_txn(t)
            ops, assigners[d] = B.compile_remote_txns(
                released, tables[d], assigner=assigners[d], lmax=8,
                dmax=None)
            opses.append(ops)
            applied_txns += len(released)
            applied_ops += sum(txn_len(t) for t in released)
        stacked = B.stack_ops(opses)
        # Rows accumulate across chunks (<= 2 per compiled step), so the
        # capacity bound is CUMULATIVE steps, not this chunk's.
        total_steps += stacked.num_steps
        capacity = ((1 + 2 * total_steps + 63) // 64) * 64
        adv = int(np.asarray(stacked.order_advance,
                             np.int64).sum(axis=0).max())
        base = rkl_acc.shape[0] if rkl_acc is not None else 0
        ocap = ((base + adv + 8 + 7) // 8) * 8
        _, _, rkl_c = RLM.lane_tables(stacked, ocap)
        if rkl_acc is not None:
            grown = np.zeros((ocap, n), np.int32)
            grown[: rkl_acc.shape[0]] = rkl_acc
            rkl_acc = np.where(rkl_c != 0, rkl_c, grown)
        else:
            rkl_acc = rkl_c
        replay = RLM.make_replayer_lanes_mixed(
            stacked, capacity=capacity, order_capacity=ocap, chunk=16,
            init=state, rkl=rkl_acc, device=dev)
        res = replay()
        launches += 1
        res.check()
        state = res.state()

        for d in range(n):
            want = [(-1 if oracles[d].deleted[i] else 1)
                    * (int(oracles[d].order[i]) + 1)
                    for i in range(oracles[d].n)]
            got = expand_lane(res, d).tolist()
            if got != want:
                raise AssertionError(f"doc {d} diverged from the oracle")
        log(f"  chunk {c + 1}/{chunks}: {applied_txns} txns / "
            f"{applied_ops} char-ops applied, capacity {capacity}, "
            f"all {n} docs == oracle")
    for d in range(n):
        if buffers[d].pending:
            raise AssertionError(
                f"doc {d}: {buffers[d].pending} txns never became ready "
                f"({buffers[d].missing()})")
    log(f"  done: {applied_txns} remote txns ({applied_ops} char-ops) "
        f"across {n} docs; every chunk oracle-checked")
    return dict(docs=n, chunks=chunks, txns=applied_txns,
                char_ops=applied_ops, steps=total_steps, replays=launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=8)
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--ops-per-chunk", type=int, default=15,
                    help="patches per peer per chunk")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.docs, args.chunks, args.ops_per_chunk, args.seed, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
