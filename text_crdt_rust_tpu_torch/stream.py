"""The streaming configs on the port: thousands of divergent documents, each
applying its own stream chunk after chunk with the device state carried
across chunks and a host checkpoint every few chunks.

Config 5r (``bench.py`` ``cfg_5_remote``, its C++ native baseline left
out), on the blocked per-lane MIXED engine: each of ``n_docs`` documents
gets its own peer: ``utils.randedit.continue_patches`` continues a random
delete-heavy edit stream (``ins_prob`` 0.45) from ``random.Random(seed_base
+ d)``, and ``utils.randedit.PeerSynth`` turns it into that peer's remote
txns. One ``AgentTable`` and one order assigner per document compile each
chunk (``lmax`` 4, whole interval deletes); every chunk is padded to the
suite-wide step count rounded up to 128. Run capacities grow per chunk
from the row invariant (``batch.row_growth_bound`` of the cumulative
compiled steps, whole K-row blocks, at least 4 blocks) and order
capacities from ``lmax * steps_per_chunk`` per chunk. ``run_stream`` then
checks every ``n_docs // 8``-th document against the oracle in signed
state and text.

Config 5 (``bench.py`` ``cfg_5``), on the blocked per-lane LOCAL engine:
each document replays its own fresh local edits, ``continue_patches`` from
``random.Random(1000 + d)``, compiled per document by
``compile_local_patches`` (``lmax`` over the whole stream, whole deletes,
each chunk's orders following the last). Run capacities grow per chunk
from ``row_growth_bound(steps_per_chunk * (c + 1))`` in whole blocks, at
least 4. ``run_stream_5`` checks every ``n_docs // 8``-th document's
text, rebuilt from its runs and the staged chars, against the string
simulation.

``stream_loop`` chains either config's chunks on the device, checks every
chunk's error flags and round-trips the state through an ``.npz``
checkpoint every ``resync_every`` chunks.

    python -m text_crdt_rust_tpu_torch.stream [--config 5r|5] [--docs 2048]
        [--chunks 8] [--steps 100] [--resync-every 4] [--device cpu]

prints one JSON line (``chip_smoke.py`` times the chains on the card).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import tempfile
from typing import Callable, List, Optional

import numpy as np
import torch

from . import resolve_device
from .common import RemoteTxn, txn_len
from .config import lane_block_geometry
from .models.oracle import ListCRDT
from .ops import batch as B
from .ops import rle_lanes as RL
from .ops import rle_lanes_mixed as RLM
from .ops.rle_lanes import expand_lane
from .utils.randedit import PeerSynth, continue_patches

#: ``state()`` keys of the two 5r engines (the checkpoint's array names).
STATE_KEYS = {
    "blocked": RLM.BlockedLanesMixedResult.STATE_KEYS,
    "unblocked": ("ordp", "lenp", "rows", "oll", "orl"),
}
#: ``state()`` keys of the two config-5 engines.
STATE_KEYS_5 = {
    "blocked": RL.BlockedLanesResult.STATE_KEYS,
    "unblocked": RL.LanesResult.STATE_KEYS,
}


@dataclasses.dataclass
class Stream5r:
    """A generated and compiled config-5r stream."""

    n_docs: int
    steps_per_chunk: int
    lmax: int
    all_txns: List[List[RemoteTxn]]   # per document, every chunk
    contents: List[str]               # each document's final text
    stacked: List[B.OpTensors]        # per chunk, [smax, n_docs]
    real_steps: List[int]             # per chunk, before padding
    char_ops: int                     # ins chars + delete targets, all docs

    @property
    def chunks(self) -> int:
        return len(self.stacked)

    @property
    def steps(self) -> int:
        """Device steps of the whole chain (padded chunks)."""
        return sum(s.num_steps for s in self.stacked)


def generate_5r(n_docs: int = 2048, chunks: int = 8,
                steps_per_chunk: int = 100, seed_base: int = 7000):
    """Generate the config-5r streams (``bench.py`` ``cfg_5_remote``'s
    generation, step for step): ``(chunk_txns, contents)``, each chunk's
    remote txns per document and each document's final text."""
    rngs = [random.Random(seed_base + d) for d in range(n_docs)]
    contents = [""] * n_docs
    synths = [PeerSynth(f"peer{d}") for d in range(n_docs)]
    chunk_txns = []
    for _ in range(chunks):
        per_doc = []
        for d in range(n_docs):
            patches, contents[d] = continue_patches(
                rngs[d], contents[d], steps_per_chunk, ins_prob=0.45)
            per_doc.append(synths[d].apply(patches))
        chunk_txns.append(per_doc)
    return chunk_txns, contents


def compile_5r(chunk_txns, contents: List[str], steps_per_chunk: int = 100,
               lmax: int = 4) -> Stream5r:
    """Compile generated config-5r streams (``bench.py`` ``cfg_5_remote``'s
    compile): one ``AgentTable`` and one order assigner per document,
    every chunk padded to the suite-wide step count rounded up to 128."""
    n_docs = len(contents)
    tables = [B.AgentTable([f"peer{d}"]) for d in range(n_docs)]
    assigners = [None] * n_docs
    all_txns: List[List[RemoteTxn]] = [[] for _ in range(n_docs)]
    stacked, char_ops = [], 0
    for per_doc in chunk_txns:
        opses = []
        for d, txns in enumerate(per_doc):
            ops, assigners[d] = B.compile_remote_txns(
                txns, tables[d], assigner=assigners[d], lmax=lmax,
                dmax=None)
            opses.append(ops)
            all_txns[d].extend(txns)
            char_ops += sum(txn_len(t) for t in txns)
        stacked.append(B.stack_ops(opses))
    real_steps = [s.num_steps for s in stacked]
    smax = ((max(real_steps) + 127) // 128) * 128
    stacked = [B.pad_ops(s, smax) for s in stacked]
    return Stream5r(n_docs=n_docs, steps_per_chunk=steps_per_chunk,
                    lmax=lmax, all_txns=all_txns, contents=contents,
                    stacked=stacked, real_steps=real_steps,
                    char_ops=char_ops)


def make_stream_5r(n_docs: int = 2048, chunks: int = 8,
                   steps_per_chunk: int = 100, seed_base: int = 7000,
                   lmax: int = 4) -> Stream5r:
    """Generate and compile the config-5r streams."""
    chunk_txns, contents = generate_5r(n_docs, chunks, steps_per_chunk,
                                       seed_base)
    return compile_5r(chunk_txns, contents, steps_per_chunk, lmax)


def stream_capacities(stream: Stream5r, block_k: int = 64):
    """(run capacities, order capacities) per chunk: the row bound of the
    cumulative compiled steps in whole blocks (at least 4), and
    ``lmax * steps_per_chunk`` orders per chunk so far."""
    cum = np.cumsum(stream.real_steps)
    caps = [max(lane_block_geometry(B.row_growth_bound(int(cs)),
                                    block_k)[0], 4 * block_k) for cs in cum]
    ocaps = [((stream.lmax * stream.steps_per_chunk * (c + 1) + stream.lmax
               + 7) // 8) * 8 for c in range(stream.chunks)]
    return caps, ocaps


def make_stream_replayers(stream: Stream5r, block_k: int = 64,
                          engine: str = "blocked", device=None):
    """One replayer per chunk at that chunk's capacities. ``engine`` is
    ``"blocked"`` (the config-5r engine) or ``"unblocked"`` (its
    bit-identical cross-check)."""
    dev = resolve_device(device)
    caps, ocaps = stream_capacities(stream, block_k)
    if engine == "blocked":
        return [RLM.make_replayer_lanes_mixed_blocked(
            st, capacity=cap, block_k=block_k, order_capacity=ocap,
            chunk=128, device=dev)
            for st, cap, ocap in zip(stream.stacked, caps, ocaps)]
    if engine == "unblocked":
        return [RLM.make_replayer_lanes_mixed(
            st, capacity=cap, order_capacity=ocap, chunk=128, device=dev)
            for st, cap, ocap in zip(stream.stacked, caps, ocaps)]
    raise ValueError(f"unknown engine {engine!r}")


@dataclasses.dataclass
class LoopStats:
    """What ``stream_loop`` did, with times when it was given a clock."""

    resyncs: int = 0
    checked: int = 0              # chunk results whose flags were read
    wall_s: Optional[float] = None    # apply time, checkpoints excluded
    ckpt_ms: Optional[float] = None   # checkpoint round trips, in all


def stream_loop(runners, resync_every: int, ckpt_path: str, state_keys,
                clock: Optional[Callable[[], float]] = None,
                on_chunk: Optional[Callable] = None):
    """Chain ``runners`` with the state resident on the device. Every
    chunk's result is ``check()``ed (its error flags re-zero per launch,
    so skipping one would lose them); every ``resync_every`` chunks but
    the last the state round-trips through an ``.npz`` checkpoint at
    ``ckpt_path``, off the apply time. ``clock`` (seconds, e.g. the
    caller's ``time.perf_counter``) times the two apart; ``on_chunk(ci,
    res)`` sees every chunk's result. Returns ``(last result,
    LoopStats)``."""
    stats = LoopStats()
    state = None
    pending = []
    wall = ckpt_ms = 0.0
    t0 = clock() if clock else 0.0
    res = None
    for ci, run in enumerate(runners):
        res = run(state)
        state = res.state()
        pending.append(res)
        if on_chunk is not None:
            on_chunk(ci, res)
        if (ci + 1) % resync_every == 0 and ci + 1 < len(runners):
            res.err.cpu()  # completion fence of the segment
            if clock:
                wall += clock() - t0
                tc = clock()
            for r_ in pending:
                r_.check()
                stats.checked += 1
            pending.clear()
            arrs = [t.cpu().numpy() for t in res.state()]
            np.savez(ckpt_path, **dict(zip(state_keys, arrs)))
            with np.load(ckpt_path) as z:
                state = tuple(z[k] for k in state_keys)
            stats.resyncs += 1
            if clock:
                ckpt_ms += (clock() - tc) * 1e3
                t0 = clock()
    res.err.cpu()
    if clock:
        wall += clock() - t0
        stats.wall_s, stats.ckpt_ms = wall, ckpt_ms
    for r_ in pending:
        r_.check()
        stats.checked += 1
    return res, stats


def oracle_signed(txns) -> tuple:
    """(signed per-char state, text) of an oracle document that applied
    ``txns``."""
    doc = ListCRDT()
    for t in txns:
        doc.apply_remote_txn(t)
    signed = [(-1 if doc.deleted[i] else 1) * (int(doc.order[i]) + 1)
              for i in range(doc.n)]
    return signed, doc.to_string()


def sample_docs(n_docs: int) -> List[int]:
    """The documents checked against the oracle: every ``n_docs // 8``-th."""
    return list(range(0, n_docs, max(1, n_docs // 8)))


def check_docs(stream: Stream5r, res) -> bool:
    """Every sampled document of ``res`` equals the oracle in signed state
    and text, and the oracle equals the string simulation."""
    ok = True
    for d in sample_docs(stream.n_docs):
        want, text = oracle_signed(stream.all_txns[d])
        ok = ok and expand_lane(res, d).tolist() == want \
            and text == stream.contents[d]
    return ok


@dataclasses.dataclass
class StreamRun:
    """One run of a streaming path."""

    stream: object            # a Stream5r or a Stream5
    result: object            # the last chunk's result
    stats: LoopStats
    ok: bool                  # every sampled document equals the oracle


def run_stream(n_docs: int = 2048, chunks: int = 8,
               steps_per_chunk: int = 100, seed_base: int = 7000,
               block_k: int = 64, resync_every: int = 4,
               engine: str = "blocked", device=None,
               stream: Optional[Stream5r] = None,
               clock: Optional[Callable[[], float]] = None,
               on_chunk: Optional[Callable] = None) -> StreamRun:
    """Generate (unless ``stream`` is given), compile and apply the
    config-5r streams chunk by chunk, then check the sampled documents
    against the oracle."""
    dev = resolve_device(device)
    if stream is None:
        stream = make_stream_5r(n_docs, chunks, steps_per_chunk, seed_base)
    runners = make_stream_replayers(stream, block_k, engine, dev)
    with tempfile.TemporaryDirectory(prefix="tcr_stream_") as tmp:
        res, stats = stream_loop(
            runners, resync_every, os.path.join(tmp, "resync.npz"),
            STATE_KEYS[engine], clock=clock, on_chunk=on_chunk)
    return StreamRun(stream=stream, result=res, stats=stats,
                     ok=check_docs(stream, res))


# -- config 5: divergent per-document local streams ------------------------------


@dataclasses.dataclass
class Stream5:
    """A generated and compiled config-5 stream."""

    n_docs: int
    steps_per_chunk: int
    lmax: int
    contents: List[str]               # each document's final text
    stacked: List[B.OpTensors]        # per chunk, [S_c, n_docs]
    n_patches: int                    # all documents, all chunks

    @property
    def chunks(self) -> int:
        return len(self.stacked)

    @property
    def real_steps(self) -> List[int]:
        """Compiled steps per chunk (one per patch; each replayer pads its
        chunk to a multiple of 128)."""
        return [s.num_steps for s in self.stacked]

    @property
    def steps(self) -> int:
        """Device steps of the whole chain (chunks padded to 128)."""
        return sum(max((s + 127) // 128, 1) * 128 for s in self.real_steps)


def generate_5(n_docs: int = 2048, chunks: int = 8,
               steps_per_chunk: int = 100, seed_base: int = 1000):
    """Generate the config-5 streams (``bench.py`` ``cfg_5``'s generation,
    step for step): ``(chunk_patches, contents)``, each chunk's local
    patches per document and each document's final text."""
    rngs = [random.Random(seed_base + d) for d in range(n_docs)]
    contents = [""] * n_docs
    chunk_patches = []
    for _ in range(chunks):
        per_doc = []
        for d in range(n_docs):
            patches, contents[d] = continue_patches(
                rngs[d], contents[d], steps_per_chunk, ins_prob=0.45)
            per_doc.append(patches)
        chunk_patches.append(per_doc)
    return chunk_patches, contents


def compile_5(chunk_patches, contents: List[str]) -> Stream5:
    """Compile generated config-5 streams (``bench.py`` ``cfg_5``'s
    compile): ``compile_local_patches`` per document and chunk, ``lmax``
    over the whole stream, whole deletes, each chunk's orders starting
    where the document's last chunk stopped; then ``stack_ops``."""
    n_docs = len(contents)
    steps_per_chunk = len(chunk_patches[0][0])
    lmax = max((len(p.ins_content) for per_doc in chunk_patches
                for ps in per_doc for p in ps), default=1) or 1
    next_orders = [0] * n_docs
    stacked, n_patches = [], 0
    for per_doc in chunk_patches:
        opses = []
        for d, patches in enumerate(per_doc):
            ops, next_orders[d] = B.compile_local_patches(
                patches, lmax=lmax, dmax=None, start_order=next_orders[d])
            opses.append(ops)
            n_patches += len(patches)
        stacked.append(B.stack_ops(opses))
    return Stream5(n_docs=n_docs, steps_per_chunk=steps_per_chunk,
                   lmax=lmax, contents=contents, stacked=stacked,
                   n_patches=n_patches)


def make_stream_5(n_docs: int = 2048, chunks: int = 8,
                  steps_per_chunk: int = 100,
                  seed_base: int = 1000) -> Stream5:
    """Generate and compile the config-5 streams."""
    chunk_patches, contents = generate_5(n_docs, chunks, steps_per_chunk,
                                         seed_base)
    return compile_5(chunk_patches, contents)


def stream_capacities_5(stream: Stream5, block_k: int = 64) -> List[int]:
    """Run capacity per chunk: the row bound of ``steps_per_chunk`` patches
    per chunk so far, in whole K-row blocks, at least 4 blocks."""
    return [max(lane_block_geometry(
        B.row_growth_bound(stream.steps_per_chunk * (c + 1)), block_k)[0],
        4 * block_k) for c in range(stream.chunks)]


def stream_replayers_5(stream: Stream5, block_k: int = 64,
                       engine: str = "blocked", device=None):
    """One replayer per chunk at that chunk's capacity, ``chunk`` 128.
    ``engine`` is ``"blocked"`` (the config-5 engine) or ``"unblocked"``
    (its bit-identical cross-check)."""
    dev = resolve_device(device)
    caps = stream_capacities_5(stream, block_k)
    if engine == "blocked":
        return [RL.make_replayer_lanes_blocked(
            st, capacity=cap, block_k=block_k, chunk=128, device=dev)
            for st, cap in zip(stream.stacked, caps)]
    if engine == "unblocked":
        return [RL.make_replayer_lanes(st, capacity=cap, chunk=128,
                                       device=dev)
                for st, cap in zip(stream.stacked, caps)]
    raise ValueError(f"unknown engine {engine!r}")


def lane_text(stream: Stream5, res, d: int) -> str:
    """Document ``d``'s text: its live chars in document order (from the
    runs), each looked up by order in the staged chars of every chunk."""
    chars = {}
    for st in stream.stacked:
        ilens = np.asarray(st.ins_len)[:, d]
        starts = np.asarray(st.ins_order_start)[:, d]
        cps = np.asarray(st.chars)[:, d]
        for s in np.nonzero(ilens)[0]:
            for j in range(int(ilens[s])):
                chars[int(starts[s]) + j] = chr(int(cps[s, j]))
    return "".join(chars[int(o) - 1] for o in expand_lane(res, d) if o > 0)


def check_docs_5(stream: Stream5, res) -> bool:
    """Every sampled document's text equals the string simulation."""
    return all(lane_text(stream, res, d) == stream.contents[d]
               for d in sample_docs(stream.n_docs))


def run_stream_5(n_docs: int = 2048, chunks: int = 8,
                 steps_per_chunk: int = 100, seed_base: int = 1000,
                 block_k: int = 64, resync_every: int = 4,
                 engine: str = "blocked", device=None,
                 stream: Optional[Stream5] = None,
                 clock: Optional[Callable[[], float]] = None,
                 on_chunk: Optional[Callable] = None) -> StreamRun:
    """Generate (unless ``stream`` is given), compile and apply the config-5
    streams chunk by chunk, then check the sampled documents' texts."""
    dev = resolve_device(device)
    if stream is None:
        stream = make_stream_5(n_docs, chunks, steps_per_chunk, seed_base)
    runners = stream_replayers_5(stream, block_k, engine, dev)
    with tempfile.TemporaryDirectory(prefix="tcr_stream5_") as tmp:
        res, stats = stream_loop(
            runners, resync_every, os.path.join(tmp, "resync.npz"),
            STATE_KEYS_5[engine], clock=clock, on_chunk=on_chunk)
    return StreamRun(stream=stream, result=res, stats=stats,
                     ok=check_docs_5(stream, res))


def step_latency_5(runners, real_steps: List[int],
                   clock: Callable[[], float]) -> dict:
    """Per-step latency distribution (``bench.py`` ``_step_latency_pass``):
    one more chain of ``runners`` with a blocking read of each chunk's
    flags; each sample is that chunk's blocking time over its real steps,
    in microseconds. ``clock`` is the caller's (seconds)."""
    samples = []
    state = None
    for run, steps in zip(runners, real_steps):
        t0 = clock()
        res = run(state)
        res.err.cpu()
        samples.append((clock() - t0) / max(steps, 1) * 1e6)
        state = res.state()
    ss = sorted(samples)
    return {"p50_us": ss[len(ss) // 2],
            "p99_us": ss[min(len(ss) - 1, int(round((len(ss) - 1) * 0.99)))],
            "samples_us": samples}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=("5r", "5"), default="5r",
                    help="5r: remote streams; 5: local streams")
    ap.add_argument("--docs", type=int, default=2048)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100,
                    help="patches per document per chunk")
    ap.add_argument("--resync-every", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    kw = dict(n_docs=args.docs, chunks=args.chunks,
              steps_per_chunk=args.steps, resync_every=args.resync_every,
              device=dev)
    if args.config == "5":
        run = run_stream_5(**kw)
        sizes = {"patches": run.stream.n_patches}
    else:
        run = run_stream(**kw)
        sizes = {"char_ops": run.stream.char_ops}
    print(json.dumps({
        "config": args.config, "docs": args.docs, "chunks": args.chunks,
        "steps_per_chunk": args.steps, "device_steps": run.stream.steps,
        "real_steps": run.stream.real_steps, **sizes,
        "resyncs": run.stats.resyncs,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "ok": run.ok}))
    return 0 if run.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
