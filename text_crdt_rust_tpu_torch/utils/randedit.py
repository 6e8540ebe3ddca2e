"""Seeded synthetic edit streams for tests and the chip smoke run (the
port's counterpart of ``text_crdt_rust_tpu/utils/randedit.py``).

``random_patches`` is the `make_random_change` analog (`doc.rs:544-569`):
each step inserts 1..max_ins chars at a random position or deletes
1..max_del chars, tracked against a plain string. Given a
``random.Random`` it draws exactly as the JAX package's does, so one
seed gives both packages the same patches; given a numpy ``Generator``
it draws the port's own stream (the earlier slices' test inputs).
``prepend_bursts`` adds the backwards-contiguous insert bursts (the
kevin prepend shape) that W-row step fusion compiles into fused steps.

``continue_patches`` and ``PeerSynth`` generate the config-5r streams:
per-document random edits continued chunk after chunk, turned into one
peer's remote txns (counterparts of ``bench.py``'s ``_continue_patches``
and ``_PeerSynth``, drawing from ``random.Random`` exactly as they do).

``make_storm`` builds the config-4 concurrent-insert storm (counterpart
of ``text_crdt_rust_tpu/utils/randedit.py:50-118``). It draws from
``random.Random(seed)`` exactly as the JAX package's does, so one seed
gives both packages the same txns.
"""
from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np

from ..common import RemoteDel, RemoteId, RemoteIns, RemoteTxn
from ..models.oracle import ListCRDT
from ..models.sync import export_txns_since
from .testdata import TestPatch

ALPHABET = "abcdefghijklmnopqrstuvwxyz ABCDEFGHIJKLMNOPQRSTUVWXYZ.,\n"


def _text(rng: np.random.Generator, n: int) -> str:
    return "".join(ALPHABET[i] for i in rng.integers(0, len(ALPHABET), n))


def random_patches(
    rng,
    steps: int,
    ins_prob: float = 0.6,
    max_ins: int = 5,
    max_del: int = 4,
) -> Tuple[List[TestPatch], str]:
    """Seeded random edit stream, tracked against a plain string. ``rng``
    is a ``random.Random`` (the JAX package's draw) or a numpy
    ``Generator`` (the port's own draw)."""
    if isinstance(rng, random.Random):
        def below(n):       # uniform in [0, n)
            return rng.randint(0, n - 1)

        def text(n):
            return "".join(rng.choice(ALPHABET) for _ in range(n))
    else:
        def below(n):
            return int(rng.integers(0, n))

        def text(n):
            return _text(rng, n)
    content = ""
    patches = []
    for _ in range(steps):
        if not content or rng.random() < ins_prob:
            pos = below(len(content) + 1)
            ins = text(below(max_ins) + 1)
            patches.append(TestPatch(pos, 0, ins))
            content = content[:pos] + ins + content[pos:]
        else:
            pos = below(len(content))
            span = min(below(max_del) + 1, len(content) - pos)
            patches.append(TestPatch(pos, span, ""))
            content = content[:pos] + content[pos + span:]
    return patches, content


def prepend_bursts(
    rng: np.random.Generator,
    bursts: int,
    max_burst: int = 12,
    max_run: int = 3,
    del_prob: float = 0.3,
) -> Tuple[List[TestPatch], str]:
    """Seeded stream of backwards insert bursts: each burst types
    2..max_burst equal-length runs at ONE position (each landing before
    the previous), separated now and then by a random delete."""
    content = ""
    patches = []
    for _ in range(bursts):
        if content and rng.random() < del_prob:
            pos = int(rng.integers(0, len(content)))
            span = min(int(rng.integers(1, 5)), len(content) - pos)
            patches.append(TestPatch(pos, span, ""))
            content = content[:pos] + content[pos + span:]
        pos = int(rng.integers(0, len(content) + 1))
        run = int(rng.integers(1, max_run + 1))
        for _ in range(int(rng.integers(2, max_burst + 1))):
            ins = _text(rng, run)
            patches.append(TestPatch(pos, 0, ins))
            content = content[:pos] + ins + content[pos:]
    return patches, content


def make_storm(n_peers: int, rounds: int, run_len: int, seed: int = 0,
               del_prob: float = 0.0):
    """(txns, oracle) for the concurrent-insert storm (config 4).

    Each peer types ``run_len`` chars at position 0 of its own replica
    every round; the exported txns are interleaved round-robin (a valid
    causal order — peers only depend on themselves) and applied to a
    receiving oracle for ground truth.

    With ``del_prob`` > 0 a peer's round is, with that probability, a
    DELETE instead: the peer first merges every txn emitted in earlier
    rounds (so it can see — and delete — other peers' chars), then
    deletes a random span.  Two peers deleting overlapping spans in the
    same round produce concurrent double deletes
    (`double_delete.rs:6-9`); the round-robin order stays causally
    valid because merges only cover strictly earlier rounds.
    ``del_prob=0`` draws no extra randomness, so existing seeded
    streams are unchanged.
    """
    rng = random.Random(seed)
    peers = []
    for p in range(n_peers):
        doc = ListCRDT()
        agent = doc.get_or_create_agent_id(f"peer-{p:03d}")
        peers.append((doc, agent))

    per_round: List[List] = []
    marks = [0] * n_peers
    merged_upto = [0] * n_peers  # txns (flat index) each peer has merged
    flat: List = []
    for _ in range(rounds):
        round_txns = []
        prior = len(flat)  # merges may only cover earlier rounds
        for p, (doc, agent) in enumerate(peers):
            is_del = bool(del_prob) and rng.random() < del_prob
            if is_del:
                me = f"peer-{p:03d}"
                for t in flat[merged_upto[p]:prior]:
                    if t.id.agent != me:  # own history is already local
                        doc.apply_remote_txn(t)
                merged_upto[p] = prior
                # Export must cover ONLY the op below, not the merged
                # history (those orders belong to other agents).
                marks[p] = doc.get_next_order()
                n = len(doc)
                if n == 0:
                    is_del = False
                else:
                    pos = rng.randint(0, n - 1)
                    span = min(rng.randint(1, run_len), n - pos)
                    doc.local_delete(agent, pos, span)
            if not is_del:
                text = "".join(rng.choice(ALPHABET)
                               for _ in range(run_len))
                doc.local_insert(agent, 0, text)
            txns = export_txns_since(doc, marks[p])
            marks[p] = doc.get_next_order()
            round_txns.extend(txns)
        per_round.append(round_txns)
        flat.extend(round_txns)

    txns = [t for rnd in per_round for t in rnd]
    receiver = ListCRDT()
    for t in txns:
        receiver.apply_remote_txn(t)
    return txns, receiver


def make_two_peer_merge(seed: int, rounds: int = 6):
    """(txns, oracle) for a random two-peer session with cross-merges:
    each round ``amy`` and ``bob`` make 1..4 random edits on their own
    replicas, export them, then merge everything the other exported so
    far. Windows of the receiving document then hold descendants, split
    tails and mid-run cursors: the shapes that send the fast YATA scan
    to its serial fallback."""
    rng = random.Random(seed)
    docs = {name: ListCRDT() for name in ("amy", "bob")}
    agents = {name: doc.get_or_create_agent_id(name)
              for name, doc in docs.items()}
    marks = {name: 0 for name in docs}
    applied = {name: set() for name in docs}
    flat: List = []

    def edit(doc, agent):
        n = len(doc)
        if n == 0 or rng.random() < 0.6:
            pos = rng.randint(0, n)
            doc.local_insert(agent, pos, "".join(
                rng.choice("abcdef") for _ in range(rng.randint(1, 3))))
        else:
            pos = rng.randint(0, n - 1)
            doc.local_delete(agent, pos, min(rng.randint(1, 3), n - pos))

    for _ in range(rounds):
        for name, doc in docs.items():
            for _ in range(rng.randint(1, 4)):
                edit(doc, agents[name])
            flat.extend(export_txns_since(doc, marks[name]))
        for name, doc in docs.items():
            for t in flat:
                key = (t.id.agent, t.id.seq)
                if t.id.agent != name and key not in applied[name]:
                    applied[name].add(key)
                    doc.apply_remote_txn(t)
        for name, doc in docs.items():
            marks[name] = doc.get_next_order()
    receiver = ListCRDT()
    for t in flat:
        receiver.apply_remote_txn(t)
    return flat, receiver


def continue_patches(rng: random.Random, content: str, steps: int,
                     ins_prob: float) -> Tuple[List[TestPatch], str]:
    """``steps`` random edits continued from ``content`` (inserts of 1..4
    chars of "abcdefgh ", deletes of 1..4 chars); returns the patches and
    the text after them."""
    patches = []
    for _ in range(steps):
        if not content or rng.random() < ins_prob:
            pos = rng.randint(0, len(content))
            ins = "".join(rng.choice("abcdefgh ")
                          for _ in range(rng.randint(1, 4)))
            patches.append(TestPatch(pos, 0, ins))
            content = content[:pos] + ins + content[pos:]
        else:
            pos = rng.randint(0, len(content) - 1)
            span = min(rng.randint(1, 4), len(content) - pos)
            patches.append(TestPatch(pos, span, ""))
            content = content[:pos] + content[pos + span:]
    return patches, content


class PeerSynth:
    """A single-author peer that turns local patches into a valid remote
    txn stream (ids exist, seqs dense, delete targets split per
    seq-contiguous run) without replaying an oracle document. For one
    author, order == seq, and origins are the neighbouring LIVE ids: the
    tombstones between them only move the receiver's integrate cursor
    across invisible chars, so the receiver's text equals the string
    simulation."""

    def __init__(self, agent: str):
        self.agent = agent
        self.ids: list = []   # live char ids (seqs) in doc order
        self.seq = 0

    def _rid(self, seq):
        if seq is None:
            return RemoteId("ROOT", 0xFFFFFFFF)
        return RemoteId(self.agent, seq)

    def apply(self, patches) -> List[RemoteTxn]:
        """The txns of one patch chunk (one txn per patch)."""
        out = []
        for p in patches:
            ops = []
            seq0 = self.seq
            if p.del_len:
                victims = self.ids[p.pos: p.pos + p.del_len]
                del self.ids[p.pos: p.pos + p.del_len]
                run_start, run_len = victims[0], 1
                for v in victims[1:]:
                    if v == run_start + run_len:
                        run_len += 1
                    else:
                        ops.append(RemoteDel(self._rid(run_start), run_len))
                        run_start, run_len = v, 1
                ops.append(RemoteDel(self._rid(run_start), run_len))
                self.seq += p.del_len
            if p.ins_content:
                il = len(p.ins_content)
                left = self.ids[p.pos - 1] if p.pos > 0 else None
                right = self.ids[p.pos] if p.pos < len(self.ids) else None
                ops.append(RemoteIns(self._rid(left), self._rid(right),
                                     p.ins_content))
                self.ids[p.pos:p.pos] = range(self.seq, self.seq + il)
                self.seq += il
            out.append(RemoteTxn(id=self._rid(seq0), parents=[], ops=ops))
        return out
