"""Deterministic closed-loop load generator + convergence checker
(counterpart of ``text_crdt_rust_tpu/serve/loadgen.py``).

N documents x M agents: every agent holds a real oracle replica of its
document, edits it locally, gossips with its sibling agents, and ships
its history to the server as binary TXNS frames through a seeded
`net/faults.py` channel (drops / dups / reorders / truncations /
bit-flips). A seeded Zipf popularity skew concentrates traffic on hot
documents so the cold tail actually evicts. Local server-side edits mix
in with probability ``local_prob`` (they also *touch* evicted docs,
driving the restore path).

Ground truth: one always-resident **twin** oracle per doc consumes the
exact same txn set over a clean channel (plus the server's own edits,
observed via ``export_since``). The run converges iff, after the lossy
phase plus the server-driven REQUEST/re-delivery cycle, every document
is bit-identical to its twin (string AND portable state digest) and
every device lane is bit-identical to its host oracle, CLI-runnable:

    python -m text_crdt_rust_tpu_torch.serve.loadgen --docs 200 \\
        --agents 3 --ticks 60 --fault-rate 0.10 --seed 7

It runs on the card unless ``--device cpu`` is given. ``ServeLoadGen``
takes the caller's clock (``clock=``, e.g. ``time.perf_counter``; the
package reads none itself), and without one its report carries no walls
— so the CLI prints the logical report (``chip_smoke.py`` passes a clock).
``logical_report`` projects a report onto the fields that two same-seed
runs agree on, whatever their clock, pipeline depth or package.
"""
from __future__ import annotations

import argparse
import os
import random
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..common import RemoteTxn, txn_len
from ..config import ServeConfig
from ..models.oracle import ListCRDT
from ..models.sync import agent_watermarks, export_txns_since, state_digest
from ..net import codec, columnar
from ..net.faults import FaultSpec, FaultyChannel
from ..obs.trace import TRACE_SCHEMA_VERSION
from ..parallel.causal import CausalBuffer
from .admission import AdmissionError
from .server import DocServer

TXNS_PER_FRAME = 4
# Mux frames cap below the codec's 4096-txn limit: one frame is one
# loss unit on the fault channel — a dropped whole-window frame turns
# into a multi-doc backfill pull.
MUX_TXNS_PER_FRAME = 1024
# The Nagle-style push policy (columnar wire) lives in ServeConfig
# (``nagle_txns`` / ``nagle_rounds``, CLI ``--nagle-txns`` /
# ``--nagle-rounds``): a doc's outbox ships once it holds nagle_txns
# txns, or after nagle_rounds TICKS regardless (the flush check runs
# every tick — emission-to-frame batching dominates clean-remote op
# age, so the window is the serve loop's first-order latency lever).
# Pull chunking: a REQUEST want carries only a from-seq (the v1 control
# frame), so the owed range is the WHOLE history suffix even when the
# hole is one dropped frame. A faulty-phase pull ships a bounded chunk
# per round — the causal buffer's watermark walks forward and the next
# want narrows — instead of re-shipping the suffix every window. The
# clean final drain chunks too, at the admission queue's scale: an
# UNCHUNKED pull of a hot doc's long-stalled suffix (> max_queue_per_doc
# txns) is rejected queue-full as one all-or-nothing group — and
# re-offered identically every round, a zero-progress livelock at
# mid-size Nagle windows.  A bounded clean
# chunk is always admissible once the inter-round tick drains the
# queue, so the watermark advances every round and the want narrows.
PULL_CHUNK_TXNS = 48
PULL_CHUNK_TXNS_CLEAN = 128

# The typing workload's deterministic vocabulary (real-text shape so
# DEFLATE sees real-text statistics, not a uniform-random alphabet).
WORDS = ("the quick brown fox jumps over a lazy dog while some text "
         "gets typed into this doc one word at a time and then edited "
         "again with small corrections near the cursor").split()


class _DocWorld:
    """Generation-side state for one document: agent replicas, their
    fault channels, the global txn log (generation order == a causal
    order), and the clean twin."""

    def __init__(self, doc_id: str, agents: List[str], seed: int,
                 spec: FaultSpec):
        self.doc_id = doc_id
        self.agents = agents
        self.replicas: Dict[str, ListCRDT] = {}
        self.replica_ids: Dict[str, int] = {}
        self.marks: Dict[str, int] = {a: 0 for a in agents}
        self.applied: Dict[str, Set[Tuple[str, int]]] = {
            a: set() for a in agents}
        self.channels: Dict[str, FaultyChannel] = {}
        for i, a in enumerate(agents):
            doc = ListCRDT()
            self.replicas[a] = doc
            self.replica_ids[a] = doc.get_or_create_agent_id(a)
            self.channels[a] = FaultyChannel(
                spec=spec, seed=seed * 10007 + i)
        self.txns: List[RemoteTxn] = []   # generation order, deduped
        self.txn_keys: Set[Tuple[str, int]] = set()
        self.twin = ListCRDT()
        self.twin_buffer = CausalBuffer()
        self.server_mark = 0
        # Columnar wire: fresh txns accumulate here between windowed
        # flushes instead of shipping per event.  ``outbox_age`` counts
        # TICKS the outbox has waited (the Nagle-style policy: ship
        # when big enough OR old enough — tiny per-doc batches are
        # where column chains and DEFLATE can't win; the window knobs
        # live in ServeConfig.nagle_txns/nagle_rounds).
        self.outbox: List[RemoteTxn] = []
        self.outbox_age = 0
        # Typing workload: per-agent cursor into the agent's replica.
        self.cursor: Dict[str, int] = {a: 0 for a in agents}

    def record(self, txns: List[RemoteTxn]) -> List[RemoteTxn]:
        fresh = []
        for t in txns:
            key = (t.id.agent, t.id.seq)
            if key not in self.txn_keys:
                self.txn_keys.add(key)
                self.txns.append(t)
                fresh.append(t)
        return fresh

    def feed_twin(self, txns: List[RemoteTxn]) -> None:
        for t in self.twin_buffer.add_all(txns):
            self.twin.apply_remote_txn(t)

    def gossip(self, rng: random.Random, agent: str) -> None:
        """The agent merges a random prefix of the doc's foreign
        history (generation order is causal, so any prefix is safe)."""
        doc = self.replicas[agent]
        seen = self.applied[agent]
        upto = rng.randint(0, len(self.txns))
        for t in self.txns[:upto]:
            key = (t.id.agent, t.id.seq)
            if t.id.agent != agent and key not in seen:
                seen.add(key)
                doc.apply_remote_txn(t)

    def agent_edit(self, rng: random.Random, agent: str, edits: int,
                   workload: str = "scatter") -> List[RemoteTxn]:
        """A burst of local edits on the agent's replica; returns the
        NEW txns exported since the agent's last export mark.

        ``scatter`` (default) edits uniform-random positions; ``typing``
        keeps a per-agent cursor and mostly types forward word by word
        with occasional backspaces and cursor jumps — the
        real-editing-trace shape, which both the step fuser and the
        columnar wire's delta chains are built for. Every position comes from the agent's OWN replica,
        so traffic stays server-state-independent either way."""
        doc = self.replicas[agent]
        aid = self.replica_ids[agent]
        for _ in range(edits):
            n = len(doc)
            if workload == "typing":
                cur = min(self.cursor[agent], n)
                r = rng.random()
                if n == 0 or r < 0.75:
                    word = rng.choice(WORDS) + " "
                    doc.local_insert(aid, cur, word)
                    self.cursor[agent] = cur + len(word)
                elif r < 0.87 and cur > 0:
                    k = min(rng.randint(1, 4), cur)
                    doc.local_delete(aid, cur - k, k)
                    self.cursor[agent] = cur - k
                else:
                    self.cursor[agent] = rng.randint(0, n)
            elif n == 0 or rng.random() < 0.55:
                pos = rng.randint(0, n)
                doc.local_insert(aid, pos, "".join(
                    rng.choice("abcdefgh") for _ in range(rng.randint(1, 4))))
            else:
                pos = rng.randint(0, n - 1)
                doc.local_delete(aid, pos, min(rng.randint(1, 4), n - pos))
        out = export_txns_since(doc, self.marks[agent])
        self.marks[agent] = doc.get_next_order()
        return out


class ServeLoadGen:
    """Seeded closed loop against one ``DocServer`` (on ``device``, walls
    from ``clock``; see the module docstring)."""

    def __init__(self, *, docs: int = 200, agents_per_doc: int = 3,
                 ticks: int = 60, events_per_tick: int = 48,
                 zipf_alpha: float = 1.1, fault_rate: float = 0.10,
                 local_prob: float = 0.25, seed: int = 7,
                 cfg: Optional[ServeConfig] = None,
                 resync_every: int = 4, verbose: bool = False,
                 workload: str = "scatter", byzantine: float = 0.0,
                 flash_crowd: Optional[Tuple[int, int]] = None,
                 device=None,
                 clock: Optional[Callable[[], float]] = None):
        self.rng = random.Random(seed)
        self.cfg = cfg or ServeConfig()
        self.clock = clock
        self.server = DocServer(self.cfg, device=device, clock=clock)
        self.ticks = ticks
        self.events_per_tick = events_per_tick
        self.local_prob = local_prob
        self.resync_every = max(1, resync_every)
        self.verbose = verbose
        assert workload in ("scatter", "typing"), workload
        self.workload = workload
        # The replication protocol generation, from ServeConfig: "row" =
        # the v1 shape (per-event frames of <= 4 txns, each agent
        # re-shipping its merged export); "columnar" = the v2 shape
        # (deduplicated per-world outboxes flushed each resync window as
        # doc-multiplexed columnar frames on one connection, pull
        # re-delivery as columnar streams).
        self.wire = self.cfg.wire_format
        spec = FaultSpec.all(fault_rate)
        self.worlds: List[_DocWorld] = []
        for d in range(docs):
            doc_id = f"doc{d:04d}"
            names = [f"d{d:04d}.a{i}" for i in range(agents_per_doc)]
            self.worlds.append(_DocWorld(doc_id, names,
                                         seed * 131 + d, spec))
            self.server.admit_doc(doc_id)
        # The mux lane's own fault channel (one connection for the
        # whole window flush; drops cost a window, anti-entropy pulls
        # it back).
        self.mux_channel = FaultyChannel(spec=spec, seed=seed * 7919 + 1)
        # Zipf popularity over docs (rank 0 hottest).
        self.weights = [1.0 / (i + 1) ** zipf_alpha for i in range(docs)]
        # Byzantine agent class: rate of hostile
        # frames per tick relative to events_per_tick.  Every hostile
        # frame must be refused TYPED (or absorbed as a dup) — any
        # other exception escaping the submit surface is a panic, and
        # the seeded test treats it as a failure.
        self.byzantine = max(0.0, float(byzantine))
        self.byz_rng = random.Random(seed * 104729 + 13)
        self.byz_sent = 0
        self.byz_rejected = 0
        self.byz_absorbed = 0
        # Flash-crowd scenario: from tick T on,
        # the pick distribution collapses onto one hot doc — lane
        # overflow + residency thrash on a single key.
        self.flash_crowd = flash_crowd
        self.rejections = 0
        self.ops_offered = 0
        # Wire accounting: bytes handed to the transport (pre-fault,
        # the sender's cost) on the txn lane vs the control lane, and
        # the deduplicated item-ops they carried.
        self.wire_txn_bytes = 0
        self.wire_push_bytes = 0   # event/flush lane
        self.wire_pull_bytes = 0   # REQUEST-answer (backfill) lane
        self.wire_ctrl_bytes = 0
        self.ops_replicated = 0

    # -- traffic -------------------------------------------------------------

    def _ship(self, world: _DocWorld, agent: str,
              txns: List[RemoteTxn], faulty: bool = True,
              lane: str = "push") -> None:
        """Encode txns into ROW frames and deliver them to the server,
        optionally through the agent's fault channel. (The v1 lane
        only: all columnar traffic goes through ``_ship_mux``.)"""
        assert self.wire == "row", "columnar traffic ships via _ship_mux"
        if not txns:
            return
        frames = [codec.encode_txns(txns[i:i + TXNS_PER_FRAME])
                  for i in range(0, len(txns), TXNS_PER_FRAME)]
        nbytes = sum(len(f) for f in frames)
        self.wire_txn_bytes += nbytes
        if lane == "push":
            self.wire_push_bytes += nbytes
        else:
            self.wire_pull_bytes += nbytes
        if faulty:
            ch = world.channels[agent]
            for f in frames:
                ch.send(f)
            frames = ch.drain()
        for f in frames:
            try:
                self.server.submit_frame(world.doc_id, f)
            except AdmissionError:
                self.rejections += 1

    def _flush_mux(self, faulty: bool = True, final: bool = False) -> None:
        """Columnar wire: ship deduplicated outboxes as doc-multiplexed
        frames on one connection (each doc's batch agent-sorted — the
        causal buffer re-orders on parents, and sorted columns are what
        the delta chains predict well).

        Nagle-style policy per doc: flush when the outbox reached
        ``cfg.nagle_txns`` or waited ``cfg.nagle_rounds`` ticks (column
        chains and frame DEFLATE only pay on batches; the anti-entropy
        pull covers anything a deferral or a dropped frame delays).
        The check runs EVERY tick — the window itself, not the resync
        cadence, decides when a batch ships."""
        batches: List[Tuple[str, List[RemoteTxn]]] = []
        for world in self.worlds:
            if not world.outbox:
                continue
            world.outbox_age += 1
            if not (final or len(world.outbox) >= self.cfg.nagle_txns
                    or world.outbox_age >= self.cfg.nagle_rounds):
                continue
            batches.append((world.doc_id,
                            sorted(world.outbox,
                                   key=lambda t: (t.id.agent, t.id.seq))))
            world.outbox = []
            world.outbox_age = 0
        self._ship_mux(batches, faulty=faulty)

    def _ship_mux(self, batches: List[Tuple[str, List[RemoteTxn]]],
                  faulty: bool = True, lane: str = "push") -> None:
        flat: List[Tuple[str, RemoteTxn]] = [
            (doc_id, t) for doc_id, txns in batches for t in txns]
        if not flat:
            return
        frames: List[bytes] = []
        for i in range(0, len(flat), MUX_TXNS_PER_FRAME):
            frames.append(columnar.encode_mux(
                columnar.group_consecutive(flat[i:i + MUX_TXNS_PER_FRAME])))
        nbytes = sum(len(f) for f in frames)
        self.wire_txn_bytes += nbytes
        if lane == "push":
            self.wire_push_bytes += nbytes
        else:
            self.wire_pull_bytes += nbytes
        if faulty:
            for f in frames:
                self.mux_channel.send(f)
            frames = self.mux_channel.drain()
        for f in frames:
            try:
                self.rejections += len(self.server.submit_mux_frame(f))
            except AdmissionError:
                self.rejections += 1

    def _gossip_digests(self, faulty: bool) -> None:
        """Every agent advertises its replica's watermarks + portable
        state digest — the anti-entropy signal that lets the server see
        gaps whose every frame was dropped (a peer it has literally
        never heard from)."""
        for world in self.worlds:
            for agent in world.agents:
                replica = world.replicas[agent]
                frame = codec.encode_digest(agent_watermarks(replica),
                                            state_digest(replica))
                self.wire_ctrl_bytes += len(frame)
                if faulty:
                    ch = world.channels[agent]
                    ch.send(frame)
                    frames = ch.drain()
                else:
                    frames = [frame]
                for f in frames:
                    try:
                        self.server.submit_frame(world.doc_id, f)
                    except AdmissionError:
                        self.rejections += 1

    def _resync(self, faulty: bool) -> int:
        """Answer the server's owed REQUEST frames from the generation
        log; returns how many docs still had wants."""
        wanting = 0
        owed_batches: List[Tuple[str, List[RemoteTxn]]] = []
        for world in self.worlds:
            req = self.server.poll_request_frame(world.doc_id)
            if req is None:
                continue
            wanting += 1
            self.wire_ctrl_bytes += len(req)
            kind, wants, _ = codec.decode_frame(req)
            assert kind == codec.KIND_REQUEST
            owed = [t for t in world.txns
                    if t.id.agent in wants
                    and t.id.seq + txn_len(t) > wants[t.id.agent]]
            if self.wire == "columnar":
                # A want that names txns still sitting in the world's
                # outbox is the push deferral showing through the
                # digest gossip, not a loss — the scheduled flush
                # delivers them. Pulling them too would double-ship
                # every deferred window.
                deferred = {(t.id.agent, t.id.seq) for t in world.outbox}
                owed = [t for t in owed
                        if (t.id.agent, t.id.seq) not in deferred]
                owed = owed[:PULL_CHUNK_TXNS if faulty
                            else PULL_CHUNK_TXNS_CLEAN]
            if self.wire == "columnar":
                # The pull lane is a backfill: ship ALL docs' owed
                # ranges as one multiplexed columnar stream — per-doc
                # frames would hand the overhead right back.
                if owed:
                    owed_batches.append((world.doc_id, sorted(
                        owed, key=lambda t: (t.id.agent, t.id.seq))))
            else:
                # Deliver via the hottest agent's channel (any path
                # works; the server dedups) — clean in the final drain.
                self._ship(world, world.agents[0], owed, faulty=faulty,
                           lane="pull")
        self._ship_mux(owed_batches, faulty=faulty, lane="pull")
        return wanting

    def _ship_byzantine(self, tick_index: int) -> None:
        """The byzantine agent class: a seeded stream of hostile frames
        — garbage bytes, bit-flipped frames, truncations, replays of
        already-delivered history, unknown-doc and wrong-lane
        submissions.  The server contract under attack: every hostile
        frame is either refused with a TYPED ``AdmissionError`` (counted
        below) or absorbed as a no-op duplicate — nothing panics the
        tick loop, nothing corrupts convergence.  Runs off its own rng
        so enabling the attacker never shifts the legitimate traffic
        stream."""
        rng = self.byz_rng
        n = max(1, round(self.events_per_tick * self.byzantine))
        for _ in range(n):
            attack = rng.choice(("garbage", "bitflip", "truncate",
                                 "replay", "unknown-doc", "wrong-lane"))
            world = self.worlds[rng.randrange(len(self.worlds))]
            doc_id = world.doc_id
            data: Optional[bytes] = None
            if attack == "garbage":
                data = bytes(rng.randrange(256)
                             for _ in range(rng.randint(1, 40)))
            elif attack in ("bitflip", "truncate", "replay"):
                if not world.txns:
                    continue  # nothing delivered yet to mangle/replay
                upto = rng.randint(1, min(4, len(world.txns)))
                frame = bytearray(codec.encode_txns(world.txns[:upto]))
                if attack == "bitflip":
                    frame[rng.randrange(len(frame))] ^= \
                        1 << rng.randrange(8)
                elif attack == "truncate":
                    del frame[rng.randint(1, len(frame) - 1):]
                data = bytes(frame)
            elif attack == "unknown-doc":
                doc_id = f"byz-doc-{rng.randrange(1 << 16):04x}"
                data = codec.encode_txns(world.txns[:1]) \
                    if world.txns else b"\x00"
            else:  # wrong-lane: a mux frame on the per-doc lane
                if not world.txns:
                    continue
                data = columnar.encode_mux([(doc_id, world.txns[:1])])
            self.byz_sent += 1
            try:
                self.server.submit_frame(doc_id, data)
            except AdmissionError:
                self.byz_rejected += 1
            else:
                # Replays (and garbage that happened to parse as a
                # benign frame) land here: absorbed, state untouched.
                self.byz_absorbed += 1

    def _observe_server_edits(self) -> None:
        """Feed the twins whatever new history the server produced
        (its own local edits, interleaved with merges)."""
        for world in self.worlds:
            doc = self.server.doc_state(world.doc_id)
            if not doc.resident:
                continue
            nxt = doc.oracle.get_next_order()
            if nxt > world.server_mark:
                txns = self.server.export_since(world.doc_id,
                                                world.server_mark)
                world.server_mark = nxt
                world.feed_twin(txns)

    def run_tick(self, tick_index: int) -> Dict[str, float]:
        picks = self.rng.choices(range(len(self.worlds)),
                                 weights=self.weights,
                                 k=self.events_per_tick)
        if (self.flash_crowd is not None
                and tick_index >= self.flash_crowd[0]):
            # Flash crowd: 90% of this tick's events slam one doc.  The
            # remap consumes its own rng draws AFTER the base picks so
            # pre-flash ticks are byte-identical to the plain run.
            hot = self.flash_crowd[1] % len(self.worlds)
            picks = [hot if self.rng.random() < 0.90 else p
                     for p in picks]
        for d in picks:
            world = self.worlds[d]
            if self.rng.random() < self.local_prob:
                # A server-side edit; position bounded by the doc's
                # TWIN length — a server-state-independent source, so
                # one seed generates byte-identical traffic on every
                # lane backend and package (the bit-identity twin runs
                # depend on it; a position the server hasn't caught up
                # to yet is validity-checked at apply time and dropped,
                # deterministically). The edit still
                # *touches* evicted docs, driving the restore path.
                live = len(world.twin)
                pos = self.rng.randint(0, live)
                ins = "".join(self.rng.choice("xyzw")
                              for _ in range(self.rng.randint(1, 3)))
                try:
                    self.server.submit_local(world.doc_id, "server-editor",
                                             pos, 0, ins)
                    self.ops_offered += len(ins)
                except AdmissionError:
                    self.rejections += 1
            else:
                agent = self.rng.choice(world.agents)
                world.gossip(self.rng, agent)
                txns = world.agent_edit(self.rng, agent,
                                        self.rng.randint(1, 3),
                                        workload=self.workload)
                fresh = world.record(txns)
                # Per-op provenance: a span is EMITTED the
                # moment it exists — before the fault channel gets to
                # eat its frames — so the conservation audit covers
                # lost-and-repulled ops, not just delivered ones.
                self.server.flow.emit_txns(world.doc_id, fresh)
                world.feed_twin(fresh)
                ops = sum(txn_len(t) for t in fresh)
                self.ops_offered += ops
                self.ops_replicated += ops
                if self.wire == "columnar":
                    # v2 protocol: dedup into the world's outbox; the
                    # windowed mux flush ships it (re-shipping every
                    # agent's merged export per event is most of the v1
                    # byte bill).
                    world.outbox.extend(fresh)
                else:
                    self._ship(world, agent, txns, faulty=True)
        if self.byzantine > 0.0:
            self._ship_byzantine(tick_index)
        if self.wire == "columnar":
            # The Nagle window is checked every tick: the
            # flush cadence is the window's own, decoupled from the
            # resync/anti-entropy cadence below — at the old
            # once-per-resync-window cadence the effective emission
            # latency floor was resync_every ticks no matter how small
            # the window was set.
            self._flush_mux(faulty=True)
        if (tick_index + 1) % self.resync_every == 0:
            self._gossip_digests(faulty=True)
            self._resync(faulty=True)
        # Server-authored history reaches the twins in the final
        # observation pass, NOT per tick: per-tick observation is gated
        # on residency, which differs across lane backends — it would
        # leak backend state into the twin lengths that seed the next
        # tick's traffic (see run_tick's position source).
        return self.server.tick()

    # -- the full run --------------------------------------------------------

    def run(self) -> Dict[str, object]:
        self.start()
        self.run_ticks(0, self.ticks)
        return self.finalize()

    def _now(self) -> Optional[float]:
        return self.clock() if self.clock is not None else None

    def start(self) -> None:
        """Arm the run clock and accumulators.  ``run()`` calls this;
        a driver may call it once, then drive ``run_ticks`` in pieces."""
        self._t0 = self._now()
        self._applied = 0
        self._steps = 0

    def run_ticks(self, start: int, stop: int) -> None:
        """Drive ticks ``start..stop`` (half-open).  Resumable:
        generation state (worlds, rng, fault channels) lives here, so a
        driver may run the ticks in pieces."""
        for i in range(start, stop):
            stats = self.run_tick(i)
            self._applied += stats["ops_applied"]
            self._steps += stats["steps"]
            if self.verbose and (i + 1) % 10 == 0:
                rc = self.server.residency.resident_counts()
                print(f"tick {i + 1}/{self.ticks}: applied "
                      f"{self._applied} item-ops, {rc['docs_in_lane']} "
                      f"in-lane / {rc['docs_evicted']} evicted",
                      flush=True)

    def finalize(self) -> Dict[str, object]:
        """The run tail: flush the pipeline, drain the anti-entropy
        cycle clean, verify every doc against its twin, and assemble
        the report."""
        applied = self._applied
        # The timed loop is not done until its device work is: flush
        # the pipeline BEFORE the wall capture, so serial and pipelined
        # arms account identical work (a depth-D run would otherwise
        # push its last D-1 ticks' sync cost outside the loop wall).
        self.server.flush_pipeline()
        loop_wall = (None if self._t0 is None
                     else self._now() - self._t0)

        # Final drain: clean digests + re-delivery until the server owes
        # no REQUESTs and every queue is empty — the anti-entropy cycle
        # that recovers everything the fault channels mangled.
        drain_rounds = 0
        if self.wire == "columnar":
            self._flush_mux(faulty=False, final=True)
        self._gossip_digests(faulty=False)
        for drain_rounds in range(1, 64):
            wanting = self._resync(faulty=False)
            self.server.tick()
            busy = any(d.events for d in self.server.router.docs.values())
            if not wanting and not busy:
                break
        self.server.drain()
        self._observe_server_edits()

        converged, mismatches = self.verify()
        wall = None if self._t0 is None else self._now() - self._t0
        stats = self.server.stats()
        tick_sum = self.server.tick_summary()
        report = {
            "converged": converged,
            "mismatches": mismatches[:8],
            "docs": len(self.worlds),
            "item_ops_applied": int(applied),
            "device_ticks_wall_s": (None if loop_wall is None
                                    else round(loop_wall, 3)),
            "ops_per_sec": (round(applied / loop_wall, 1) if loop_wall
                            else None),
            "drain_rounds": drain_rounds,
            "wall_s": None if wall is None else round(wall, 3),
            "rejected_submissions": self.rejections,
            "byzantine": {
                "rate": self.byzantine,
                "sent": self.byz_sent,
                "rejected": self.byz_rejected,
                "absorbed": self.byz_absorbed,
            },
            "latency_us": self.server.latency_summary(),
            "tick_ms": tick_sum,
            "engine": self.cfg.engine,
            # Pipelined tick: effective depth, how much of the
            # device-sync demand the staged sync hid under host work,
            # and the residual stall (None without a clock).
            "pipeline": {
                "sanitize": self.cfg.sanitize_pipeline,
                "sanitize_checks": stats.get("sanitize_checks", 0),
                "ticks": tick_sum.get("pipeline_ticks", 1),
                "overlap_frac": tick_sum.get("pipeline_overlap_frac"),
                "stall_ms_total": tick_sum.get("pipeline_stall_ms_total"),
            },
            # Device-resident prefill: the flat backend's per-tick log-
            # prefill byte economy (the lanes backend reports the
            # defaults).
            "prefill": {
                # Default False: a backend fleet that exposes no
                # prefill surface (the lanes backend's tables are
                # device-resident already) moves no prefill bytes.
                "device_prefill": tick_sum.get("device_prefill", False),
                "bytes_per_tick": tick_sum.get(
                    "prefill_bytes_per_tick", 0.0),
                "bytes_full_per_tick": tick_sum.get(
                    "prefill_bytes_full_per_tick", 0.0),
                "bytes_cut_x": tick_sum.get("prefill_bytes_cut_x", 0.0),
                "scatter_len": tick_sum.get("prefill_scatter_len", 0),
                "scatter_compiles": tick_sum.get(
                    "prefill_scatter_compiles", 0),
            },
            # Tick trains: the flat backend's device-dispatch economy (the
            # lanes backend reports the defaults).
            "train": {
                "ticks": tick_sum.get("train_ticks", 1),
                "device_dispatches": tick_sum.get(
                    "device_dispatches", 0),
                "dispatches_per_tick": tick_sum.get(
                    "device_dispatches_per_tick", 0.0),
                "dispatch_cut_x": tick_sum.get("dispatch_cut_x", 1.0),
                "train_len": tick_sum.get("train_len", 1.0),
                "train_compiles": tick_sum.get("train_compiles", 0),
            },
            "wire": {
                "format": self.wire,
                "workload": self.workload,
                "nagle_txns": self.cfg.nagle_txns,
                "nagle_rounds": self.cfg.nagle_rounds,
                "txn_bytes": self.wire_txn_bytes,
                "push_bytes": self.wire_push_bytes,
                "pull_bytes": self.wire_pull_bytes,
                "ctrl_bytes": self.wire_ctrl_bytes,
                "ops_replicated": self.ops_replicated,
                "bytes_per_op": round(
                    self.wire_txn_bytes / max(1, self.ops_replicated), 3),
            },
            "ckpt": {
                "format": self.cfg.ckpt_format,
                "bytes_written": stats.get("ckpt_bytes_written", 0),
                "saves_full": stats.get("ckpt_saves_full", 0),
                "saves_delta": stats.get("ckpt_saves_delta", 0),
                "bytes_per_evict": stats.get("ckpt_bytes_per_evict_mean", 0),
                "bytes_per_evict_min": stats.get(
                    "ckpt_bytes_per_evict_min", 0),
                "bytes_per_evict_max": stats.get(
                    "ckpt_bytes_per_evict_max", 0),
            },
            # Observability block: everything below flows from the ONE
            # metrics registry + tracer the server owns.  Per-op
            # provenance: span census, conservation
            # audit over the sampled spans (end-of-run mode: every
            # span must be terminal — the drain above finished), and
            # op-age-at-apply distributions in logical ticks.
            "flow": self.server.flow_summary(expect_terminal=True),
            "obs": {
                "trace_enabled": self.cfg.trace,
                "trace_schema": TRACE_SCHEMA_VERSION,
                "trace_events": self.server.tracer.seq,
                "device_compiles": stats.get("device_compiles", 0),
                "bundles_written": stats.get("bundles_written", 0),
                "bundles_suppressed": stats.get("bundles_suppressed", 0),
                # The recorder's own written-file count (must agree
                # with the counter — asserted in test_obs_recorder).
                "bundle_count": len(self.server.recorder.bundle_paths),
                "bundles": list(self.server.recorder.bundle_paths),
            },
            "server": stats,
        }
        # Finalize obs: stop a still-open profiler capture, flush+close
        # the trace stream (the report above already read everything).
        self.server.close_obs()
        return report

    def verify(self) -> Tuple[bool, List[str]]:
        """Every doc bit-identical to its twin; every lane bit-identical
        to its oracle. Returns (ok, mismatch descriptions)."""
        bad: List[str] = []
        for world in self.worlds:
            # Docs evicted at run end: restore, then feed the twin any
            # server-authored history it hasn't observed yet (the doc
            # may have been checkpointed right after its last edit).
            self.server.ensure_resident(world.doc_id)
        self._observe_server_edits()
        for world in self.worlds:
            # The twin must itself have fully converged (a generation
            # bug otherwise — every generated txn was fed cleanly).
            if world.twin_buffer.pending:
                bad.append(f"{world.doc_id}: twin buffer still holds "
                           f"{world.twin_buffer.pending} txns")
                continue
            got = self.server.doc_string(world.doc_id)
            want = world.twin.to_string()
            if got != want:
                bundle = self._postmortem(world, "content diverged")
                bad.append(f"{world.doc_id}: content diverged "
                           f"({len(got)} vs {len(want)} chars; "
                           f"post-mortem: {bundle})")
                continue
            doc = self.server.doc_state(world.doc_id)
            if state_digest(doc.oracle) != state_digest(world.twin):
                bundle = self._postmortem(world, "state digest diverged")
                bad.append(f"{world.doc_id}: state digest diverged "
                           f"(post-mortem: {bundle})")
                continue
            if not self.server.verify_doc(world.doc_id):
                # verify_lane already dumped its own divergence bundle
                # (or the run's one divergence bundle was spent earlier
                # — point at that one, never at an unrelated class).
                bundle = next(
                    (p for p in reversed(self.server.recorder.bundle_paths)
                     if "divergence" in os.path.basename(p)), None)
                bad.append(f"{world.doc_id}: device lane != host oracle"
                           + (f" (post-mortem: {bundle})" if bundle else ""))
        return not bad, bad

    def _postmortem(self, world: _DocWorld, detail: str):
        """Dump the twin-divergence flight-recorder bundle: the
        first-divergence walk against the twin names the exact
        logical tick, doc, and apply event where the histories parted."""
        doc = self.server.doc_state(world.doc_id)
        path = self.server.recorder.on_divergence(
            world.doc_id, doc.oracle, world.twin,
            detail=f"twin check: {detail}")
        # Budget already spent on an earlier divergence this run: point
        # at the bundle that WAS written instead of printing None.
        return path or next(
            (p for p in self.server.recorder.bundle_paths
             if "divergence" in p), None)


#: Report keys that hold host-clock readings or the pipeline mode; the
#: rest of a report is a pure function of the seeded workload.
_WALL_REPORT_KEYS = ("device_ticks_wall_s", "ops_per_sec", "wall_s",
                     "latency_us", "pipeline", "mismatches")


def _wall_key(key: str) -> bool:
    return ("wall" in key or key.startswith(("latency_us_", "pipeline_",
                                             "tick_ms_pipeline_"))
            or key in ("p50", "p99", "samples", "tick_ms_p50",
                       "tick_ms_p99", "tick_ms_samples", "sanitize_checks"))


def logical_report(report: Dict[str, object]) -> Dict[str, object]:
    """The logical projection of a ``ServeLoadGen`` report: every field
    that two same-seed runs must agree on, whatever their clock, pipeline
    depth or package (the JAX package's report projects the same way).
    Drops the wall readings, the pipeline mode and the post-mortem
    bundle paths."""
    out = {k: v for k, v in report.items()
           if k not in _WALL_REPORT_KEYS + ("tick_ms", "obs", "server")}
    out["tick_ms"] = {k: v for k, v in report["tick_ms"].items()
                      if not _wall_key(k)}
    out["obs"] = {k: v for k, v in report["obs"].items() if k != "bundles"}
    out["server"] = {k: v for k, v in report["server"].items()
                     if not _wall_key(k)}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--docs", type=int, default=200)
    ap.add_argument("--agents", type=int, default=3)
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--events-per-tick", type=int, default=48)
    ap.add_argument("--zipf", type=float, default=1.1)
    ap.add_argument("--fault-rate", type=float, default=0.10)
    ap.add_argument("--local-prob", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--engine", default="flat",
                    help="registry engine backing the lane batches "
                         "(any engine with a serve backend: flat, "
                         "rle-lanes-mixed)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the card (default) or on the CPU with "
                         "the kernels' plain versions")
    d = ServeConfig()
    ap.add_argument("--wire", default=d.wire_format,
                    choices=("row", "columnar"),
                    help="replication protocol generation: per-event "
                         "row frames (v1) or windowed doc-multiplexed "
                         "columnar frames (v2)")
    ap.add_argument("--ckpt", default=d.ckpt_format,
                    choices=("full", "delta"),
                    help="eviction checkpoints: full O(doc) snapshots "
                         "or CRC-chained O(new ops) deltas")
    ap.add_argument("--workload", default="scatter",
                    choices=("scatter", "typing"),
                    help="agent edit shape: uniform-random positions "
                         "or cursor-based typing runs")
    ap.add_argument("--pipeline-ticks", type=int, default=d.pipeline_ticks,
                    help="host/device tick pipelining depth: 2 = "
                         "double-buffered (stage the next tick's host "
                         "work while the device step is in flight), "
                         "1 = the serial loop; logical streams are "
                         "byte-identical at any depth")
    ap.add_argument("--train-ticks", type=int, default=d.train_ticks,
                    help="device tick-train length (the flat backend's; "
                         "the lanes backend clamps it to 1)")
    ap.add_argument("--host-prefill", action="store_true",
                    help="the flat backend's host log prefill (ignored "
                         "by the lanes backend)")
    ap.add_argument("--sanitize-pipeline", action="store_true",
                    help="pipeline aliasing sanitizer: CRC-fingerprint "
                         "each in-flight tick's op tensors at dispatch "
                         "and re-check at the staged sync — a host "
                         "write racing the device step fails naming "
                         "tick/shard/array")
    ap.add_argument("--nagle-txns", type=int, default=d.nagle_txns,
                    help="columnar-wire Nagle window: flush a doc's "
                         "outbox once it holds this many txns")
    ap.add_argument("--nagle-rounds", type=int, default=d.nagle_rounds,
                    help="...or once it has waited this many ticks "
                         "(smaller = lower op age, more frame overhead)")
    ap.add_argument("--lmax", type=int, default=d.lmax,
                    help="insert-chunk width of compiled serve steps "
                         "(the typing-workload fusion lever: larger "
                         "lmax folds longer typing runs per step)")
    ap.add_argument("--no-trace", action="store_true",
                    help="disable the obs/ event tracer")
    ap.add_argument("--trace-path", default=None,
                    help="stream trace events to this JSONL file")
    ap.add_argument("--trace-rotate-bytes", type=int, default=None,
                    help="size-cap per trace segment; the stream rolls "
                         "to <path>.1, <path>.2, ... at the cap")
    ap.add_argument("--flow-sample-mod", type=int,
                    default=d.flow_sample_mod,
                    help="per-op provenance sampling: agents with "
                         "crc32(name) %% mod == 0 get end-to-end "
                         "flow.* span events (1 = every span, the "
                         "conservation-audit mode; 0 = off)")
    ap.add_argument("--byzantine", type=float, default=0.0,
                    metavar="RATE",
                    help="byzantine agent class: ship this many "
                         "malformed/corrupt/replayed frames per tick "
                         "(fraction of events-per-tick); every one "
                         "must be refused typed or absorbed as a dup, "
                         "never panic the tick loop")
    ap.add_argument("--flash-crowd", default=None, metavar="TICK:DOC",
                    help="from tick TICK on, remap 90%% of each tick's "
                         "events onto doc index DOC — lane overflow + "
                         "residency thrash on one hot doc")
    ap.add_argument("--profile-dir", default=None,
                    help="opt-in torch.profiler capture directory "
                         "(ticks 1..profile_ticks, written as trace.json)")
    ap.add_argument("--journal-dir", default=None,
                    help="write-ahead op journal directory: every "
                         "admitted input is logged before it can mutate "
                         "state; a crashed server recovers by "
                         "re-executing the log")
    ap.add_argument("--journal-fsync-ticks", type=int,
                    default=d.journal_fsync_ticks,
                    help="fsync the journal every N logical ticks "
                         "(1 = every tick boundary)")
    ap.add_argument("--crash-at", default=None, metavar="PHASE:TICK",
                    help="crash-injection harness (serve/chaos): kill "
                         "the server at the named phase of loadgen "
                         "tick TICK, recover from the journal, resume, "
                         "and compare logical streams against an "
                         "uncrashed same-seed twin. Phases: post-admit, "
                         "post-dispatch, mid-ckpt, mid-journal")
    ap.add_argument("--verbose", action="store_true")
    a = ap.parse_args(argv)

    import json

    flash_crowd = None
    if a.flash_crowd is not None:
        tick_s, _, doc_s = a.flash_crowd.partition(":")
        flash_crowd = (int(tick_s), int(doc_s))

    if a.crash_at is not None:
        # The chaos harness owns the whole run (victim, recovery, resume,
        # twin); it allocates its own workdir.
        from .chaos import PHASES, run_crash_scenario
        phase, _, tick_s = a.crash_at.partition(":")
        if phase not in PHASES or not tick_s:
            raise SystemExit(f"--crash-at wants PHASE:TICK with PHASE in "
                             f"{PHASES}, got {a.crash_at!r}")
        cell = run_crash_scenario(
            phase, int(tick_s), ticks=a.ticks, docs=a.docs,
            agents_per_doc=a.agents, events_per_tick=a.events_per_tick,
            seed=a.seed, fault_rate=a.fault_rate, num_shards=a.shards,
            lanes_per_shard=a.lanes, ckpt_format=a.ckpt,
            fsync_ticks=a.journal_fsync_ticks, byzantine=a.byzantine,
            flash_crowd=flash_crowd, train_ticks=a.train_ticks,
            device=a.device)
        cell.pop("report")
        print(json.dumps(cell, indent=1, default=str))
        ok = (cell["identical"] and cell["converged"]
              and cell["at_recovery_audit"]["audit_ok"]
              and cell["final_audit"]["audit_ok"])
        raise SystemExit(0 if ok else 1)

    cfg = ServeConfig(engine=a.engine, num_shards=a.shards,
                      lanes_per_shard=a.lanes,
                      wire_format=a.wire, ckpt_format=a.ckpt,
                      pipeline_ticks=a.pipeline_ticks,
                      train_ticks=a.train_ticks,
                      device_prefill=not a.host_prefill,
                      sanitize_pipeline=a.sanitize_pipeline,
                      nagle_txns=a.nagle_txns,
                      nagle_rounds=a.nagle_rounds, lmax=a.lmax,
                      trace=not a.no_trace, trace_path=a.trace_path,
                      trace_rotate_bytes=a.trace_rotate_bytes,
                      flow_sample_mod=a.flow_sample_mod,
                      profile_dir=a.profile_dir,
                      journal_dir=a.journal_dir,
                      journal_fsync_ticks=a.journal_fsync_ticks)
    gen = ServeLoadGen(docs=a.docs, agents_per_doc=a.agents, ticks=a.ticks,
                       events_per_tick=a.events_per_tick, zipf_alpha=a.zipf,
                       fault_rate=a.fault_rate, local_prob=a.local_prob,
                       seed=a.seed, cfg=cfg, verbose=a.verbose,
                       workload=a.workload, byzantine=a.byzantine,
                       flash_crowd=flash_crowd, device=a.device)
    report = gen.run()
    print(json.dumps(report, indent=1, default=str))
    if not report["converged"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
