"""Doc-shard routing: wire frames and local edits -> per-doc causal queues
(counterpart of ``text_crdt_rust_tpu/serve/router.py``), with the
write-ahead journal's admission-edge records.

The router owns the ``doc_id -> (shard, lane)`` table for the server's
B-lane device batches and the per-document host state behind it. One
``DocState`` per admitted document:

- a host **oracle** (`models.oracle.ListCRDT`) — the source of truth the
  device lanes mirror, and what eviction serializes (``None`` while the
  doc is evicted to its checkpoint);
- the op **compiler state** (`ops.batch.AgentTable` + ``OrderAssigner``)
  kept aligned with the oracle so tick-time compilation resumes
  mid-history (rebuilt via ``OrderAssigner.from_oracle`` on restore);
- a bounded ``parallel.causal.CausalBuffer`` fronting all remote
  traffic, so the server inherits the causal layer's gap/duplicate/
  out-of-order handling — frames from a lossy network release in causal
  order or wait, and ``missing()`` feeds the REQUEST frames the server
  emits to pull lost ranges;
- a FIFO **event queue** of causally-ready work (released remote txns +
  local edits) the batcher drains at tick time. FIFO per doc preserves
  the release order, so every apply is causally valid.

Frames arrive as bytes and are decoded through ``net/codec.py``; any
``CodecError`` becomes a counted, typed admission refusal — corrupt
input can never crash the serving loop (`net/faults.py` is the test
model). The doc id itself is connection metadata (the wire frame format
is doc-agnostic), so the submit surface is ``(doc_id, frame_bytes)``.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..common import RemoteIns, RemoteTxn, txn_len
from ..models.oracle import ListCRDT
from ..models.sync import (
    agent_watermarks,
    export_txns_for_wants,
    export_txns_since,
    state_digest,
)
from ..net import codec
from ..net.codec import CodecError
from ..ops import batch as B
from ..parallel.causal import CausalBuffer
from ..utils.metrics import Counters
from .admission import AdmissionControl, AdmissionError

# Event kinds in a doc's FIFO queue.
EV_TXN = "txn"      # payload: a causally-ready RemoteTxn
EV_LOCAL = "local"  # payload: (agent_name, pos, del_len, ins_content)


class Event:
    """One unit of causally-ready work. ``t_submit`` is the ADMISSION
    time on the server's clock (callers pass the stamp recorded when the
    txn entered the server, so a txn's causal-buffer wait — the
    fault-induced tail the latency metric exists to expose — is inside
    admission->applied); None when the server runs without a clock.

    ``lk`` is the flow-provenance ordinal of a sampled LOCAL edit
    (obs/flow: the span has no ``(agent, seq)`` until the oracle
    applies it); ``span`` is filled by the batcher at apply time with
    the realized ``(agent, seq, n)`` so the tick can stamp the span's
    terminal ``flow.apply`` after the lane-capacity probe decides
    device vs host.

    ``ordinal`` is a LOCAL edit's per-doc durability ordinal: assigned
    densely at admission, advanced into ``DocState.local_applied`` when
    the batcher processes the event (the checkpointed audit stamp)."""

    __slots__ = ("kind", "payload", "items", "t_submit", "tick_submit",
                 "lk", "span", "ordinal")

    def __init__(self, kind: str, payload, items: int, tick: int,
                 t_submit: Optional[float] = None,
                 lk: Optional[int] = None,
                 ordinal: Optional[int] = None):
        self.kind = kind
        self.payload = payload
        self.items = items
        self.t_submit = t_submit
        self.tick_submit = tick
        self.lk = lk
        self.span = None
        self.ordinal = ordinal


class DocState:
    """Everything the server holds for one document."""

    def __init__(self, doc_id: str, shard: int,
                 max_pending: Optional[int] = None):
        self.doc_id = doc_id
        self.shard = shard
        self.lane: Optional[int] = None
        self.oracle: Optional[ListCRDT] = ListCRDT()
        self.table: Optional[B.AgentTable] = B.AgentTable()
        self.assigner: Optional[B.OrderAssigner] = B.OrderAssigner(self.table)
        self.buffer = CausalBuffer(max_pending=max_pending)
        self.events: Deque[Event] = deque()
        self.evicted = False
        self.ckpt_path: Optional[str] = None
        # (agent, seq) -> admission clock stamp for txns still in the
        # causal buffer, so their eventual Event carries the TRUE
        # admission time (first delivery wins; trims look up the nearest
        # covering stamp). Pruned against the buffer watermark; empty
        # when the server runs without a clock.
        self.submit_stamps: Dict[Tuple[str, int], float] = {}
        # Latest per-agent watermarks any peer DIGEST advertised: the
        # gossip that reveals gaps the causal buffer cannot see (every
        # frame from an agent dropped), exactly as in `net/session.py`.
        self.peer_marks: Dict[str, int] = {}
        # High-water of the ORACLE's own per-agent watermarks, kept
        # fresh while resident and surviving eviction (the checkpoint
        # holds that history): REQUEST emission reads these so an
        # evicted doc never re-requests ranges it already persisted —
        # and so the owed-wants computation is independent of residency
        # timing (the loadgen's cross-backend determinism relies on it).
        self.known_marks: Dict[str, int] = {}
        self.degraded = False          # lane overflow: host-only forever
        self.degrade_reason = ""
        self.last_touch_tick = 0
        self.divergence_detected = False
        # Local-edit durability watermarks: ``local_seen`` is the next
        # ordinal to assign at submit; ``local_applied`` counts ordinals
        # the batcher has PROCESSED (applied or validity-dropped) and
        # rides checkpoint extra meta as an audit stamp.
        self.local_seen = 0
        self.local_applied = 0

    def absorb_oracle_marks(self) -> None:
        """Fold the resident oracle's per-agent watermarks into
        ``known_marks`` (max-merge).  Called wherever the oracle's
        history extent must survive the oracle's absence — REQUEST
        emission while resident, and the eviction snapshot."""
        if self.oracle is None:
            return
        for agent, wm in agent_watermarks(self.oracle).items():
            if wm > self.known_marks.get(agent, 0):
                self.known_marks[agent] = wm

    @property
    def resident(self) -> bool:
        """Oracle in memory (lane-backed or host-only)."""
        return self.oracle is not None

    @property
    def in_lane(self) -> bool:
        return self.lane is not None

    def pending(self) -> int:
        return len(self.events) + self.buffer.pending


class ShardRouter:
    """doc_id -> (shard, lane) table + the frame/edit submit surface.

    Shard assignment is least-loaded-at-admit and stable for the doc's
    lifetime (a doc's lane may come and go with residency, its shard
    never does — evicting to a different shard would orphan its device
    state). Lane assignment belongs to ``serve/residency.py``.
    """

    def __init__(self, num_shards: int, *, admission: AdmissionControl,
                 counters: Optional[Counters] = None,
                 buffer_max_pending: Optional[int] = 512,
                 wire_format: str = "row", tracer=None, flow=None,
                 clock: Optional[Callable[[], float]] = None):
        assert num_shards >= 1
        self.num_shards = num_shards
        # The caller's wall clock (seconds) for admission stamps; None =
        # no latency stamps (the logical stream does not depend on it).
        self.clock = clock
        self.journal = None   # serve/journal.Journal (set by DocServer;
        #                       None = durability off)
        self.admission = admission
        self.counters = counters if counters is not None else Counters()
        self.tracer = tracer
        self.flow = flow  # obs/flow.FlowTracker (None = provenance off)
        self.recorder = None  # set by DocServer after construction
        self.buffer_max_pending = buffer_max_pending
        # TXNS frames the router EMITS (serving REQUEST pulls); decode
        # always negotiates on the version byte, so what peers send is
        # their choice. The columnar wire amortizes per-frame overhead
        # across much bigger batches.
        self.wire_format = wire_format
        self._encode_txns = codec.txns_encoder(wire_format)
        self._txns_per_frame = 8 if wire_format == "row" else 512
        self.docs: Dict[str, DocState] = {}
        self._shard_docs = [0] * num_shards
        self._tick = 0

    # -- doc lifecycle surface (driven by the server facade) ----------------

    def set_tick(self, tick: int) -> None:
        self._tick = tick

    def admit_doc(self, doc_id: str) -> DocState:
        """Register a new empty document; idempotent on the same id."""
        doc = self.docs.get(doc_id)
        if doc is not None:
            return doc
        shard = min(range(self.num_shards), key=lambda s: self._shard_docs[s])
        doc = DocState(doc_id, shard, max_pending=self.buffer_max_pending)
        doc.last_touch_tick = self._tick
        if self.flow is not None and self.flow.enabled:
            # A pressure-evicted buffer txn leaves the process but not
            # the ledger: stamp the drop so the span's location stays
            # named until redelivery brings it back.
            doc.buffer.on_drop = (
                lambda txn, d=doc_id: self.flow.buffered(d, txn, "drop"))
        self.docs[doc_id] = doc
        self._shard_docs[shard] += 1
        self.counters.incr("docs_admitted")
        if self.journal is not None:
            # Admission ORDER is durable state: replaying admits in
            # sequence reproduces both the least-loaded shard choice
            # and the docs-dict iteration order the drain loop walks.
            self.journal.admit(shard, doc_id)
        return doc

    def doc(self, doc_id: str) -> DocState:
        doc = self.docs.get(doc_id)
        if doc is None:
            raise self.admission.reject_unknown_doc(doc_id)
        return doc

    def shard_lane(self, doc_id: str) -> Tuple[int, Optional[int]]:
        doc = self.doc(doc_id)
        return doc.shard, doc.lane

    # -- submit surface -----------------------------------------------------

    def _enqueue(self, doc: DocState, event: Event) -> None:
        doc.events.append(event)
        self.admission.enqueued()
        doc.last_touch_tick = self._tick

    def _pop_stamp(self, doc: DocState, txn: RemoteTxn) -> Optional[float]:
        """Admission stamp for a released txn: exact (agent, seq) hit,
        else the nearest earlier same-agent stamp (the buffer trims
        already-known prefixes, shifting the released seq forward), else
        now. None without a clock."""
        if self.clock is None:
            return None
        key = (txn.id.agent, txn.id.seq)
        t = doc.submit_stamps.pop(key, None)
        if t is not None:
            return t
        best = None
        for (agent, seq), stamp in doc.submit_stamps.items():
            if agent == txn.id.agent and seq <= txn.id.seq:
                if best is None or seq > best[0]:
                    best = (seq, stamp)
        if best is not None:
            doc.submit_stamps.pop((txn.id.agent, best[0]), None)
            return best[1]
        return self.clock()

    def _prune_stamps(self, doc: DocState) -> None:
        """Stamps whose seqs the buffer watermark already covers belong
        to duplicates that will never release — drop them (bounds the
        dict against duplicate-heavy re-deliveries)."""
        if len(doc.submit_stamps) <= 1024:
            return
        marks = doc.buffer.watermarks()
        for key in [k for k in doc.submit_stamps
                    if k[1] < marks.get(k[0], 0)]:
            del doc.submit_stamps[key]

    def enqueue_released(self, doc: DocState,
                         released: List[RemoteTxn]) -> None:
        """Queue causally-released txns as events carrying their
        ADMISSION stamps (a release must never be refused — refusing it
        would desync the buffer watermark)."""
        for txn in released:
            if self.flow is not None:
                # The ONE choke point every causal release crosses
                # (submit-time drains AND tick-end watermark advances):
                # the span's buffered->ready crossing.
                self.flow.ready(doc.doc_id, txn)
            self._enqueue(doc, Event(EV_TXN, txn, txn_len(txn), self._tick,
                                     t_submit=self._pop_stamp(doc, txn)))

    def _now(self) -> Optional[float]:
        return self.clock() if self.clock is not None else None

    def submit_txn(self, doc_id: str, txn: RemoteTxn) -> None:
        """Admit one remote txn (already decoded) into the doc's causal
        queue. Raises ``AdmissionError``; on success the txn is either
        released into the event FIFO or held in the causal buffer."""
        doc = self.doc(doc_id)
        try:
            self.admission.admit(doc_id, txn.id.agent, txn_len(txn),
                                 doc.pending(), self._tick,
                                 seq=txn.id.seq)
        except AdmissionError as e:
            self._flow_reject_txns(doc_id, [txn], e.reason)
            raise
        if self._ingest_txn(doc, txn) and self.journal is not None:
            self.journal.txns(doc.shard, doc_id, [txn])

    def _flow_reject_txns(self, doc_id: Optional[str],
                          txns: List[RemoteTxn], reason: str) -> None:
        """Stamp ``flow.reject`` for every sampled span an admission
        refusal bounced (all-or-nothing per frame/group, so the whole
        batch shares the reason).  Non-terminal if a redelivery later
        lands — the audit's precedence gives applied the last word."""
        if self.flow is None:
            return
        for t in txns:
            self.flow.rejected(doc_id, t.id.agent, reason,
                               seq=t.id.seq, n=txn_len(t))

    def _ingest_txn(self, doc: DocState, txn: RemoteTxn) -> bool:
        """Offer one admitted txn to the doc's causal buffer (with its
        admission stamp when the server has a clock); returns True when
        the buffer took it as FRESH (anything but a full duplicate) — the
        predicate the journal records on (dup deliveries are no-ops on
        buffer state, so replay skipping them reproduces the same
        trajectory for a fraction of the bytes)."""
        if self.clock is not None:
            doc.submit_stamps.setdefault((txn.id.agent, txn.id.seq),
                                         self.clock())
            self._prune_stamps(doc)
        released = doc.buffer.add(txn)
        if (self.flow is not None
                and doc.buffer.last_offer == "buffered"):
            self.flow.buffered(doc.doc_id, txn, "held")
        doc.last_touch_tick = self._tick
        self.enqueue_released(doc, released)
        return doc.buffer.last_offer != "dup"

    def submit_local(self, doc_id: str, agent: str, pos: int,
                     del_len: int = 0, ins_content: str = "") -> None:
        """Admit one local edit (the server is the authoring peer)."""
        items = del_len + len(ins_content)
        if items <= 0:
            return
        doc = self.doc(doc_id)
        # Emission precedes admission: a refused local edit is still an
        # emitted span — its terminal state is the typed rejection.
        lk = (self.flow.emit_local(doc_id, agent, items)
              if self.flow is not None else None)
        try:
            self.admission.admit(doc_id, agent, items, doc.pending(),
                                 self._tick)
        except AdmissionError as e:
            if lk is not None:
                self.flow.rejected(doc_id, agent, e.reason, lk=lk)
            raise
        ordinal = doc.local_seen
        doc.local_seen += 1
        if self.journal is not None:
            self.journal.local(doc.shard, doc_id, agent, pos, del_len,
                               ins_content, ordinal)
        self._enqueue(doc, Event(EV_LOCAL, (agent, pos, del_len,
                                            ins_content), items,
                                 self._tick, lk=lk, ordinal=ordinal,
                                 t_submit=self._now()))

    def submit_frame(self, doc_id: str, data: bytes) -> List[bytes]:
        """Ingest one wire frame for ``doc_id``; returns response frames
        (served REQUESTs). Corrupt bytes raise a typed, counted
        ``AdmissionError`` — never an uncaught decode error."""
        doc = self.doc(doc_id)
        self.counters.incr("wire_bytes_in", len(data))
        if self.recorder is not None:
            self.recorder.note_frame(doc_id, data)
        try:
            kind, value, _, finfo = codec.decode_frame_ex(data)
        except CodecError as e:
            self._trace_codec_reject(doc_id, e)
            raise self.admission.reject_frame(
                str(e), doc=doc_id, agent=e.agent, seq=e.seq,
                n=e.n) from None
        self.counters.incr("frames_received")
        if (self.journal is not None
                and kind not in (codec.KIND_TXNS, codec.KIND_TXNS_MUX)):
            # Control frames steer trajectory-relevant state (REQUEST
            # touches the residency LRU clock, DIGEST advances
            # peer_marks) — the input log carries them verbatim so
            # recovery's re-execution stays exact.  TXNS frames are
            # journaled dedup'd below instead; a mux frame on this
            # lane is refused before it can mutate anything.
            self.journal.frame(doc.shard, doc_id, data)

        if kind == codec.KIND_TXNS:
            if self.flow is not None:
                # The framed crossing, stamped with the frame's stored
                # CRC32C as frame id (content-derived, so same-seed
                # runs — and dup deliveries — agree on it).
                self.flow.framed(doc_id, value, finfo.crc)
            # Two-phase: admission-CHECK every txn in the frame first,
            # then ingest — a mid-frame refusal must not leave a prefix
            # enqueued behind a raised AdmissionError (all-or-nothing
            # per frame; checked-prefix rate tokens are consumed).
            try:
                for i, txn in enumerate(value):
                    self.admission.check(doc_id, txn.id.agent,
                                         txn_len(txn),
                                         doc.pending() + i, self._tick,
                                         seq=txn.id.seq)
            except AdmissionError as e:
                self._flow_reject_txns(doc_id, value, e.reason)
                raise
            fresh = []
            for txn in value:
                self.admission.count_admitted(txn_len(txn))
                if self._ingest_txn(doc, txn):
                    fresh.append(txn)
            if fresh and self.journal is not None:
                self.journal.txns(doc.shard, doc_id, fresh)
            return []

        if kind == codec.KIND_REQUEST:
            # Serve the pull from the oracle when it is in memory; an
            # evicted doc registers the touch (restore happens at the
            # next tick) and the peer re-asks — a retry, not an error.
            doc.last_touch_tick = self._tick
            if not doc.resident:
                self.counters.incr("requests_deferred_evicted")
                return []
            txns = export_txns_for_wants(doc.oracle, value)
            out = []
            for i in range(0, len(txns), self._txns_per_frame):
                frame = self._encode_txns(txns[i:i + self._txns_per_frame])
                out.append(frame)
                self.counters.incr("wire_txn_bytes_out", len(frame))
            self.counters.incr("requests_served")
            return out

        if kind == codec.KIND_TXNS_MUX:
            # A multiplexed frame on the per-doc lane would need doc
            # routing this entry point does not do — a silent drop here
            # would ack-then-lose the txns. Typed refusal, like every
            # other wrong-shape input.
            raise self.admission.reject_frame(
                "TXNS_MUX frame on the per-doc lane "
                "(use submit_mux_frame)")

        # KIND_DIGEST: watermark gossip (reveals agents whose frames were
        # ALL lost — the causal buffer alone can't see those gaps; the
        # next ``poll_request_frame`` pulls them) + divergence detection
        # (equal watermarks, unequal digests = the must-never-happen
        # CRDT failure, surfaced loudly).
        marks, digest = value
        for agent, wm in marks.items():
            if wm > doc.peer_marks.get(agent, 0):
                doc.peer_marks[agent] = wm
        if doc.resident and not doc.events:
            mine = agent_watermarks(doc.oracle)
            if marks == mine and digest != state_digest(doc.oracle):
                doc.divergence_detected = True
                self.counters.incr("divergence_detected")
                if self.tracer is not None:
                    self.tracer.event("divergence", doc=doc_id,
                                      via="digest")
                if self.recorder is not None:
                    self.recorder.on_failure(
                        "divergence",
                        "peer digest mismatch at equal watermarks",
                        doc_id=doc_id, oracle=doc.oracle)
        return []

    def _trace_codec_reject(self, doc_id: Optional[str],
                            err: CodecError) -> None:
        """One trace event + (bounded) post-mortem bundle per codec
        rejection — the 'what came off the wire right before' record.
        When the decoder could name the offending span (txn-level
        validation failures), its ``(agent, seq)`` range rides the
        event."""
        if self.tracer is not None:
            span = {}
            if err.agent is not None:
                span = {"agent": err.agent, "seq": err.seq, "n": err.n}
            self.tracer.event("codec.reject", doc=doc_id, err=str(err),
                              **span)
        if self.recorder is not None:
            self.recorder.on_failure("codec", str(err), doc_id=doc_id)

    def submit_mux_frame(self, data: bytes) -> List[Tuple[str, str]]:
        """Ingest one doc-multiplexed TXNS frame (``net/columnar``
        TXNS_MUX) — the connection-level replication lane, where one
        frame carries many documents' batches.

        Admission is all-or-nothing per DOC GROUP, not per frame: one
        overloaded or unknown document must not reject every other
        document sharing the connection. Returns the per-group
        rejections as ``(doc_id, reason)`` pairs (the frame itself
        failing to decode still raises, as in ``submit_frame``)."""
        self.counters.incr("wire_bytes_in", len(data))
        if self.recorder is not None:
            self.recorder.note_frame(None, data)
        try:
            kind, groups, _, finfo = codec.decode_frame_ex(data)
        except CodecError as e:
            self._trace_codec_reject(None, e)
            raise self.admission.reject_frame(
                str(e), agent=e.agent, seq=e.seq, n=e.n) from None
        if kind != codec.KIND_TXNS_MUX:
            raise self.admission.reject_frame(
                f"frame kind {kind} on the mux lane")
        self.counters.incr("frames_received")
        rejected: List[Tuple[str, str]] = []
        for doc_id, txns in groups:
            if self.flow is not None:
                self.flow.framed(doc_id, txns, finfo.crc)
            try:
                doc = self.doc(doc_id)
                for i, txn in enumerate(txns):
                    self.admission.check(doc_id, txn.id.agent, txn_len(txn),
                                         doc.pending() + i, self._tick,
                                         seq=txn.id.seq)
            except AdmissionError as e:
                self._flow_reject_txns(doc_id, txns, e.reason)
                rejected.append((doc_id, str(e)))
                continue
            fresh = []
            for txn in txns:
                self.admission.count_admitted(txn_len(txn))
                if self._ingest_txn(doc, txn):
                    fresh.append(txn)
            if fresh and self.journal is not None:
                self.journal.txns(doc.shard, doc_id, fresh)
        return rejected

    # -- pull / export surface ---------------------------------------------

    def poll_request_frame(self, doc_id: str) -> Optional[bytes]:
        """The REQUEST frame this doc currently owes its peers: the
        causal buffer's missing-range frontier (gaps from dropped or
        corrupted frames) PLUS gaps only peer digests reveal (an agent
        whose every frame was lost). None when nothing is missing."""
        doc = self.doc(doc_id)
        if self.journal is not None:
            # A poll is an input, not a pure read: absorb_oracle_marks
            # below folds the oracle's watermarks into known_marks,
            # which narrows every later REQUEST the doc emits.
            self.journal.poll(doc.shard, doc_id)
        wants: Dict[str, int] = {}
        for rid in doc.buffer.missing():
            wants[rid.agent] = min(wants.get(rid.agent, rid.seq), rid.seq)
        marks = dict(doc.buffer.watermarks())
        doc.absorb_oracle_marks()
        for agent, wm in doc.known_marks.items():
            marks[agent] = max(marks.get(agent, 0), wm)
        for agent, peer_wm in doc.peer_marks.items():
            mine = marks.get(agent, 0)
            if peer_wm > mine:
                wants[agent] = min(wants.get(agent, mine), mine)
        if not wants:
            return None
        self.counters.incr("range_requests")
        if self.tracer is not None:
            self.tracer.event("resync.round", doc=doc_id, wants=len(wants))
        return codec.encode_request(wants)

    def export_since(self, doc_id: str, start_order: int
                     ) -> List[RemoteTxn]:
        """History with order >= start_order — how downstream replicas
        (and the loadgen's twins) observe server-authored edits."""
        doc = self.doc(doc_id)
        assert doc.resident, "export from an evicted doc (restore first)"
        return export_txns_since(doc.oracle, start_order)

    @staticmethod
    def txn_agent_names(txn: RemoteTxn) -> set:
        """Every agent name a txn references (author, parents, origins,
        delete targets) — what must exist in the doc's AgentTable before
        the txn compiles."""
        names = {txn.id.agent}
        for p in txn.parents:
            names.add(p.agent)
        for op in txn.ops:
            if isinstance(op, RemoteIns):
                names.add(op.origin_left.agent)
                names.add(op.origin_right.agent)
            else:
                names.add(op.id.agent)
        names.discard("ROOT")
        return names
