"""Anti-entropy resync sessions over the binary wire (counterpart of
``text_crdt_rust_tpu/net/session.py``).

One ``ResyncSession`` is a peer endpoint: a host oracle document, a
bounded ``CausalBuffer``, and the codec. Peers exchange three frame
kinds (``net/codec.py``):

- TXNS    — new history, broadcast since the last poll;
- DIGEST  — per-agent watermarks + portable state digest
  (`models.sync.state_digest`), the gossip that detects both *gaps*
  (peer's watermark ahead of mine — maybe every frame from an agent was
  dropped, so the causal buffer alone can't see it) and *divergence*
  (equal watermarks, unequal digests — the "must never happen" CRDT
  failure, surfaced instead of silently served);
- REQUEST — per-agent "send me seqs >= from_seq" pulls for missing
  ranges, paced by capped exponential backoff on a logical tick clock
  (deterministic under test; no wall-clock in the protocol).

Failure handling is total: corrupt frames are counted and dropped
(``CodecError`` — the digest/request cycle re-covers the loss), buffer
overflow evicts-and-re-requests instead of growing unboundedly, a gap
that outlives ``retry_limit`` re-requests raises ``CausalGapError`` (a
peer is gone or the range is unrecoverable — the caller's cue to find
another replica), and a device-engine mirror that would overflow its
fixed capacity *degrades to the host oracle* rather than asserting.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..common import CLIENT_INVALID, RemoteIns, RemoteTxn, txn_len
from ..models.oracle import ListCRDT
from ..models.sync import (
    agent_watermarks,
    export_txns_for_wants,
    export_txns_since,
    state_digest,
)
from ..parallel.causal import CausalBuffer
from ..utils.metrics import Counters
from . import codec
from .codec import CodecError

# Txns per TXNS frame: small enough that one lost frame costs little,
# large enough to amortize the string table.
TXNS_PER_FRAME = 8


class CausalGapError(RuntimeError):
    """A missing range outlived the re-request budget.

    Raised by ``ResyncSession.poll`` when a gap has been re-requested
    ``retry_limit`` times without the watermark moving — the sending
    replica is gone or never had the range. Carries what was missing so
    the caller can redirect the pull at another replica.
    """

    def __init__(self, missing: Dict[str, int], attempts: int):
        self.missing = dict(missing)
        self.attempts = attempts
        super().__init__(
            f"unrecoverable causal gap after {attempts} re-requests: "
            f"{self.missing}")


class DeviceMirror:
    """Device-engine shadow of a *receive-only* session's document.

    Released remote txns are compiled (``ops.batch.compile_remote_txns``)
    and applied to a ``FlatDoc`` alongside the oracle, on the flat engine
    (``ops/flat.py``: one launch of its kernel per released batch on the
    card, B = 1). The mirror is an accelerator, not the source of truth:
    any condition it cannot handle — capacity or order-log overflow, an
    agent not pre-registered in its rank table (rank re-basing is an
    epoch-boundary operation, ``ops.batch.rank_remap``) — flips
    ``degraded`` and the session keeps serving from the oracle. Never an
    assert on the serving path.

    ``agents`` must pre-register every peer name that will appear in the
    stream (ranks bake into compiled steps). Local edits do not flow
    through ``apply``; use mirrors on receive-only replicas. ``device``
    as ``resolve_device`` (CUDA unless ``"cpu"`` is named).
    """

    def __init__(self, capacity: int, order_capacity: Optional[int] = None,
                 agents: tuple = (), lmax: int = 8, device=None):
        from ..ops import batch as B
        from ..ops import span_arrays as SA

        self.table = B.AgentTable(agents)
        self.assigner = None
        self.doc = SA.make_flat_doc(capacity, order_capacity, device=device)
        self.lmax = lmax
        self.degraded = False
        self.degrade_reason = ""

    def _degrade(self, reason: str, counters: Counters) -> None:
        self.degraded = True
        self.degrade_reason = reason
        counters.incr("device_degraded")

    def apply(self, txns: List[RemoteTxn], counters: Counters) -> None:
        from ..ops import batch as B
        from ..ops import flat as F

        if self.degraded or not txns:
            return
        names = set()
        for t in txns:
            names.add(t.id.agent)
            for p in t.parents:
                names.add(p.agent)
            for op in t.ops:
                if isinstance(op, RemoteIns):
                    names.update((op.origin_left.agent,
                                  op.origin_right.agent))
                else:
                    names.add(op.id.agent)
        unknown = {n for n in names if n != "ROOT" and n not in self.table}
        if unknown:
            self._degrade(f"unregistered agents {sorted(unknown)}", counters)
            return
        ins_chars = sum(len(op.ins_content) for t in txns for op in t.ops
                        if isinstance(op, RemoteIns))
        orders = sum(txn_len(t) for t in txns)
        if (int(self.doc.n) + ins_chars > self.doc.capacity
                or int(self.doc.next_order) + orders
                > self.doc.order_capacity):
            self._degrade(
                f"capacity overflow: n {int(self.doc.n)}+{ins_chars} "
                f"vs {self.doc.capacity}, orders {int(self.doc.next_order)}"
                f"+{orders} vs {self.doc.order_capacity}", counters)
            return
        ops, self.assigner = B.compile_remote_txns(
            txns, self.table, assigner=self.assigner, lmax=self.lmax)
        self.doc = F.apply_ops(self.doc, ops)
        counters.incr("device_txns_applied", len(txns))


def span_is_items(doc: ListCRDT, agent_name: str, seq: int,
                  span: int) -> bool:
    """Every (agent, seq .. seq+span) names an existing document ITEM
    — an inserted char, live or tombstoned — not a delete-op's
    consumed seq (which maps to an order but to no body row).

    An assigned order is an item iff it is not a delete-op order, so
    after ``item_orders`` proves the seqs exist this is an O(log n)
    interval-overlap test against the deletes log per chunk — no
    body scan."""
    aid = doc.get_agent_id(agent_name)
    if aid is None or aid == CLIENT_INVALID:
        return False
    io = doc.client_data[aid].item_orders
    del_log = doc.deletes
    remaining, s = span, seq
    while remaining > 0:
        found = io.find(s)
        if found is None:
            return False
        entry, off = found
        take = min(entry.length - off, remaining)
        o = entry.order + off
        ok, idx = del_log.search(o)
        if ok:
            return False  # chunk starts inside a delete-op range
        ents = del_log.entries
        if idx < len(ents) and ents[idx].key < o + take:
            return False  # a delete-op range starts inside the chunk
        s += take
        remaining -= take
    return True


def txn_refs_known(doc: ListCRDT, txn: RemoteTxn) -> bool:
    """Every id a released txn references must resolve at apply time.
    The causal buffer only checks *parents*; a well-formed frame from
    a buggy or malicious peer can still be out of order (after an
    earlier same-agent rejection rolled the watermark back), or
    reference unknown origins, forward/self seqs, or delete-op seqs —
    all of which the oracle hard-asserts on. Callers (the resync
    session's pump loop, the serve batcher's tick) reject
    typed-and-counted instead of crashing.

    Three tiers of reference:
    - the txn itself must be seq-in-order against the DOC watermark;
    - parents are txn ids: they need a seq->order *mapping*
      (seq < watermark) but not a body row (a txn's last op may be a
      delete op);
    - origins and delete targets must name *items*: validated against
      the document body for known history, or against the
      inserted-char intervals of STRICTLY EARLIER ops of this txn."""
    marks = agent_watermarks(doc)
    if txn.id.seq != marks.get(txn.id.agent, 0):
        return False
    own_ins: List = []  # (start, end) insert seq intervals so far

    def parent_known(rid) -> bool:
        if rid.agent == "ROOT":
            return True
        return rid.seq < marks.get(rid.agent, 0)

    def item_known(rid, span=1) -> bool:
        if rid.agent == "ROOT":
            return True
        end = rid.seq + span
        cur = rid.seq
        wm = marks.get(rid.agent, 0)
        if cur < wm:
            lo = min(end, wm) - cur
            if not span_is_items(doc, rid.agent, cur, lo):
                return False
            cur += lo
        if rid.agent != txn.id.agent:
            return cur >= end
        # Remainder must be chars this txn already inserted
        # (intervals ascend and are disjoint by construction).
        for s, e in own_ins:
            if cur >= end:
                break
            if s <= cur < e:
                cur = min(e, end)
        return cur >= end

    if not all(parent_known(p) for p in txn.parents):
        return False
    cursor = txn.id.seq
    for op in txn.ops:
        if isinstance(op, RemoteIns):
            if not (item_known(op.origin_left)
                    and item_known(op.origin_right)):
                return False
            nxt = cursor + len(op.ins_content)
            own_ins.append((cursor, nxt))
            cursor = nxt
        else:
            if not item_known(op.id, op.len):
                return False
            cursor += op.len
    return True


class ResyncSession:
    """One peer endpoint of the resync protocol.

    Drive it with a pump loop: ``poll()`` returns frames to send
    (new history + digest + due re-requests), ``receive(frame)`` ingests
    one delivered frame and returns any response frames (served
    REQUESTs). Both are safe against arbitrary bytes: every rejection is
    typed, counted in ``counters``, and recovered by the digest cycle.
    """

    def __init__(self, doc: ListCRDT, *,
                 max_pending: Optional[int] = None,
                 retry_limit: int = 32,
                 backoff_base: int = 1,
                 backoff_cap: int = 8,
                 digest_every: int = 1,
                 mirror: Optional[DeviceMirror] = None,
                 counters: Optional[Counters] = None,
                 wire: str = "row", tracer=None, recorder=None):
        self.doc = doc
        self.wire = wire
        # Optional ``obs.trace.Tracer``: one ``resync.round`` event per
        # poll that re-requests ranges (logical-tick-stamped, so mesh
        # anti-entropy behavior is reconstructible post-hoc).  The
        # optional ``obs.recorder.FlightRecorder`` dumps a post-mortem
        # when a gap outlives the retry budget (``CausalGapError``).
        self.tracer = tracer
        self.recorder = recorder
        self._encode_txns = codec.txns_encoder(wire)
        # The columnar wire amortizes its name table + column headers
        # across the batch, so it ships far bigger frames; the row wire
        # keeps the small-frame loss-granularity default.
        self._txns_per_frame = TXNS_PER_FRAME if wire == "row" else 512
        self.buffer = CausalBuffer(max_pending=max_pending)
        self.mirror = mirror
        self.counters = counters if counters is not None else Counters()
        self.retry_limit = retry_limit
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.digest_every = max(1, digest_every)
        self.divergence_detected = False
        self.protocol_error = False
        self._tick = 0
        self._bcast_order = 0
        self._digest_cache = (None, 0)
        # agent -> [attempts, next_due_tick, last_from_seq] for
        # outstanding gap pulls.
        self._requests: Dict[str, List[int]] = {}
        # Latest watermark vector each digest advertised.
        self._peer_marks: Dict[str, int] = {}
        self._sync_watermarks()

    # -- internals ----------------------------------------------------------

    def _apply_released(self, released: List[RemoteTxn]) -> None:
        applied = []
        for txn in released:
            if not txn_refs_known(self.doc, txn):
                self.counters.incr("txns_rejected")
                self.protocol_error = True
                # The release advanced the buffer watermark; undo it so
                # an honest redelivery of this (agent, seq) is accepted
                # rather than trimmed as a duplicate, and the gap stays
                # visible to the digest/re-request cycle. Dependents
                # later in this batch fail the same validation (their
                # refs/parents now read as unknown) and roll back too.
                self.buffer.rollback_watermark(txn.id.agent, txn.id.seq)
                continue
            self.doc.apply_remote_txn(txn)
            applied.append(txn)
        if applied:
            self.counters.incr("txns_applied", len(applied))
            if self.mirror is not None:
                self.mirror.apply(applied, self.counters)

    def _sync_watermarks(self) -> None:
        """Align the buffer with out-of-band document progress (our own
        local edits, or sibling sessions sharing this doc in an N-peer
        mesh) so echoed deliveries dedup and dependents release."""
        self._apply_released(
            self.buffer.advance_watermarks(agent_watermarks(self.doc)))

    def _my_watermark(self, agent: str) -> int:
        return max(self.buffer.watermarks().get(agent, 0),
                   agent_watermarks(self.doc).get(agent, 0))

    def _wanted(self) -> Dict[str, int]:
        """Every (agent -> from_seq) range we currently lack: gaps the
        causal buffer can *see* (blocked pending txns) plus gaps only the
        peer's digest reveals (all frames from an agent dropped)."""
        wants: Dict[str, int] = {}
        for rid in self.buffer.missing():
            wants[rid.agent] = min(wants.get(rid.agent, rid.seq), rid.seq)
        for agent, peer_wm in self._peer_marks.items():
            mine = self._my_watermark(agent)
            if peer_wm > mine:
                wants[agent] = min(wants.get(agent, mine), mine)
        return wants

    # -- protocol pump ------------------------------------------------------

    def _state_digest(self) -> int:
        """``models.sync.state_digest`` cached on (n, next_order): every
        apply/local edit advances next_order, so the O(n) portable hash
        only recomputes when the document actually changed."""
        key = (self.doc.n, self.doc.get_next_order())
        if self._digest_cache[0] != key:
            self._digest_cache = (key, state_digest(self.doc))
        return self._digest_cache[1]

    def poll(self) -> List[bytes]:
        """Advance the logical clock; emit frames owed to the peer."""
        self._tick += 1
        self._sync_watermarks()

        # Gap pulls FIRST: this section can raise CausalGapError, and it
        # must do so before _bcast_order advances — otherwise the history
        # batch built this tick would be skipped forever on the
        # caught-and-redirected recovery path.
        wanted = self._wanted()
        # Gap closed -> retire its backoff schedule.
        for agent in [a for a in self._requests if a not in wanted]:
            del self._requests[agent]
        # Exhaustion pre-scan with NO state mutation: raising mid-loop
        # would burn other agents' attempt counters on requests that are
        # never sent (the frames list is discarded by the raise).
        for agent, from_seq in sorted(wanted.items()):
            entry = self._requests.get(agent)
            if entry is None or from_seq > entry[2]:
                continue  # first ask / new gap: budget (re)starts fresh
            if self._tick >= entry[1] and entry[0] + 1 > self.retry_limit:
                err = CausalGapError(wanted, entry[0])
                if self.recorder is not None:
                    self.recorder.on_failure(
                        "causal-gap", str(err),
                        tick=self._tick,
                        extra={"wanted": dict(wanted),
                               "attempts": entry[0]})
                raise err
        due: Dict[str, int] = {}
        for agent, from_seq in sorted(wanted.items()):
            entry = self._requests.setdefault(
                agent, [0, self._tick, from_seq])
            if from_seq > entry[2]:
                # The watermark moved since the last ask: the peer IS
                # feeding us (a long lossy backfill), this is a new gap —
                # reset the attempt budget AND the backoff deadline so
                # the fresh gap's first ask goes out this tick instead of
                # waiting out the previous gap's capped delay.
                entry[0] = 0
                entry[1] = self._tick
                entry[2] = from_seq
            if self._tick < entry[1]:
                continue
            entry[0] += 1
            delay = min(self.backoff_cap,
                        self.backoff_base * (1 << (entry[0] - 1)))
            entry[1] = self._tick + delay
            due[agent] = from_seq
            self.counters.incr("range_retries")

        frames: List[bytes] = []
        # New history (ours AND merged — peers beyond two hop through us).
        txns = export_txns_since(self.doc, self._bcast_order)
        self._bcast_order = self.doc.get_next_order()
        for i in range(0, len(txns), self._txns_per_frame):
            frame = self._encode_txns(txns[i:i + self._txns_per_frame])
            frames.append(frame)
            self.counters.incr("frames_sent")
            self.counters.incr("wire_txn_bytes_sent", len(frame))

        if self._tick % self.digest_every == 0:
            frames.append(codec.encode_digest(
                agent_watermarks(self.doc), self._state_digest()))
            self.counters.incr("frames_sent")

        if due:
            frames.append(codec.encode_request(due))
            self.counters.incr("frames_sent")
            if self.tracer is not None:
                self.tracer.set_tick(self._tick)
                self.tracer.event("resync.round", wants=len(due))

        self.counters.hiwater("buffer_high_water", self.buffer.high_water)
        return frames

    def receive(self, data: bytes) -> List[bytes]:
        """Ingest one delivered frame; return response frames (if any).

        Corrupt bytes are rejected with a counted ``CodecError`` — never
        an uncaught exception — and the loss is re-covered by the
        digest/request cycle.
        """
        self._sync_watermarks()
        try:
            kind, value, _ = codec.decode_frame(data)
        except CodecError:
            self.counters.incr("frames_rejected")
            return []
        self.counters.incr("frames_received")

        if kind == codec.KIND_TXNS:
            released = self.buffer.add_all(value)
            self._apply_released(released)
            self.counters.hiwater("buffer_high_water", self.buffer.high_water)
            return []

        if kind == codec.KIND_REQUEST:
            txns = export_txns_for_wants(self.doc, value)
            out: List[bytes] = []
            for i in range(0, len(txns), self._txns_per_frame):
                frame = self._encode_txns(txns[i:i + self._txns_per_frame])
                out.append(frame)
                self.counters.incr("frames_sent")
                self.counters.incr("wire_txn_bytes_sent", len(frame))
            self.counters.incr("requests_served")
            return out

        # KIND_DIGEST
        marks, digest = value
        self._peer_marks = dict(marks)
        mine = agent_watermarks(self.doc)
        if marks == mine and digest != self._state_digest():
            # Same op sets, different states: the CRDT convergence
            # contract broke (or local state corrupted). Surface loudly;
            # serving reads from this replica would be silently wrong.
            self.divergence_detected = True
            self.counters.incr("divergence_detected")
        return []

    # -- readback -----------------------------------------------------------

    @property
    def device_doc(self):
        """The serving document for device-accelerated reads: the mirror
        while healthy, the host oracle once degraded (graceful fallback,
        never an assert)."""
        if self.mirror is not None and not self.mirror.degraded:
            return self.mirror.doc
        return self.doc
