"""Causal receive buffer for out-of-order remote transactions (the port's
copy of ``text_crdt_rust_tpu/parallel/causal.py``, plain Python).

The reference asserts remote txns arrive in per-agent seq order and leaves a
TODO: "we either need to skip or buffer the transaction" (`doc.rs:246-247`).
This module implements that buffer (SURVEY §5 "Failure detection" row): txns
are held until *causally ready* — every parent known and the author's seq
contiguous — then released in a deterministic causal order. It fronts both
the host oracle (``ListCRDT.apply_remote_txn``) and the device op compiler
(``ops.batch.compile_remote_txns``), which both hard-assert readiness.

Readiness (`doc.rs:242-269` preconditions):
- ``txn.id.seq`` == the author's next expected seq (no gaps in an agent's
  op stream; seqs within a txn advance by its op length, `doc.rs:252-269`);
- every parent id is ROOT or already released (parents are (agent, seq)
  pairs; known iff seq < that agent's released watermark).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ..common import RemoteId, RemoteTxn, split_txn_suffix, txn_len


class CausalBuffer:
    """Holds remote txns until causally ready; releases them in order.

    ``add``/``add_all`` return the txns that became ready (possibly
    including earlier-buffered ones), in a valid causal order. Duplicate
    and already-known txns are dropped, mirroring the idempotent re-sync
    behavior peers need (`README.md:33-35` peer model).

    ``max_pending`` bounds the buffer: offering a txn to a full buffer
    evicts the pending txn farthest from readiness (largest seq gap to
    its author's watermark — the one that needs the most missing history
    before it can release) instead of growing without bound. Evictions
    are counted, the watermark is untouched, and the evicted range is
    remembered (until the watermark covers it) so ``missing()`` still
    names the gap even when the evicted txn was the agent's only pending
    entry — the session layer re-requests the range and the peer
    re-delivers; eviction trades memory for a retransmit, never
    correctness (`net/session.py`).

    Introspection for that layer (surfaced via
    ``utils.metrics.causal_buffer_stats``): ``pending``, ``high_water``,
    ``duplicates_dropped``, ``evictions``, ``watermarks()``,
    ``gap_stats()``.
    """

    def __init__(self, max_pending: Optional[int] = None) -> None:
        assert max_pending is None or max_pending >= 1
        # Agent name -> next expected seq (the released watermark).
        self._next_seq: Dict[str, int] = {}
        self._pending: List[RemoteTxn] = []
        self.max_pending = max_pending
        self.high_water = 0        # max simultaneous pending ever seen
        self.duplicates_dropped = 0
        self.evictions = 0
        # Agent -> end seq of the farthest evicted txn: keeps the gap
        # visible to missing() until redelivery covers it.
        self._evicted_ends: Dict[str, int] = {}
        # What happened to the LAST ``add`` offer — "released" (the
        # offered span's watermark advanced past it), "buffered"
        # (held on a causal gap), "dropped" (pressure-evicted within
        # this very offer — it left the buffer, on_drop already saw
        # it), or "dup" (fully known / superseded).  Per-op provenance
        # (obs/flow) reads this right after ``add`` to stamp the
        # span's buffer-vs-ready lifecycle event.
        self.last_offer = "dup"
        # Optional pressure-eviction observer: called with the evicted
        # txn (the span leaves the buffer but NOT the ledger — the gap
        # stays visible to missing() and redelivery brings it back).
        self.on_drop = None

    def _watermark(self, agent: str) -> int:
        return self._next_seq.get(agent, 0)

    def _known(self, rid: RemoteId) -> bool:
        if rid.agent == "ROOT":
            return True
        return rid.seq < self._watermark(rid.agent)

    def _ready(self, txn: RemoteTxn) -> bool:
        if txn.id.seq != self._watermark(txn.id.agent):
            return False
        return all(self._known(p) for p in txn.parents)

    def _trim(self, txn: RemoteTxn) -> RemoteTxn | None:
        """Drop the already-released prefix of ``txn`` (re-sync deliveries
        may cover known seqs — a peer's txns RLE merges linear history, so
        a later export can span an older one, `txn.rs:38-42`). Returns None
        if fully known."""
        wm = self._watermark(txn.id.agent)
        if txn.id.seq + txn_len(txn) <= wm:
            return None  # duplicate / fully released
        if txn.id.seq < wm:
            return split_txn_suffix(txn, wm - txn.id.seq)
        return txn

    def _offer_status(self, trimmed: RemoteTxn) -> str:
        """Post-drain fate of the offered span: released iff the
        author's watermark walked past its start seq (it — or a
        superseding delivery — came out of the drain)."""
        return ("released"
                if self._watermark(trimmed.id.agent) > trimmed.id.seq
                else "buffered")

    def add(self, txn: RemoteTxn) -> List[RemoteTxn]:
        """Offer one txn; return every txn that is now ready, causal order."""
        trimmed = self._trim(txn)
        if trimmed is None:
            self.duplicates_dropped += 1
            self.last_offer = "dup"
            return []
        # Re-delivery of a still-blocked txn (peers re-sync while a parent
        # is missing) must not grow the buffer: one entry per (agent, seq),
        # keeping the longer delivery (a merged export supersedes a prefix).
        for i, held in enumerate(self._pending):
            if held.id == trimmed.id:
                if txn_len(trimmed) > txn_len(held):
                    self._pending[i] = trimmed
                    released = self._drain()
                    self.last_offer = self._offer_status(trimmed)
                    return released
                self.duplicates_dropped += 1
                self.last_offer = "dup"
                return []
        self._pending.append(trimmed)
        self.high_water = max(self.high_water, len(self._pending))
        released = self._drain()
        if (self.max_pending is not None
                and len(self._pending) > self.max_pending):
            self._evict()
        status = self._offer_status(trimmed)
        if status == "buffered" and all(h.id != trimmed.id
                                        for h in self._pending):
            # The eviction above chose the offer itself (it had the
            # farthest watermark gap): it is NOT held — reporting
            # "buffered" would stamp a held event after on_drop
            # already recorded the drop.
            status = "dropped"
        self.last_offer = status
        return released

    def _evict(self) -> None:
        """Drop the pending txn farthest from readiness (largest seq gap
        to its author's watermark). Ties go to the later arrival, so the
        txn most likely to unblock soonest survives."""
        worst_i, worst_gap = 0, -1
        for i, held in enumerate(self._pending):
            gap = held.id.seq - self._watermark(held.id.agent)
            if gap >= worst_gap:
                worst_i, worst_gap = i, gap
        evicted = self._pending.pop(worst_i)
        agent = evicted.id.agent
        end = evicted.id.seq + txn_len(evicted)
        self._evicted_ends[agent] = max(self._evicted_ends.get(agent, 0),
                                        end)
        self.evictions += 1
        if self.on_drop is not None:
            self.on_drop(evicted)

    def add_all(self, txns: Iterable[RemoteTxn]) -> List[RemoteTxn]:
        out: List[RemoteTxn] = []
        for t in txns:
            out.extend(self.add(t))
        return out

    def _drain(self) -> List[RemoteTxn]:
        released: List[RemoteTxn] = []
        progressed = True
        while progressed:
            progressed = False
            for i, txn in enumerate(self._pending):
                if txn.id.seq < self._watermark(txn.id.agent):
                    # Watermark moved while buffered: re-trim (overlapping
                    # delivery) or drop (duplicate).
                    self._pending.pop(i)
                    trimmed = self._trim(txn)
                    if trimmed is not None:
                        self._pending.insert(i, trimmed)
                    progressed = True
                    break
                if self._ready(txn):
                    self._pending.pop(i)
                    self._next_seq[txn.id.agent] = txn.id.seq + txn_len(txn)
                    released.append(txn)
                    progressed = True
                    break
        return released

    @property
    def pending(self) -> int:
        """Buffered txns still waiting on causal dependencies."""
        return len(self._pending)

    def advance_watermark(self, agent: str, seq: int) -> List[RemoteTxn]:
        """Record out-of-band progress for ``agent`` (e.g. the session's
        own local edits, which never flow through the buffer) so echoed
        re-deliveries trim as duplicates and pending txns parented on that
        progress can release. Returns any txns that became ready."""
        return self.advance_watermarks({agent: seq})

    def advance_watermarks(self, marks: Dict[str, int]) -> List[RemoteTxn]:
        """Batch form of ``advance_watermark``: raise EVERY watermark
        first, then drain once. Draining per-agent would be wrong when
        several agents progressed out-of-band (e.g. sessions sharing one
        document, `net/session.py` N-peer mesh): unblocking agent A's
        dependents against agent B's still-stale watermark would release
        a txn the document already applied."""
        changed = False
        for agent, seq in marks.items():
            if seq > self._watermark(agent):
                self._next_seq[agent] = seq
                changed = True
        return self._drain() if changed else []

    def rollback_watermark(self, agent: str, seq: int) -> None:
        """Undo a release that the caller refused to apply (e.g. the
        session's reference validation rejected the txn): lower the
        watermark back to ``seq`` so an honest redelivery of that
        (agent, seq) is accepted instead of trimmed as a duplicate, and
        the gap stays visible to the digest/re-request cycle."""
        if seq < self._watermark(agent):
            self._next_seq[agent] = seq

    def watermarks(self) -> Dict[str, int]:
        """Per-agent released watermark (next expected seq), a copy."""
        return dict(self._next_seq)

    def gap_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-agent watermark gaps for agents with blocked pending txns:
        ``{agent: {next_seq, first_pending, gap, blocked}}`` where ``gap``
        is how many seqs are missing before the earliest pending txn from
        that agent could release."""
        out: Dict[str, Dict[str, int]] = {}
        for txn in self._pending:
            agent = txn.id.agent
            wm = self._watermark(agent)
            slot = out.setdefault(agent, {
                "next_seq": wm, "first_pending": txn.id.seq,
                "gap": txn.id.seq - wm, "blocked": 0,
            })
            slot["blocked"] += 1
            if txn.id.seq < slot["first_pending"]:
                slot["first_pending"] = txn.id.seq
                slot["gap"] = txn.id.seq - wm
        return out

    def missing(self) -> List[RemoteId]:
        """The frontier of unmet dependencies — the first unreceived
        (agent, seq) per blocking agent, i.e. what to request from peers
        (failure detection: a persistently-missing id marks a lost txn)."""
        out: List[RemoteId] = []
        seen = set()

        def want(agent: str) -> None:
            rid = RemoteId(agent, self._watermark(agent))
            if agent != "ROOT" and rid not in seen:
                seen.add(rid)
                out.append(rid)

        for txn in self._pending:
            if txn.id.seq > self._watermark(txn.id.agent):
                want(txn.id.agent)  # gap in the author's own stream
            for p in txn.parents:
                if not self._known(p):
                    want(p.agent)
        # Evicted ranges: the txn is gone but the gap is not — keep
        # naming it until the watermark covers the evicted end.
        for agent in list(self._evicted_ends):
            if self._watermark(agent) >= self._evicted_ends[agent]:
                del self._evicted_ends[agent]
            else:
                want(agent)
        return out
