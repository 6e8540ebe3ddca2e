"""Admission control for the document server: typed backpressure
(counterpart of ``text_crdt_rust_tpu/serve/admission.py``).

The serving contract (mirroring `net/`'s failure philosophy):
overload and bad input are *protocol outcomes*, never crashes. Every
refusal is an ``AdmissionError`` with a machine-readable ``reason`` the
caller can branch on and the server counts:

- ``doc-unknown``     — traffic for a doc id the server never admitted;
- ``queue-full``      — the per-doc or global pending-event bound hit
                        (the caller backs off and retries; nothing was
                        enqueued);
- ``frame-rejected``  — undecodable wire bytes (wraps ``CodecError``)
                        or a structurally-oversized op (``max_txn_len``,
                        which bounds the compiled steps one event can
                        cost a batch tick);
- ``rate-limited``    — the submitting agent's token bucket is dry
                        (one hot client must not starve a lane batch).

Token buckets run on the server's logical tick clock — deterministic
under test, like `net/session.py`'s backoff (no wall-clock anywhere in
the admission decision).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..utils.metrics import Counters

REASON_DOC_UNKNOWN = "doc-unknown"
REASON_QUEUE_FULL = "queue-full"
REASON_FRAME_REJECTED = "frame-rejected"
REASON_RATE_LIMITED = "rate-limited"

_REASONS = (REASON_DOC_UNKNOWN, REASON_QUEUE_FULL,
            REASON_FRAME_REJECTED, REASON_RATE_LIMITED)


class AdmissionError(RuntimeError):
    """A submission was refused; ``reason`` is one of the module's
    ``REASON_*`` constants. Recoverable by construction: a refused call
    enqueues NOTHING (multi-txn frames are checked whole before any txn
    enters — all-or-nothing); the only state a refusal may have touched
    is rate-bucket tokens consumed by the checked prefix."""

    def __init__(self, reason: str, detail: str):
        assert reason in _REASONS, reason
        self.reason = reason
        super().__init__(f"{reason}: {detail}")


@dataclass
class TokenBucket:
    """Per-agent rate limiter on the logical tick clock.

    ``capacity`` tokens maximum, ``refill`` added per elapsed tick,
    lazily credited at ``take`` time (no per-tick sweep over agents).
    One token pays for one item (char inserted / item deleted), so cost
    tracks the device work a submission implies, not its frame count.
    """

    capacity: int
    refill: int
    tokens: float = 0.0
    last_tick: int = 0

    def __post_init__(self) -> None:
        self.tokens = float(self.capacity)

    def take(self, cost: int, tick: int) -> bool:
        if tick > self.last_tick:
            self.tokens = min(float(self.capacity),
                              self.tokens + self.refill
                              * (tick - self.last_tick))
            self.last_tick = tick
        if cost > self.tokens:
            return False
        self.tokens -= cost
        return True


class AdmissionControl:
    """Bounded queues + per-agent token buckets for one server.

    The router consults this before any state changes; a refusal
    therefore never leaves a half-enqueued event. Counters:
    ``admitted`` (events), ``admitted_items`` (chars/targets), and one
    ``rejected_<reason>`` per refusal class.
    """

    def __init__(self, *, max_queue_per_doc: int, max_queue_global: int,
                 max_txn_len: int, rate_capacity: int = 0,
                 rate_refill: int = 0,
                 counters: Optional[Counters] = None,
                 tracer=None):
        assert max_queue_per_doc >= 1 and max_queue_global >= 1
        self.max_queue_per_doc = max_queue_per_doc
        self.max_queue_global = max_queue_global
        self.max_txn_len = max_txn_len
        self.rate_capacity = rate_capacity
        self.rate_refill = rate_refill
        self.counters = counters if counters is not None else Counters()
        self.tracer = tracer
        self.global_pending = 0
        self._buckets: Dict[str, TokenBucket] = {}

    def _reject(self, reason: str, detail: str, *,
                doc: Optional[str] = None, agent: Optional[str] = None,
                seq: Optional[int] = None,
                n: Optional[int] = None) -> AdmissionError:
        self.counters.incr(f"rejected_{reason.replace('-', '_')}")
        if self.tracer is not None:
            # The offending (agent, seq) range rides the reject event —
            # triage gets the op's
            # identity, not just the reason class.  Absent for refusals
            # with no decodable span (corrupt frames, unknown docs).
            span = {k: v for k, v in (("doc", doc), ("agent", agent),
                                      ("seq", seq), ("n", n))
                    if v is not None}
            self.tracer.event("admission.reject", reason=reason, **span)
        return AdmissionError(reason, detail)

    def reject_frame(self, detail: str, *, doc: Optional[str] = None,
                     agent: Optional[str] = None,
                     seq: Optional[int] = None,
                     n: Optional[int] = None) -> AdmissionError:
        """Typed refusal for undecodable wire bytes (the router calls
        this from its ``CodecError`` handler so the count lives here);
        span kwargs carry the offending op when the decoder could name
        one (txn-level validation failures)."""
        return self._reject(REASON_FRAME_REJECTED, detail, doc=doc,
                            agent=agent, seq=seq, n=n)

    def reject_unknown_doc(self, doc_id: str) -> AdmissionError:
        return self._reject(REASON_DOC_UNKNOWN,
                            f"doc {doc_id!r} was never admitted")

    def admit(self, doc_id: str, agent: str, items: int,
              doc_pending: int, tick: int,
              seq: Optional[int] = None) -> None:
        """Gate AND count one event. Single-event submission path."""
        self.check(doc_id, agent, items, doc_pending, tick, seq=seq)
        self.count_admitted(items)

    def count_admitted(self, items: int) -> None:
        self.counters.incr("admitted")
        self.counters.incr("admitted_items", items)

    def check(self, doc_id: str, agent: str, items: int,
              doc_pending: int, tick: int,
              seq: Optional[int] = None) -> None:
        """Gate one event (``items`` = its item count) WITHOUT counting
        it admitted — multi-event frames check every event first, then
        count+enqueue, so a mid-frame refusal enqueues nothing (rate
        tokens of the checked prefix are consumed; queue/count state is
        untouched). Raises a typed ``AdmissionError``.  ``seq`` (the
        span start for remote txns) rides the reject trace event."""
        span = dict(doc=doc_id, agent=agent, seq=seq, n=items)
        if items > self.max_txn_len:
            raise self._reject(
                REASON_FRAME_REJECTED,
                f"event of {items} items exceeds max_txn_len "
                f"{self.max_txn_len} (split the edit)", **span)
        if doc_pending >= self.max_queue_per_doc:
            raise self._reject(
                REASON_QUEUE_FULL,
                f"doc {doc_id!r} has {doc_pending} pending events "
                f"(bound {self.max_queue_per_doc})", **span)
        if self.global_pending >= self.max_queue_global:
            raise self._reject(
                REASON_QUEUE_FULL,
                f"{self.global_pending} events pending server-wide "
                f"(bound {self.max_queue_global})", **span)
        if self.rate_capacity > 0:
            bucket = self._buckets.get(agent)
            if bucket is None:
                bucket = self._buckets[agent] = TokenBucket(
                    self.rate_capacity, self.rate_refill)
            if not bucket.take(items, tick):
                raise self._reject(
                    REASON_RATE_LIMITED,
                    f"agent {agent!r} exhausted its token bucket "
                    f"({self.rate_capacity} cap, {self.rate_refill}"
                    f"/tick)", **span)

    def enqueued(self) -> None:
        self.global_pending += 1
        self.counters.hiwater("queue_high_water", self.global_pending)

    def dequeued(self, n: int = 1) -> None:
        assert self.global_pending >= n
        self.global_pending -= n
