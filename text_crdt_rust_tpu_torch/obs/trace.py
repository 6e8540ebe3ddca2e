"""Logical-clock-first span/event tracer (counterpart of
``text_crdt_rust_tpu/obs/trace.py``).

The backbone is CAUSALITY, not wall time: every event is stamped with
the server's logical tick and a per-tracer monotonic sequence number,
and every wall-clock measurement lives in a segregated ``"w"`` sub-dict
— so the *logical* projection of a trace is a pure function of the
seeded workload.  Two same-seed loadgen runs emit byte-identical
logical JSONL streams, which is
exactly the property the serve twin-check's cross-backend bit-identity
proof needs from its observability layer: the trace can be diffed
between a good and a bad run to find the first diverging *event*, not
just the diverged end state.

Like automerge's binary document format, the trace is a
versioned, schema-checked artifact: every stream opens with a header
event carrying ``TRACE_SCHEMA_VERSION``, every kind declares its
required logical fields in ``EVENT_SCHEMA``, and ``validate_event``
refuses unknown kinds or missing fields — ad-hoc dict drift cannot
happen silently here.

Walls come only from the caller's clock (``Tracer(clock=...)``): the
port's package reads no clock of its own.

Event kinds cover the serving loop end to end:

===================  =======================================================
kind                 emitted by / meaning
===================  =======================================================
``trace.header``     stream start: schema version
``tick.drain``       batcher, per shard: events drained + steps compiled
``tick.fuse``        batcher, per lane doc: pre/post-fusion step counts
``tick.capacity``    batcher, per shard: lane streams probed / degraded
``tick.device``      batcher, per shard: one [S,B] device pass (bucket,
                     lanes, steps; dispatch wall in ``w``)
``tick.barrier``     batcher, per shard: device sync (wall in ``w``)
``device.compile``   batcher: a step-bucket shape compiled for the first
                     time (steady state must stop emitting these)
``apply``            batcher, per applied event: doc, author agent, seq,
                     item count — the event-level audit log the
                     divergence post-mortem joins against
``residency.evict``  residency: doc checkpointed out (kind, bytes)
``residency.restore`` residency: doc restored from its checkpoint
``residency.degrade`` residency: lane-capacity overflow -> host-only
``admission.reject`` admission: typed refusal (reason)
``codec.reject``     router: a frame failed ``net/codec`` validation
``divergence``       router/verifier: equal watermarks, unequal digests
                     (or a twin/lane bit-identity mismatch)
``resync.round``     session/router: anti-entropy round (wants emitted)
``profile``          serve: a profiler capture started/stopped (the JAX
                     package's; kept in the schema for parity)
``flow.*``           per-op provenance spans (obs/flow.py): emit /
                     frame / reject / buffer / ready / apply — one
                     ``(agent, seq)`` span's journey through the
                     serving loop, agent-sampled
===================  =======================================================
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Tuple

TRACE_SCHEMA_VERSION = 2  # v2: journal.segment /
#                           journal.refuse / recovery.replay /
#                           chaos.crash event kinds

# kind -> required logical field names (beyond the envelope "i"/"t"/"k").
# Extra fields are allowed — the schema pins the floor, not the ceiling.
EVENT_SCHEMA: Dict[str, Tuple[str, ...]] = {
    "trace.header": ("schema",),
    "tick.drain": ("shard", "events", "steps"),
    "tick.fuse": ("doc", "steps_in", "steps_out"),
    "tick.capacity": ("shard", "probed", "degraded"),
    "tick.device": ("shard", "bucket", "lanes", "steps"),
    "tick.barrier": ("shard",),
    "device.compile": ("shard", "bucket"),
    "apply": ("doc", "ev", "agent", "seq", "n"),
    "residency.evict": ("doc", "ckpt", "bytes"),
    "residency.restore": ("doc",),
    "residency.degrade": ("doc", "reason"),
    "admission.reject": ("reason",),
    "codec.reject": ("err",),
    "divergence": ("doc",),
    "resync.round": ("wants",),
    "profile": ("action",),
    # Per-op provenance spans (obs/flow.py): one op's journey
    # on the logical tick axis.  Remote spans carry (agent, seq, n);
    # local edits carry a per-doc ordinal ``lk`` until the oracle
    # realizes their seq at apply.  The floor requires doc+agent — seq
    # vs lk is the span-identity split the flow module owns.
    # Durability + recovery (the journal slice: serve/journal.py,
    # serve/chaos.py).
    "journal.segment": ("shard", "seg"),
    "journal.refuse": ("segment", "offset", "reason"),
    # Reopen-time repair: a refused suffix truncated/quarantined to a
    # ``.refused`` sidecar so post-recovery segments survive the next
    # scan (same fields as the refusal it repairs).
    "journal.repair": ("segment", "offset", "reason"),
    "recovery.replay": ("records", "ops", "ticks"),
    "chaos.crash": ("phase",),
    "flow.emit": ("doc", "agent", "n"),
    "flow.frame": ("doc", "agent", "seq", "n", "frame"),
    "flow.reject": ("doc", "agent", "reason"),
    "flow.buffer": ("doc", "agent", "seq", "n", "state"),
    "flow.ready": ("doc", "agent", "seq", "n"),
    "flow.apply": ("doc", "agent", "seq", "n", "mode"),
}

# The one reserved envelope key wall-clock data lives under; stripping
# it is the whole logical projection.
WALL_KEY = "w"
_ENVELOPE = ("i", "t", "k")


def validate_event(ev: dict) -> None:
    """Raise ``ValueError`` unless ``ev`` is a schema-valid trace event:
    known kind, full envelope, every required logical field present, and
    wall-clock data only under the reserved ``"w"`` key."""
    for key in _ENVELOPE:
        if key not in ev:
            raise ValueError(f"trace event missing envelope field {key!r}")
    kind = ev["k"]
    req = EVENT_SCHEMA.get(kind)
    if req is None:
        raise ValueError(f"unknown trace event kind {kind!r}")
    missing = [f for f in req if f not in ev]
    if missing:
        raise ValueError(f"trace event {kind!r} missing fields {missing}")
    wall = ev.get(WALL_KEY)
    if wall is not None and not isinstance(wall, dict):
        raise ValueError(f"wall field {WALL_KEY!r} must be a dict")


def event_line(ev: dict, logical_only: bool = False) -> str:
    """One JSONL line for an event — sorted keys and fixed separators so
    equal logical content is equal bytes."""
    if logical_only and WALL_KEY in ev:
        ev = {k: v for k, v in ev.items() if k != WALL_KEY}
    return json.dumps(ev, sort_keys=True, separators=(",", ":"))


class _Span:
    """Context manager emitting ONE event at exit, with the wall duration
    the tracer's clock measured segregated under the ``"w"`` key (no
    ``"w"`` when the tracer has no clock)."""

    __slots__ = ("tracer", "kind", "fields", "t0")

    def __init__(self, tracer: "Tracer", kind: str, fields: dict):
        self.tracer = tracer
        self.kind = kind
        self.fields = fields

    def __enter__(self) -> "_Span":
        clock = self.tracer.clock
        self.t0 = clock() if clock is not None else None
        return self

    def __exit__(self, *exc) -> bool:
        wall = None
        if self.t0 is not None:
            ms = (self.tracer.clock() - self.t0) * 1e3
            wall = {"ms": round(ms, 3)}
        self.tracer.event(self.kind, wall=wall, **self.fields)
        return False


class Tracer:
    """Bounded event tracer for one server (or one test harness).

    - ``ring`` holds the last N events for the flight recorder;
    - ``keep_all=True`` additionally retains the full stream in memory
      (the determinism tests read it back via ``logical_bytes``);
    - ``path`` streams every event to a JSONL file as it happens;
    - ``rotate_bytes`` caps each stream segment: when the active file
      passes the cap it is closed and the stream continues in
      ``<path>.1``, ``<path>.2``, ... (``segment_paths`` lists them in
      order) — a long loadgen/cluster run no longer grows ONE unbounded
      JSONL, and segments concatenate back to the identical stream
      (``obs.analyze.load_events`` accepts the segment list);
    - ``enabled=False`` turns every entry point into a cheap no-op
      (the overhead-probe baseline arm);
    - ``clock`` is the caller's wall clock (``Callable[[], float]``, in
      seconds) that ``span`` measures with; None = spans carry no wall.

    Events are dicts with a three-field envelope — ``i`` (monotonic
    sequence), ``t`` (logical tick, set via ``set_tick``), ``k`` (kind)
    — plus the kind's logical fields and an optional ``"w"`` wall dict.
    """

    def __init__(self, *, enabled: bool = True, ring: int = 512,
                 keep_all: bool = False, path: Optional[str] = None,
                 rotate_bytes: Optional[int] = None,
                 validate: bool = True,
                 clock: Optional[Callable[[], float]] = None):
        from collections import deque

        self.enabled = enabled
        self.clock = clock
        self.ring = deque(maxlen=max(1, ring))
        self.keep_all = keep_all
        self.events: List[dict] = []
        self.validate = validate
        self.seq = 0
        self.tick = 0
        # Line-buffered: the events adjacent to a crash are exactly the
        # ones a flight recorder exists to preserve — they must be on
        # disk, not in a stdio buffer, when the process dies.
        self._path = path
        self.rotate_bytes = rotate_bytes
        self.segment_paths: List[str] = []
        self._segment_bytes = 0
        self._file = None
        if enabled and path:
            self._file = open(path, "w", buffering=1)
            self.segment_paths.append(path)
        self._subscribers: List[Callable[[dict], None]] = []
        if enabled:
            self.event("trace.header", schema=TRACE_SCHEMA_VERSION)

    # -- emit ----------------------------------------------------------------

    def set_tick(self, tick: int) -> None:
        self.tick = tick

    def subscribe(self, fn: Callable[[dict], None]) -> None:
        """Register a callback invoked on every event (the flight
        recorder taps ``apply`` events through this)."""
        self._subscribers.append(fn)

    def event(self, kind: str, wall: Optional[dict] = None,
              **fields) -> Optional[dict]:
        if not self.enabled:
            return None
        ev = {"i": self.seq, "t": self.tick, "k": kind}
        ev.update(fields)
        if wall:
            ev[WALL_KEY] = wall
        if self.validate:
            validate_event(ev)
        self.seq += 1
        self.ring.append(ev)
        if self.keep_all:
            self.events.append(ev)
        if self._file is not None:
            line = event_line(ev) + "\n"
            self._file.write(line)
            self._segment_bytes += len(line)
            # Size-capped segment rollover: rotation happens BETWEEN
            # events (a line is never split), so the concatenated
            # segments are byte-identical to an unrotated stream.
            if (self.rotate_bytes
                    and self._segment_bytes >= self.rotate_bytes):
                self._file.close()
                seg = f"{self._path}.{len(self.segment_paths)}"
                self._file = open(seg, "w", buffering=1)
                self.segment_paths.append(seg)
                self._segment_bytes = 0
        for fn in self._subscribers:
            fn(ev)
        return ev

    def span(self, kind: str, **fields) -> _Span:
        """``with tracer.span("tick.barrier", shard=0): ...`` — one
        event at exit, wall duration under ``"w"``."""
        return _Span(self, kind, fields)

    # -- read back -----------------------------------------------------------

    def last(self, n: int, doc: Optional[str] = None,
             shard: Optional[int] = None) -> List[dict]:
        """Last ``n`` ring events, newest last; ``doc``/``shard`` filter
        to events touching that doc or shard (envelope-level events with
        neither field always pass — they are context)."""
        out = []
        for ev in reversed(self.ring):
            if doc is not None and "doc" in ev and ev["doc"] != doc:
                continue
            if shard is not None and "shard" in ev and ev["shard"] != shard:
                continue
            out.append(ev)
            if len(out) >= n:
                break
        out.reverse()
        return out

    def logical_bytes(self) -> bytes:
        """The retained stream's logical projection as JSONL bytes —
        requires ``keep_all=True``; this is what two same-seed runs must
        agree on byte for byte."""
        assert self.keep_all, "logical_bytes needs Tracer(keep_all=True)"
        return ("\n".join(event_line(ev, logical_only=True)
                          for ev in self.events) + "\n").encode()

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
