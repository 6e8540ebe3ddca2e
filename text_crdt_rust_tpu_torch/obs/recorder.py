"""Flight recorder + divergence post-mortems (counterpart of
``text_crdt_rust_tpu/obs/recorder.py``).

Bit-identity oracles only say *that* state diverged — finding
*when* meant re-running the seed under print statements.  The flight
recorder closes that gap: it rides along every run at ring-buffer cost,
and on any typed failure or twin/lane mismatch dumps a post-mortem
bundle — a versioned JSON artifact carrying:

- the last-N trace events (filtered to the offending doc/shard when
  one is named) from the tracer's bounded ring;
- a full metrics snapshot (``Counters``/``MetricsRegistry`` summary);
- ``doc_stats`` of the offending doc's oracle when it is resident;
- the offending doc's last compiled-step metadata (tick, step counts,
  bucket) — what the device was actually asked to run;
- the CRCs + lengths of the most recent wire frames (what came off
  the network right before the failure);
- for divergence failures, a **first-divergence walk**: the two states
  compared item by item in document order, the first differing item
  named as peer-portable ``(agent, seq)``, and — joined against the
  recorder's per-doc apply log — the exact logical tick and trace
  event that introduced it; with per-op provenance on (obs/flow), the
  diverged span's FULL flow path (emit -> frame -> buffer -> ready ->
  apply) rides along so the bundle names the op's whole journey.

Trigger classes (``REASONS``): ``codec`` (`net/codec.CodecError`),
``causal-gap`` (`net/session.CausalGapError`), ``checkpoint``
(`utils/checkpoint.CheckpointError`), ``degrade`` (lane-capacity
overflow), ``divergence`` (digest mismatch or twin/lane bit-identity
mismatch), ``journal`` (`serve/journal.JournalError` — a refused
journal segment at recovery), ``pipeline-flush`` (the emergency
in-flight sync while a tick unwinds failed too).  Bundles are BOUNDED: the first failure of each reason
class dumps, later ones are counted (``bundles_suppressed``) — a 10%
fault-injection loadgen run must not write thousands of bundles.
"""
from __future__ import annotations

import itertools
import json
import os
from collections import deque
from typing import Dict, List, Optional, Tuple

BUNDLE_SCHEMA_VERSION = 1

REASON_CODEC = "codec"
REASON_CAUSAL_GAP = "causal-gap"
REASON_CHECKPOINT = "checkpoint"
REASON_DEGRADE = "degrade"
REASON_DIVERGENCE = "divergence"
REASON_JOURNAL = "journal"
REASON_PIPELINE_FLUSH = "pipeline-flush"
REASONS = (REASON_CODEC, REASON_CAUSAL_GAP, REASON_CHECKPOINT,
           REASON_DEGRADE, REASON_DIVERGENCE, REASON_JOURNAL,
           REASON_PIPELINE_FLUSH)

# Per-process recorder ids: several servers (or a flat-twin pair in one
# probe) may share one out_dir — e.g. the conftest TCR_TRACE_DIR
# workflow — and their bundles must not overwrite each other.  The pid
# disambiguates across processes sharing the dir.
_RECORDER_IDS = itertools.count()


def item_key(doc, i: int) -> Tuple[str, int, int, bool]:
    """Item ``i`` of an oracle as a peer-portable comparison key:
    (author agent name, seq, codepoint, deleted) — local orders never
    appear, so the walk is valid across peers that interleaved the same
    history differently (the ``state_digest`` argument)."""
    agent, seq = doc.loc_of_order(int(doc.order[i]))
    return (doc.get_agent_name(agent), seq, int(doc.chars[i]),
            bool(doc.deleted[i]))


def first_divergence(a, b) -> Optional[dict]:
    """Walk two oracles in document order; the first differing item (or
    the length difference) as a dict, ``None`` when bit-identical. Runs
    only on the failure path — O(n) python is fine there."""
    n = min(a.n, b.n)
    for i in range(n):
        ka, kb = item_key(a, i), item_key(b, i)
        if ka != kb:
            return {"item_index": i,
                    "server": {"agent": ka[0], "seq": ka[1],
                               "char": ka[2], "deleted": ka[3]},
                    "twin": {"agent": kb[0], "seq": kb[1],
                             "char": kb[2], "deleted": kb[3]},
                    # The item whose introduction diverged: the server
                    # side's author id is what joins the apply log.
                    "agent": ka[0], "seq": ka[1]}
    if a.n != b.n:
        longer, which = (a, "server") if a.n > b.n else (b, "twin")
        ka = item_key(longer, n)
        return {"item_index": n, "only_in": which,
                "agent": ka[0], "seq": ka[1],
                which: {"agent": ka[0], "seq": ka[1],
                        "char": ka[2], "deleted": ka[3]}}
    return None


class FlightRecorder:
    """Bounded post-mortem recorder for one server.

    Subscribes to the tracer to maintain a per-doc apply log (bounded
    deque of ``(agent, seq, n, tick, event_seq)``) and a bounded recent
    wire-frame log; on a trigger, writes one JSON bundle per reason
    class into ``out_dir`` and counts the rest.
    """

    def __init__(self, tracer, counters, out_dir: str, *,
                 ring_events: int = 256, apply_ring: int = 256,
                 frame_ring: int = 64, max_bundles_per_reason: int = 1):
        self.tracer = tracer
        self.counters = counters
        self.out_dir = out_dir
        self.ring_events = ring_events
        self.apply_ring = apply_ring
        self.max_bundles_per_reason = max_bundles_per_reason
        self.bundle_paths: List[str] = []
        self._dumped: Dict[str, int] = {}
        self._applies: Dict[str, deque] = {}
        # Per-doc ring of flow.* provenance events: the
        # divergence bundle joins the diverged span's FULL path —
        # emit/frame/buffer/ready/apply — not just its apply record.
        self._flows: Dict[str, deque] = {}
        self._frames: deque = deque(maxlen=max(1, frame_ring))
        # Last compiled-step metadata per doc (the batcher records it
        # right before the device pass).
        self._streams: Dict[str, dict] = {}
        self._n = 0
        self._tag = f"{os.getpid()}_{next(_RECORDER_IDS)}"
        if tracer is not None:
            tracer.subscribe(self._on_event)

    # -- feeds ---------------------------------------------------------------

    def _on_event(self, ev: dict) -> None:
        kind = ev.get("k")
        if isinstance(kind, str) and kind.startswith("flow."):
            doc = ev.get("doc")
            ring = self._flows.get(doc)
            if ring is None:
                ring = self._flows[doc] = deque(maxlen=self.apply_ring)
            ring.append(ev)
            return
        if kind != "apply":
            return
        doc = ev["doc"]
        ring = self._applies.get(doc)
        if ring is None:
            ring = self._applies[doc] = deque(maxlen=self.apply_ring)
        ring.append((ev["agent"], ev["seq"], ev["n"], ev["t"], ev["i"]))

    def note_frame(self, doc_id: Optional[str], data: bytes) -> None:
        """Log one received wire frame's length + trailing CRC bytes
        (the codec's outer CRC32C) — cheap enough for every frame."""
        crc = data[-4:].hex() if len(data) >= 4 else data.hex()
        self._frames.append({"doc": doc_id, "len": len(data), "crc": crc})

    def record_stream(self, doc_id: str, meta: dict) -> None:
        """The doc's latest compiled tick stream metadata (one dict,
        overwritten per tick) — 'what was the device asked to run'."""
        self._streams[doc_id] = meta

    def find_apply(self, doc_id: str, agent: str,
                   seq: int) -> Optional[dict]:
        """The apply-log record whose (agent, seq..seq+n) span covers
        the given id — names the tick + trace event that introduced an
        item. ``None`` when it rotated out of the bounded log."""
        for a, s, n, tick, ev_seq in self._applies.get(doc_id, ()):
            if a == agent and s <= seq < s + max(n, 1):
                return {"agent": a, "seq": s, "n": n, "tick": tick,
                        "event": ev_seq}
        return None

    # -- triggers ------------------------------------------------------------

    def on_failure(self, reason: str, detail: str, *,
                   doc_id: Optional[str] = None,
                   shard: Optional[int] = None,
                   tick: Optional[int] = None,
                   oracle=None, extra: Optional[dict] = None
                   ) -> Optional[str]:
        """Dump a post-mortem bundle for one typed failure; returns the
        bundle path, or ``None`` when this reason class already hit its
        bundle budget (the suppression is counted)."""
        assert reason in REASONS, reason
        self.counters.incr(f"obs_failures_{reason.replace('-', '_')}")
        seen = self._dumped.get(reason, 0)
        if seen >= self.max_bundles_per_reason:
            self.counters.incr("bundles_suppressed")
            return None
        self._dumped[reason] = seen + 1
        bundle = self._bundle(reason, detail, doc_id=doc_id, shard=shard,
                              tick=tick, oracle=oracle, extra=extra)
        return self._write(bundle)

    def flow_path(self, doc_id: str, agent: str,
                  seq: int) -> List[dict]:
        """Every retained flow.* event whose span covers ``(agent,
        seq)`` for this doc, in emission order — the op's full journey
        (emit -> frame -> buffer/ready -> apply) as far as the bounded
        ring still holds it.  Local spans have no seq until apply, so
        a covering apply's ``lk`` pulls in the span's ordinal-keyed
        records (the emission, any invalid-position reject) too."""
        ring = list(self._flows.get(doc_id, ()))
        out = []
        lks = set()
        for ev in ring:
            if ev.get("agent") != agent or "seq" not in ev:
                continue
            s = int(ev["seq"])
            if s <= seq < s + max(int(ev.get("n", 1)), 1):
                out.append(ev)
                if "lk" in ev:
                    lks.add(ev["lk"])
        if lks:
            out.extend(ev for ev in ring
                       if "seq" not in ev and ev.get("lk") in lks
                       and ev.get("agent") == agent)
            out.sort(key=lambda ev: ev["i"])
        return out

    def on_divergence(self, doc_id: str, server_oracle, twin_oracle, *,
                      detail: str = "twin-check bit-identity mismatch",
                      tick: Optional[int] = None) -> Optional[str]:
        """The divergence post-mortem: first-divergence walk + apply-log
        join, then a bundle.  This is the artifact that answers *when*
        — the exact logical tick, doc, and event where the twin first
        diverged.  When per-op provenance was on (obs/flow), the bundle
        also carries the diverged span's FULL flow path — not just the
        apply that
        introduced the item, but its whole journey into the server."""
        fd = first_divergence(server_oracle, twin_oracle)
        extra = {"first_divergence": fd}
        if fd is not None:
            extra["apply_event"] = self.find_apply(doc_id, fd["agent"],
                                                   fd["seq"])
            extra["flow_path"] = self.flow_path(doc_id, fd["agent"],
                                                fd["seq"])
        return self.on_failure(REASON_DIVERGENCE, detail, doc_id=doc_id,
                               tick=tick, oracle=server_oracle,
                               extra=extra)

    # -- bundle assembly -----------------------------------------------------

    def _bundle(self, reason: str, detail: str, *, doc_id, shard, tick,
                oracle, extra) -> dict:
        bundle = {
            "schema_version": BUNDLE_SCHEMA_VERSION,
            "reason": reason,
            "detail": detail,
            "doc": doc_id,
            "shard": shard,
            "tick": (tick if tick is not None
                     else (self.tracer.tick if self.tracer else None)),
            "events": (self.tracer.last(self.ring_events, doc=doc_id,
                                        shard=shard)
                       if self.tracer is not None else []),
            "counters": self.counters.summary(),
            "recent_frames": list(self._frames),
            "compiled_step_meta": (self._streams.get(doc_id)
                                   if doc_id else None),
        }
        if oracle is not None:
            from ..utils.metrics import doc_stats

            try:
                bundle["doc_stats"] = doc_stats(oracle)
            except Exception as e:  # stats must never mask the failure
                bundle["doc_stats"] = {"error": f"{type(e).__name__}: {e}"}
        if extra:
            bundle.update(extra)
        return bundle

    def _write(self, bundle: dict) -> str:
        os.makedirs(self.out_dir, exist_ok=True)
        name = f"bundle_{self._tag}_{self._n:03d}_{bundle['reason']}.json"
        self._n += 1
        path = os.path.join(self.out_dir, name)
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
        self.bundle_paths.append(path)
        self.counters.incr("bundles_written")
        return path
