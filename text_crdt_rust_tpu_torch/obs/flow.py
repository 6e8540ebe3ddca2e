"""Per-op provenance spans + the conservation audit (counterpart of
``text_crdt_rust_tpu/obs/flow.py``).

The paper's whole job is tracking one character's identity
``(agent, seq)`` through every conversion, and YATA's convergence
contract is a *per-op* claim — yet tick-level observability stops at
tick granularity.  This module follows one op's journey end to
end on the logical tick axis:

    emitted -> framed -> admitted/rejected -> buffered/ready ->
    drained+fused -> applied (device or host) [-> survives evictions]

Every lifecycle event is a normal ``obs/trace`` event (``flow.*``
kinds), so flow streams inherit the tracer's discipline for free:
wall-clock segregation, same-seed byte-identity, segment rotation, the
analyze CLI.  Two properties then stop being debugging folklore and
become *gated invariants*:

- **conservation** — at end of run every emitted op span is in exactly
  one terminal state: applied (device or host), rejected with a typed
  reason, or in-flight at shutdown with a NAMED location (network /
  admission / causal-buffer / event-queue).  ``audit_spans`` returns
  findings for anything else: a leaked span, a double-applied span, a
  phantom apply (applied but never emitted), or an evict->restore
  conservation mismatch (a restore replay that re-applied history would
  inflate the doc's item/order counts — the checkpoint chain replay
  must be invisible to the per-op ledger);
- **op age at apply** — ticks from emission to apply, per doc-popularity
  band and per fault class (local / clean / gap-stalled / redelivered),
  all exact logical-tick numbers a cost-ledger cell can pin — the
  before/after latency contract the pipelined tick needs, no
  wall clock involved.

Sampling (``ServeConfig.flow_sample_mod``) is **per agent name**
(``crc32(agent) % mod == 0``), not per event: a sampled agent's spans
are tracked *end to end*, so the audit is valid on the sampled subset
at any mod — trims, merged re-exports and re-deliveries all land on the
same side of the sampling line.  ``mod=1`` tracks everything (the audit
and ledger runs); the serve default keeps the "<5% overhead" bar.

Span identity: remote spans are the txn id ``(agent, seq)`` plus item
count (covering seqs ``[seq, seq+n)``); interval arithmetic — not exact
id matching — absorbs the causal buffer's prefix trims and the loadgen's
RLE-merged re-exports (two emits may overlap; the audit unions them).
Local edits have no seq until the oracle applies them, so their
emission is keyed by a per-doc ordinal ``lk`` which the eventual
``flow.apply``/``flow.reject`` closes, realizing the ``(agent, seq)``
span.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

from ..common import RemoteTxn, txn_len
from ..utils.metrics import percentiles

#: The flow lifecycle stages, in journey order (location naming).
FLOW_STAGES = ("emit", "frame", "reject", "buffer", "ready", "apply")

#: Last-stage -> human location for in-flight spans.
STAGE_LOCATION = {
    "emit": "network (emitted, never framed)",
    "frame": "admission (framed, never released)",
    "buffer": "causal-buffer",
    "ready": "event-queue",
    "reject": "rejected (awaiting redelivery)",
}

#: Doc-popularity bands over emitted volume: hottest 10% / next 30% /
#: the Zipf tail.  Computed from the trace itself so the analyzer needs
#: no loadgen-side popularity table.
BANDS = (("hot", 0.10), ("warm", 0.30), ("cold", 1.0))

#: Fault classes an applied span can have experienced, judged purely
#: from its flow shape: ``local`` (no wire), ``clean`` (framed once,
#: never buffered), ``gap-stalled`` (held in the causal buffer),
#: ``redelivered`` (framed more than once — dup fault or pull refetch).
FAULT_CLASSES = ("local", "clean", "gap-stalled", "redelivered")


def agent_sampled(agent: str, mod: int) -> bool:
    """The ONE sampling predicate every emission point shares: stable
    across runs and platforms (crc32 of the utf-8 name), and per-agent
    so a sampled span is complete end to end."""
    if mod <= 0:
        return False
    if mod == 1:
        return True
    return zlib.crc32(agent.encode("utf-8")) % mod == 0


class FlowTracker:
    """Emission helper owned by one ``DocServer``: stamps ``flow.*``
    events through the server's tracer and retains their logical dicts
    (``records``) so the in-process audit/report needs no trace file.
    Every entry point is a cheap no-op when disabled (``mod=0`` or
    tracer off); sampling decisions are cached per agent name.

    Retention is BOUNDED (``max_records``, the tracer's ring discipline —
    the tracer keeps 512 events, not the run): past the cap the tracker
    keeps *emitting* trace events but stops retaining them, and
    ``report()`` refuses to claim a clean audit over a truncated
    ledger (a named ``records-truncated`` finding).  For runs that
    outgrow the cap, stream the trace to disk and audit offline via
    ``analyze.py flow`` — the archival path."""

    def __init__(self, tracer, sample_mod: int = 1,
                 max_records: int = 1_000_000):
        self.tracer = tracer
        self.sample_mod = max(0, int(sample_mod))
        self.enabled = bool(tracer is not None and tracer.enabled
                            and self.sample_mod > 0)
        self.records: List[dict] = []
        self.max_records = max_records
        self.truncated = False
        self._sample_cache: Dict[str, bool] = {}
        self._local_no: Dict[str, int] = {}
        if self.enabled:
            # Tap the residency conservation checkpoints (evict/restore
            # item+order counts) off the tracer stream so the
            # in-process audit can pair them — the offline path reads
            # the same events from the trace file.
            tracer.subscribe(self._tap)

    def _tap(self, ev: dict) -> None:
        if ev.get("k") in ("residency.evict", "residency.restore") \
                and "n" in ev:
            self._retain(ev)

    def _retain(self, ev: dict) -> None:
        if len(self.records) < self.max_records:
            self.records.append(ev)
        else:
            self.truncated = True

    # -- sampling ------------------------------------------------------------

    def sampled(self, agent: str) -> bool:
        if not self.enabled:
            return False
        hit = self._sample_cache.get(agent)
        if hit is None:
            hit = self._sample_cache[agent] = agent_sampled(
                agent, self.sample_mod)
        return hit

    def _ev(self, kind: str, **fields) -> None:
        ev = self.tracer.event(kind, **fields)
        if ev is not None:
            self._retain(ev)

    # -- lifecycle emission points ------------------------------------------

    def emit_txns(self, doc_id: str, txns: List[RemoteTxn]) -> None:
        """Remote-span emission: the loadgen (or any upstream peer
        harness) records freshly generated txns the moment they exist —
        before the fault channel gets a chance to eat them."""
        if not self.enabled:
            return
        for t in txns:
            if self.sampled(t.id.agent):
                self._ev("flow.emit", doc=doc_id, agent=t.id.agent,
                         seq=t.id.seq, n=txn_len(t))

    def emit_local(self, doc_id: str, agent: str, n: int) -> Optional[int]:
        """Local-edit emission at submit time; returns the per-doc
        ordinal ``lk`` that keys the span until the oracle realizes its
        ``(agent, seq)`` at apply (or ``None`` when unsampled)."""
        if not self.sampled(agent):
            return None
        lk = self._local_no.get(doc_id, 0)
        self._local_no[doc_id] = lk + 1
        self._ev("flow.emit", doc=doc_id, agent=agent, n=n, lk=lk)
        return lk

    def framed(self, doc_id: str, txns: List[RemoteTxn],
               frame: int) -> None:
        """Decoded off the wire inside frame ``frame`` (the frame's
        stored CRC32C — content-derived, so same-seed runs agree)."""
        if not self.enabled:
            return
        for t in txns:
            if self.sampled(t.id.agent):
                self._ev("flow.frame", doc=doc_id, agent=t.id.agent,
                         seq=t.id.seq, n=txn_len(t), frame=frame)

    def rejected(self, doc_id: str, agent: str, reason: str,
                 seq: Optional[int] = None, n: Optional[int] = None,
                 lk: Optional[int] = None) -> None:
        if not self.sampled(agent):
            return
        fields = {"doc": doc_id, "agent": agent, "reason": reason}
        if lk is not None:
            fields["lk"] = lk
        if seq is not None:
            fields["seq"] = seq
            fields["n"] = n if n is not None else 1
        self._ev("flow.reject", **fields)

    def buffered(self, doc_id: str, txn: RemoteTxn,
                 state: str = "held") -> None:
        """Held in the causal buffer (``held``) or pressure-evicted from
        it (``drop`` — the gap stays visible to ``missing()``; the span
        comes back via re-request)."""
        if self.sampled(txn.id.agent):
            self._ev("flow.buffer", doc=doc_id, agent=txn.id.agent,
                     seq=txn.id.seq, n=txn_len(txn), state=state)

    def ready(self, doc_id: str, txn: RemoteTxn) -> None:
        """Causally released into the doc's FIFO event queue."""
        if self.sampled(txn.id.agent):
            self._ev("flow.ready", doc=doc_id, agent=txn.id.agent,
                     seq=txn.id.seq, n=txn_len(txn))

    def applied(self, doc_id: str, agent: str, seq: int, n: int,
                mode: str, lk: Optional[int] = None,
                fstep: Optional[int] = None,
                fn_steps: Optional[int] = None) -> None:
        """Terminal apply: ``mode`` is ``device`` (the span rode a lane
        batch this tick) or ``host`` (host-only / degraded oracle
        apply).  ``fstep`` names the fused super-step that absorbed the
        span's first compiled row, ``fn_steps`` how many fused output
        steps its rows span."""
        if not self.sampled(agent):
            return
        fields = {"doc": doc_id, "agent": agent, "seq": seq, "n": n,
                  "mode": mode}
        if lk is not None:
            fields["lk"] = lk
        if fstep is not None:
            fields["fstep"] = fstep
            fields["fn"] = fn_steps if fn_steps is not None else 1
        self._ev("flow.apply", **fields)

    # -- in-process report ---------------------------------------------------

    def report(self, expect_terminal: bool = False) -> dict:
        out = flow_report(self.records, expect_terminal=expect_terminal)
        out["sample_mod"] = self.sample_mod
        if self.truncated:
            # A truncated ledger cannot certify conservation — refuse
            # the claim and point at the offline (trace-file) path.
            out["audit_ok"] = False
            out["findings"] = [{
                "kind": "records-truncated", "doc": None,
                "detail": f"in-process flow retention hit max_records="
                          f"{self.max_records}; audit the streamed "
                          f"trace with analyze.py flow --audit instead",
            }] + out["findings"][:7]
        return out


# -- interval arithmetic ------------------------------------------------------


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Union of half-open [start, end) intervals, sorted."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _subtract(a: List[Tuple[int, int]],
              b: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """``a`` minus ``b``; both merged-sorted."""
    out: List[Tuple[int, int]] = []
    bi = 0
    for s, e in a:
        cur = s
        while bi < len(b) and b[bi][1] <= cur:
            bi += 1
        j = bi
        while cur < e:
            if j >= len(b) or b[j][0] >= e:
                out.append((cur, e))
                break
            bs, be = b[j]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            j += 1
    return out


def _covered(intervals: List[Tuple[int, int]], s: int, e: int) -> bool:
    return not _subtract([(s, e)], intervals)


def _overlap_pairs(spans: List[Tuple[int, int, int]]
                   ) -> List[Tuple[int, int]]:
    """Overlapping [start, end) ranges among a MULTISET of spans
    (tagged with their record index) — the double-apply detector.
    Returns (record_index_a, record_index_b) pairs."""
    out = []
    ordered = sorted(spans)
    if not ordered:
        return out
    run_end, run_idx = ordered[0][1], ordered[0][2]
    for cs, ce, cidx in ordered[1:]:
        if cs < run_end:
            out.append((run_idx, cidx))
        if ce > run_end:
            run_end, run_idx = ce, cidx
    return out


# -- span table ---------------------------------------------------------------


class _AgentFlow:
    """All flow records for one (doc, agent) pair."""

    __slots__ = ("emits", "frames", "buffers", "readys", "rejects",
                 "applies")

    def __init__(self):
        self.emits: List[dict] = []
        self.frames: List[dict] = []
        self.buffers: List[dict] = []
        self.readys: List[dict] = []
        self.rejects: List[dict] = []
        self.applies: List[dict] = []


class FlowTable:
    """Flow events regrouped per (doc, agent) + per local ordinal +
    per-doc residency conservation checkpoints."""

    def __init__(self):
        self.agents: Dict[Tuple[str, str], _AgentFlow] = {}
        # (doc, lk) -> {"emit": ev, "reject": ev|None, "applies": [ev]}
        self.locals: Dict[Tuple[str, int], dict] = {}
        # doc -> ordered [(kind, n, orders)] residency checkpoints
        self.residency: Dict[str, List[Tuple[str, int, int]]] = {}

    def agent(self, doc: str, agent: str) -> _AgentFlow:
        key = (doc, agent)
        af = self.agents.get(key)
        if af is None:
            af = self.agents[key] = _AgentFlow()
        return af


def spans_from_events(events) -> FlowTable:
    """Build the span table from any event iterable — the tracker's
    retained records, a loaded JSONL stream, or rotated segments
    concatenated by ``analyze.load_events`` (a span whose lifecycle
    straddles a rotation boundary reassembles here)."""
    table = FlowTable()
    for ev in events:
        k = ev.get("k", "")
        if k.startswith("flow."):
            stage = k[len("flow."):]
            doc = ev["doc"]
            lk = ev.get("lk")
            if lk is not None:
                slot = table.locals.setdefault((doc, lk), {
                    "emit": None, "reject": None, "applies": []})
                if stage == "emit":
                    slot["emit"] = ev
                elif stage == "reject":
                    slot["reject"] = ev
                elif stage == "apply":
                    slot["applies"].append(ev)
                    table.agent(doc, ev["agent"]).applies.append(ev)
                continue
            af = table.agent(doc, ev["agent"])
            if stage == "emit":
                af.emits.append(ev)
            elif stage == "frame":
                af.frames.append(ev)
            elif stage == "buffer":
                af.buffers.append(ev)
            elif stage == "ready":
                af.readys.append(ev)
            elif stage == "reject":
                af.rejects.append(ev)
            elif stage == "apply":
                af.applies.append(ev)
        elif k in ("residency.evict", "residency.restore") \
                and "n" in ev and "error" not in ev:
            table.residency.setdefault(ev["doc"], []).append(
                (k.split(".")[1], int(ev["n"]), int(ev["orders"])))
    return table


def _span(ev: dict) -> Tuple[int, int]:
    return int(ev["seq"]), int(ev["seq"]) + max(int(ev.get("n", 1)), 1)


def _last_stage(af: _AgentFlow, s: int, e: int) -> str:
    """The journey-latest stage any record overlapping [s, e) reached —
    the named location of an in-flight span."""
    best = "emit"
    order = {st: i for i, st in enumerate(FLOW_STAGES)}
    for stage, recs in (("frame", af.frames), ("reject", af.rejects),
                        ("buffer", af.buffers), ("ready", af.readys)):
        for ev in recs:
            rs, re_ = _span(ev)
            if rs < e and re_ > s and order[stage] > order[best]:
                best = stage
    return best


# -- the audit ----------------------------------------------------------------


def audit_spans(table: FlowTable,
                expect_terminal: bool = True) -> List[dict]:
    """Conservation findings, worst first.  Empty list = every tracked
    span is terminally accounted: applied exactly once (interval-wise),
    rejected with a reason, or — when ``expect_terminal`` is False —
    in-flight at a named location.  Finding kinds:

    - ``duplicate-apply``: two apply records overlap in seq space for
      one (doc, agent) — the must-never-happen YATA violation;
    - ``phantom-apply``: applied seqs nothing ever emitted;
    - ``leak``: an emitted range with no terminal disposition (named
      last-known location; only with ``expect_terminal``);
    - ``local-leak`` / ``local-duplicate``: the lk-keyed local analogs;
    - ``evict-restore-mismatch``: a restore whose (items, orders) do
      not equal the preceding evict's — replay re-application or state
      loss across the checkpoint boundary.
    """
    findings: List[dict] = []

    def finding(kind: str, doc: str, agent: Optional[str], detail: str,
                seq: Optional[int] = None, end: Optional[int] = None):
        f = {"kind": kind, "doc": doc, "detail": detail}
        if agent is not None:
            f["agent"] = agent
        if seq is not None:
            f["seq"] = seq
            f["end"] = end
        findings.append(f)

    dups: List[dict] = []
    phantoms: List[dict] = []
    leaks: List[dict] = []
    for (doc, agent), af in sorted(table.agents.items()):
        applies = [(*_span(ev), i) for i, ev in enumerate(af.applies)]
        for ia, ib in _overlap_pairs(applies):
            ea, eb = af.applies[ia], af.applies[ib]
            s = max(_span(ea)[0], _span(eb)[0])
            e = min(_span(ea)[1], _span(eb)[1])
            dups.append({
                "kind": "duplicate-apply", "doc": doc, "agent": agent,
                "seq": s, "end": e,
                "detail": f"span ({agent!r}, {s}..{e}) applied twice: "
                          f"tick {ea['t']} ({ea['mode']}) and tick "
                          f"{eb['t']} ({eb['mode']})"})
        emitted = _merge([_span(ev) for ev in af.emits]
                         + [_span(ev) for ev in af.applies
                            if ev.get("lk") is not None])
        applied = _merge([_span(ev) for ev in af.applies])
        for s, e in _subtract(applied, emitted):
            phantoms.append({
                "kind": "phantom-apply", "doc": doc, "agent": agent,
                "seq": s, "end": e,
                "detail": f"span ({agent!r}, {s}..{e}) applied but "
                          f"never emitted"})
        rejected = _merge([_span(ev) for ev in af.rejects
                           if "seq" in ev])
        open_ranges = _subtract(_subtract(emitted, applied), rejected)
        if expect_terminal:
            for s, e in open_ranges:
                loc = STAGE_LOCATION[_last_stage(af, s, e)]
                leaks.append({
                    "kind": "leak", "doc": doc, "agent": agent,
                    "seq": s, "end": e,
                    "detail": f"span ({agent!r}, {s}..{e}) leaked: "
                              f"last seen at {loc}"})

    for (doc, lk), slot in sorted(table.locals.items()):
        if len(slot["applies"]) > 1:
            ev = slot["applies"][1]
            finding("local-duplicate", doc, ev.get("agent"),
                    f"local edit lk={lk} applied "
                    f"{len(slot['applies'])} times")
        elif not slot["applies"] and slot["reject"] is None \
                and expect_terminal:
            em = slot["emit"] or {}
            finding("local-leak", doc, em.get("agent"),
                    f"local edit lk={lk} (agent {em.get('agent')!r}, "
                    f"{em.get('n')} items) leaked: submitted at tick "
                    f"{em.get('t')}, never applied or rejected")

    for doc, steps in sorted(table.residency.items()):
        last_evict: Optional[Tuple[int, int]] = None
        for kind, n, orders in steps:
            if kind == "evict":
                last_evict = (n, orders)
            elif kind == "restore" and last_evict is not None:
                if (n, orders) != last_evict:
                    finding("evict-restore-mismatch", doc, None,
                            f"doc {doc!r} restored with {n} items / "
                            f"{orders} orders but was evicted with "
                            f"{last_evict[0]} items / {last_evict[1]} "
                            f"orders — the checkpoint replay must "
                            f"re-create state, never re-apply it")
                last_evict = None
    return dups + phantoms + leaks + findings


# -- the crash-boundary audit -------------------------------------------------


def audit_crash_spans(pre_events, post_events,
                      expect_terminal: bool = False) -> dict:
    """Conservation audit ACROSS a crash/recovery boundary.

    ``pre_events`` is the crashed process's flow ledger, ``post_events``
    the recovered one's.  Recovery re-executes the journal, so a span
    applied before the crash applies again in the new process — that is
    *replayed*, not a duplicate; the plain ``audit_spans`` semantics
    would misread the join.  The crash-aware invariants:

    - ``crash-leak``: a span applied before the crash with no covering
      apply after recovery — the journal lost it (this is the finding
      the journal-record-drop injection proves loud, BEFORE resumed
      anti-entropy can quietly heal the hole);
    - ``duplicate-apply`` / ``local-duplicate``: within the recovered
      process only (replay must re-apply exactly once);
    - ``phantom-apply``: applied after recovery yet emitted in neither
      epoch;
    - ``leak`` (only with ``expect_terminal``, i.e. after the resumed
      run fully drains): an emitted span with no terminal disposition
      in the joined ledger;
    - ``crash-local-leak``: a pre-crash local edit whose ordinal the
      replay never re-submitted (the deterministic re-execution assigns
      the same per-doc ``lk`` order, so the keys join exactly).

    Returns ``{"audit_ok", "findings", "replayed_spans",
    "replayed_locals"}``."""
    pre = spans_from_events(pre_events)
    post = spans_from_events(post_events)
    findings: List[dict] = []
    replayed = 0
    empty = _AgentFlow()
    for key in sorted(set(pre.agents) | set(post.agents)):
        doc, agent = key
        af_pre = pre.agents.get(key, empty)
        af_post = post.agents.get(key, empty)
        applied_pre = _merge([_span(ev) for ev in af_pre.applies])
        applied_post = _merge([_span(ev) for ev in af_post.applies])
        for s, e in applied_pre:
            if _covered(applied_post, s, e):
                replayed += 1
        for s, e in _subtract(applied_pre, applied_post):
            findings.append({
                "kind": "crash-leak", "doc": doc, "agent": agent,
                "seq": s, "end": e,
                "detail": f"span ({agent!r}, {s}..{e}) was applied "
                          f"before the crash but has no covering apply "
                          f"after recovery — journal replay lost it"})
        applies_post = [(*_span(ev), i)
                        for i, ev in enumerate(af_post.applies)]
        for ia, ib in _overlap_pairs(applies_post):
            ea, eb = af_post.applies[ia], af_post.applies[ib]
            s = max(_span(ea)[0], _span(eb)[0])
            e = min(_span(ea)[1], _span(eb)[1])
            findings.append({
                "kind": "duplicate-apply", "doc": doc, "agent": agent,
                "seq": s, "end": e,
                "detail": f"span ({agent!r}, {s}..{e}) applied twice "
                          f"inside the recovered process: tick "
                          f"{ea['t']} and tick {eb['t']}"})
        emitted = _merge(
            [_span(ev) for ev in af_pre.emits]
            + [_span(ev) for ev in af_post.emits]
            + [_span(ev) for ev in af_pre.applies
               if ev.get("lk") is not None]
            + [_span(ev) for ev in af_post.applies
               if ev.get("lk") is not None])
        for s, e in _subtract(applied_post, emitted):
            findings.append({
                "kind": "phantom-apply", "doc": doc, "agent": agent,
                "seq": s, "end": e,
                "detail": f"span ({agent!r}, {s}..{e}) applied after "
                          f"recovery but emitted in neither epoch"})
        if expect_terminal:
            rejected = _merge(
                [_span(ev) for ev in af_pre.rejects if "seq" in ev]
                + [_span(ev) for ev in af_post.rejects if "seq" in ev])
            open_ranges = _subtract(_subtract(emitted, applied_post),
                                    rejected)
            for s, e in open_ranges:
                loc = STAGE_LOCATION[_last_stage(af_post, s, e)]
                findings.append({
                    "kind": "leak", "doc": doc, "agent": agent,
                    "seq": s, "end": e,
                    "detail": f"span ({agent!r}, {s}..{e}) leaked "
                              f"across the crash boundary: last seen "
                              f"at {loc}"})

    replayed_locals = 0
    for (doc, lk), slot_pre in sorted(pre.locals.items()):
        slot_post = post.locals.get((doc, lk))
        pre_applied = bool(slot_pre["applies"])
        if slot_post is None:
            if pre_applied or expect_terminal:
                findings.append({
                    "kind": "crash-local-leak", "doc": doc,
                    "detail": f"local edit lk={lk} existed before the "
                              f"crash but replay never re-submitted "
                              f"it"})
            continue
        if pre_applied and slot_post["applies"]:
            replayed_locals += 1
        if pre_applied and not slot_post["applies"] \
                and slot_post["reject"] is None:
            findings.append({
                "kind": "crash-local-leak", "doc": doc,
                "detail": f"local edit lk={lk} was applied before the "
                          f"crash but is neither applied nor rejected "
                          f"after recovery"})
    for (doc, lk), slot_post in sorted(post.locals.items()):
        if len(slot_post["applies"]) > 1:
            findings.append({
                "kind": "local-duplicate", "doc": doc,
                "detail": f"local edit lk={lk} applied "
                          f"{len(slot_post['applies'])} times inside "
                          f"the recovered process"})
        elif (doc, lk) not in pre.locals and expect_terminal \
                and not slot_post["applies"] \
                and slot_post["reject"] is None:
            findings.append({
                "kind": "local-leak", "doc": doc,
                "detail": f"local edit lk={lk} submitted after "
                          f"recovery, never applied or rejected"})
    return {
        "audit_ok": not findings,
        "findings": findings[:16],
        "total_findings": len(findings),
        "replayed_spans": replayed,
        "replayed_locals": replayed_locals,
    }


# -- ages ---------------------------------------------------------------------


def _tick_stats(ages: List[int]) -> dict:
    """Exact logical-tick distribution stats — the repo's ONE
    nearest-rank percentile definition (``utils.metrics.percentiles``)
    cast back to the integers ticks are, so flow-age p99 can never
    silently mean something different from latency p99."""
    if not ages:
        return {"count": 0, "p50": 0, "p99": 0, "max": 0}
    pct = percentiles(ages, (50, 99))
    return {"count": len(ages), "p50": int(pct["p50"]),
            "p99": int(pct["p99"]), "max": max(ages)}


def _fault_class(af: _AgentFlow, ev: dict) -> str:
    if ev.get("lk") is not None:
        return "local"
    s, e = _span(ev)
    frames = sum(1 for f in af.frames
                 if _span(f)[0] < e and _span(f)[1] > s)
    if frames > 1:
        return "redelivered"
    held = any(_span(b)[0] < e and _span(b)[1] > s
               for b in af.buffers)
    return "gap-stalled" if held else "clean"


def age_stats(table: FlowTable) -> dict:
    """Op-age-at-apply (ticks from emission to apply) distributions:
    overall, per apply mode, per doc-popularity band (emitted-volume
    deciles computed from the trace itself), per fault class."""
    # Emission tick per (doc, agent, seq): earliest emit covering it.
    doc_volume: Dict[str, int] = {}
    ages: List[int] = []
    by_mode: Dict[str, List[int]] = {"device": [], "host": []}
    by_class: Dict[str, List[int]] = {c: [] for c in FAULT_CLASSES}
    per_doc_ages: Dict[str, List[int]] = {}

    for (doc, agent), af in table.agents.items():
        vol = sum(max(int(ev.get("n", 1)), 1) for ev in af.emits)
        doc_volume[doc] = doc_volume.get(doc, 0) + vol
        emits = sorted((_span(ev)[0], _span(ev)[1], int(ev["t"]))
                       for ev in af.emits)
        for ev in af.applies:
            lk = ev.get("lk")
            s, _e = _span(ev)
            if lk is not None:
                slot = table.locals.get((doc, lk))
                emit_tick = (int(slot["emit"]["t"])
                             if slot and slot["emit"] else int(ev["t"]))
            else:
                emit_tick = None
                for es, ee, et in emits:
                    if es <= s < ee:
                        emit_tick = et
                        break
                if emit_tick is None:
                    continue  # phantom — the audit names it
            age = max(0, int(ev["t"]) - emit_tick)
            ages.append(age)
            by_mode.setdefault(ev.get("mode", "host"), []).append(age)
            by_class[_fault_class(af, ev)].append(age)
            per_doc_ages.setdefault(doc, []).append(age)
    for (doc, lk), slot in table.locals.items():
        em = slot["emit"]
        if em is not None:
            doc_volume[doc] = (doc_volume.get(doc, 0)
                               + max(int(em.get("n", 1)), 1))

    # Popularity bands from emitted volume (ties broken by doc id so
    # the banding is deterministic).
    ranked = sorted(doc_volume, key=lambda d: (-doc_volume[d], d))
    by_band: Dict[str, List[int]] = {name: [] for name, _ in BANDS}
    n_docs = len(ranked)
    for i, doc in enumerate(ranked):
        frac = (i + 1) / n_docs if n_docs else 1.0
        for name, ceil_frac in BANDS:
            if frac <= ceil_frac or name == BANDS[-1][0]:
                by_band[name].extend(per_doc_ages.get(doc, []))
                break
    return {
        "ages_ticks": _tick_stats(ages),
        "by_mode": {m: _tick_stats(v) for m, v in sorted(by_mode.items())},
        "by_band": {b: _tick_stats(by_band[b]) for b, _ in BANDS},
        "by_class": {c: _tick_stats(by_class[c]) for c in FAULT_CLASSES},
    }


# -- report -------------------------------------------------------------------


def flow_report(events, expect_terminal: bool = False) -> dict:
    """The full flow analysis over an event stream: span terminal-state
    census, audit findings, age distributions.  Pure (events in, dict
    out) so tests can golden it and the ledger can pin it."""
    table = spans_from_events(events)
    findings = audit_spans(table, expect_terminal=True)
    hard = [f for f in findings if f["kind"] != "leak"
            and f["kind"] != "local-leak"]
    leaks = [f for f in findings if f["kind"] in ("leak", "local-leak")]

    spans_emitted = spans_applied = spans_rejected = spans_inflight = 0
    applied_device = applied_host = 0
    flow_events = 0
    for (doc, agent), af in table.agents.items():
        flow_events += (len(af.emits) + len(af.frames) + len(af.buffers)
                        + len(af.readys) + len(af.rejects)
                        + len(af.applies))
        applied = _merge([_span(ev) for ev in af.applies])
        rejected = _merge([_span(ev) for ev in af.rejects
                           if "seq" in ev])
        for ev in af.emits:
            spans_emitted += 1
            s, e = _span(ev)
            if _covered(applied, s, e):
                spans_applied += 1
            elif _covered(_merge(applied + rejected), s, e):
                spans_rejected += 1
            else:
                spans_inflight += 1
        for ev in af.applies:
            if ev.get("mode") == "device":
                applied_device += 1
            else:
                applied_host += 1
    for (doc, lk), slot in table.locals.items():
        spans_emitted += 1
        # Count the lk-keyed emit and reject here; the span's applies
        # were already counted in the agent loop above (an lk apply is
        # indexed BOTH ways — by ordinal to close the emission and by
        # realized seq for the interval audit).
        flow_events += 1
        if slot["applies"]:
            spans_applied += 1
        elif slot["reject"] is not None:
            spans_rejected += 1
            flow_events += 1
        else:
            spans_inflight += 1

    audit_findings = findings if expect_terminal else hard
    out = {
        "flow_events": flow_events,
        "spans": {
            "emitted": spans_emitted,
            "applied": spans_applied,
            "rejected": spans_rejected,
            "in_flight": spans_inflight,
        },
        "applies": {"device": applied_device, "host": applied_host},
        "audit_ok": not audit_findings,
        "findings": audit_findings[:8],
        "leaks": len(leaks),
        "duplicates": sum(1 for f in hard
                          if "duplicate" in f["kind"]),
    }
    out.update(age_stats(table))
    return out
