"""Trace analytics over obs/ JSONL streams and flight-recorder bundles
(counterpart of ``text_crdt_rust_tpu/obs/analyze.py``).

The tracer (obs/trace.py) answers "record everything"; this module
answers the questions a regression hunt or a post-mortem actually asks:

- ``phases``     — per-tick phase critical-path breakdown (drain /
  fuse / capacity / device / barrier): where a tick's wall time went,
  aggregated and for the slowest ticks; ``--stall-budget`` appends the
  one-number headline (top phase by total wall, % of tick);
- ``overlap``    — host-vs-device occupancy: per tick, host wall
  (drain/fuse/capacity + residency checkpoint I/O) vs dispatch wall vs
  the barrier's idle gap, and the pipelined batcher's ``overlap_frac``
  (device-sync demand hidden under host work);
- ``hotdocs``    — apply-event volume by doc (who is hot);
- ``fuse``       — fusion efficiency by doc (steps in vs out);
- ``recompiles`` — the ``device.compile`` timeline (steady state must
  stop emitting these — a late entry IS the bug);
- ``diff``       — two-trace same-seed logical diff: strips the
  segregated wall fields and names the FIRST diverging event;
- ``chrome``     — Chrome trace-event export (Perfetto-loadable): the
  segregated wall-clock spans laid over the LOGICAL tick axis, plus
  flow-event arrows (``ph: "s"/"t"/"f"``) linking each sampled op's
  ``flow.*`` span across its tick phases;
- ``flow``       — per-op provenance census (obs/flow.py): span
  terminal states, op-age-at-apply distributions per popularity band
  and fault class; ``--audit`` turns conservation into an exit code —
  0 iff every emitted span is terminally accounted, else 1 naming the
  first leaked/double-applied span.

All analysis functions are pure (events in, dict out), with the JAX
package's operation order, so both give equal dicts on the same events;
walls come only from the trace's ``"w"`` fields, never from a clock.
The CLI renders text or ``--json``.  Inputs: trace JSONL files (several
= rotated segments, read in order) or flight-recorder bundle JSONs
(their ``events`` list is the same schema).

    python -m text_crdt_rust_tpu_torch.obs.analyze phases trace.jsonl
    python -m text_crdt_rust_tpu_torch.obs.analyze diff good.jsonl bad.jsonl
    python -m text_crdt_rust_tpu_torch.obs.analyze chrome trace.jsonl -o t.json
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import WALL_KEY

#: The serving-loop phases, in intra-tick order (the batcher emits them
#: in this sequence; ``tick.fuse`` rides inside the drain).
PHASES = ("tick.drain", "tick.fuse", "tick.capacity", "tick.device",
          "tick.barrier")

#: Logical-tick pitch of the chrome export, in trace microseconds: each
#: tick owns a fixed slot on the time axis, and measured wall spans are
#: drawn inside their tick's slot.
CHROME_TICK_US = 1000.0


def load_events(paths: Sequence[str]) -> List[dict]:
    """Events from one or more trace JSONL segments (rotated segments
    concatenate in argument order) or flight-recorder bundle JSONs."""
    events: List[dict] = []
    for path in paths:
        with open(path) as f:
            first = f.readline().strip()
            try:
                head = json.loads(first)
            except json.JSONDecodeError:
                # Not one-object-per-line: a pretty-printed flight-
                # recorder bundle (first line is just the brace).
                f.seek(0)
                events.extend(json.load(f).get("events", []))
                continue
            # A trace stream.  A crash-truncated final line is EXPECTED
            # post-mortem input (the tracer is line-buffered precisely
            # because processes die mid-run): keep the valid prefix and
            # say what was dropped instead of refusing the whole file.
            events.append(head)
            for lineno, line in enumerate(f, start=2):
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    print(f"{path}:{lineno}: truncated/corrupt line — "
                          f"keeping the {len(events)}-event prefix",
                          file=sys.stderr)
                    break
    return events


def logical(ev: dict) -> dict:
    """The event's logical projection (wall fields stripped)."""
    if WALL_KEY in ev:
        return {k: v for k, v in ev.items() if k != WALL_KEY}
    return ev


def _wall_ms(ev: dict) -> float:
    w = ev.get(WALL_KEY)
    return float(w.get("ms", 0.0)) if isinstance(w, dict) else 0.0


# ------------------------------------------------------------- analyses --


def phase_breakdown(events: Sequence[dict], slowest: int = 5) -> dict:
    """Per-tick phase critical path: wall ms per phase per tick (from
    the segregated ``"w"`` fields), aggregated per phase plus the
    ``slowest`` worst ticks in full."""
    per_tick: Dict[int, Dict[str, float]] = {}
    phase_events: Dict[str, int] = {p: 0 for p in PHASES}
    for ev in events:
        k = ev.get("k")
        if k not in PHASES:
            continue
        phase_events[k] += 1
        row = per_tick.setdefault(int(ev["t"]), {p: 0.0 for p in PHASES})
        row[k] += _wall_ms(ev)
    totals = {p: round(sum(r[p] for r in per_tick.values()), 3)
              for p in PHASES}
    wall_total = sum(totals.values())
    tick_rows = [
        {"tick": t, **{p: round(r[p], 3) for p in PHASES},
         "total_ms": round(sum(r.values()), 3)}
        for t, r in sorted(per_tick.items())
    ]
    return {
        "ticks": len(per_tick),
        "events": len(events),
        "wall_ms_total": round(wall_total, 3),
        "phases": {
            p: {
                "events": phase_events[p],
                "wall_ms": totals[p],
                "share_pct": round(totals[p] / wall_total * 100.0, 1)
                if wall_total else 0.0,
            }
            for p in PHASES
        },
        "slowest_ticks": sorted(tick_rows, key=lambda r: -r["total_ms"]
                                )[:slowest],
    }


def stall_budget(breakdown: dict) -> dict:
    """The one-number headline of a phase breakdown: the phase that
    owns the most measured wall and its share of the total, read
    before/after from any trace."""
    phases = breakdown["phases"]
    top = max(phases, key=lambda p: phases[p]["wall_ms"]) if phases \
        else None
    if top is None or not breakdown["wall_ms_total"]:
        return {"phase": None, "wall_ms": 0.0, "share_pct": 0.0}
    return {"phase": top, "wall_ms": phases[top]["wall_ms"],
            "share_pct": phases[top]["share_pct"]}


#: Host-phase walls the overlap report counts as work the pipelined
#: tick can hide an in-flight device step under; ``tick.device`` is the
#: dispatch (enqueue) wall, ``tick.barrier`` the residual sync stall.
OVERLAP_HOST_KINDS = ("tick.drain", "tick.fuse", "tick.capacity",
                      "residency.evict", "residency.restore")


def overlap_report(events: Sequence[dict], slowest: int = 5) -> dict:
    """Host-vs-device occupancy of the serving loop: per
    tick, measured host wall (drain/fuse/capacity + residency
    checkpoint I/O), dispatch wall, and the barrier's idle gap — the
    stall the staged sync still paid ("ms") vs the host window the
    in-flight device step got to hide under ("win", stamped by the
    pipelined batcher).  ``overlap_frac`` = win / (win + stall): 0 in
    the serial loop, -> 1 when host work fully hides device time."""
    per_tick: Dict[int, Dict[str, float]] = {}

    def row(t: int) -> Dict[str, float]:
        return per_tick.setdefault(int(t), {
            "host_ms": 0.0, "dispatch_ms": 0.0, "stall_ms": 0.0,
            "win_ms": 0.0})

    for ev in events:
        k = ev.get("k")
        if k in OVERLAP_HOST_KINDS:
            row(ev["t"])["host_ms"] += _wall_ms(ev)
        elif k == "tick.device":
            row(ev["t"])["dispatch_ms"] += _wall_ms(ev)
        elif k == "tick.barrier":
            r = row(ev["t"])
            r["stall_ms"] += _wall_ms(ev)
            w = ev.get(WALL_KEY)
            if isinstance(w, dict):
                r["win_ms"] += float(w.get("win", 0.0))
    from ..utils.metrics import percentiles

    tot = {key: round(sum(r[key] for r in per_tick.values()), 3)
           for key in ("host_ms", "dispatch_ms", "stall_ms", "win_ms")}
    busy = tot["host_ms"] + tot["dispatch_ms"] + tot["stall_ms"]
    hidden = tot["win_ms"] + tot["stall_ms"]
    stalls = [r["stall_ms"] for r in per_tick.values()]
    gap = {k: round(v, 3)
           for k, v in percentiles(stalls, (50, 99)).items()}
    gap["max"] = round(max(stalls), 3) if stalls else 0.0
    tick_rows = [{"tick": t, **{k: round(v, 3) for k, v in r.items()}}
                 for t, r in sorted(per_tick.items())]
    return {
        "ticks": len(per_tick),
        **tot,
        "overlap_frac": round(tot["win_ms"] / hidden, 4) if hidden
        else 0.0,
        "stall_share_pct": round(tot["stall_ms"] / busy * 100.0, 1)
        if busy else 0.0,
        "idle_gap_ms": gap,
        "worst_ticks": sorted(tick_rows,
                              key=lambda r: -r["stall_ms"])[:slowest],
    }


def hot_docs(events: Sequence[dict], top: int = 10) -> dict:
    """Apply-event volume by doc: events and item-ops, hottest first."""
    per: Dict[str, Dict[str, int]] = {}
    for ev in events:
        if ev.get("k") != "apply":
            continue
        row = per.setdefault(ev["doc"], {"events": 0, "items": 0})
        row["events"] += 1
        row["items"] += int(ev.get("n", 0))
    ranked = sorted(per.items(), key=lambda kv: (-kv[1]["items"], kv[0]))
    return {
        "docs": len(per),
        "apply_events": sum(r["events"] for r in per.values()),
        "item_ops": sum(r["items"] for r in per.values()),
        "top": [{"doc": d, **r} for d, r in ranked[:top]],
    }


def fusion_table(events: Sequence[dict], top: int = 10) -> dict:
    """Fusion efficiency by doc from ``tick.fuse`` events (emitted only
    when a stream actually fused): steps in vs out, rows saved."""
    per: Dict[str, Dict[str, int]] = {}
    for ev in events:
        if ev.get("k") != "tick.fuse":
            continue
        row = per.setdefault(ev["doc"], {"steps_in": 0, "steps_out": 0,
                                         "fused_ticks": 0})
        row["steps_in"] += int(ev["steps_in"])
        row["steps_out"] += int(ev["steps_out"])
        row["fused_ticks"] += 1
    for row in per.values():
        row["rows_saved"] = row["steps_in"] - row["steps_out"]
    ranked = sorted(per.items(),
                    key=lambda kv: (-kv[1]["rows_saved"], kv[0]))
    tin = sum(r["steps_in"] for r in per.values())
    tout = sum(r["steps_out"] for r in per.values())
    return {
        "fused_docs": len(per),
        "steps_in": tin,
        "steps_out": tout,
        "rows_saved": tin - tout,
        "reduction_x": round(tin / tout, 3) if tout else 1.0,
        "top": [{"doc": d, **r} for d, r in ranked[:top]],
    }


def recompile_timeline(events: Sequence[dict]) -> dict:
    """Every ``device.compile`` event in logical order.  Steady-state
    serving must stop emitting these: any entry past the warm-up ticks
    is a fixed-shape-contract violation worth a bisect."""
    compiles = [{"tick": int(ev["t"]), "i": int(ev["i"]),
                 "shard": ev["shard"], "bucket": ev["bucket"]}
                for ev in events if ev.get("k") == "device.compile"]
    last_tick = max((int(ev["t"]) for ev in events), default=0)
    return {
        "compiles": len(compiles),
        "last_compile_tick": compiles[-1]["tick"] if compiles else None,
        "run_last_tick": last_tick,
        "timeline": compiles,
    }


def trace_diff(a: Sequence[dict], b: Sequence[dict]) -> Optional[dict]:
    """Two-trace same-seed LOGICAL diff: the first event whose logical
    projection differs, with the changed field names — ``None`` when
    the logical streams are identical.  This is the cluster-debugging
    primitive: a good and a bad same-seed run localize to
    the first diverging *event*, no re-run needed."""
    n = min(len(a), len(b))
    for idx in range(n):
        ea, eb = logical(a[idx]), logical(b[idx])
        if ea != eb:
            fields = sorted(
                k for k in set(ea) | set(eb) if ea.get(k) != eb.get(k))
            return {"index": idx, "tick": ea.get("t", eb.get("t")),
                    "fields": fields, "a": ea, "b": eb}
    if len(a) != len(b):
        longer, which = (a, "a") if len(a) > len(b) else (b, "b")
        return {"index": n, "tick": logical(longer[n]).get("t"),
                "only_in": which, which: logical(longer[n]),
                "fields": ["<stream length>"],
                "lengths": {"a": len(a), "b": len(b)}}
    return None


def chrome_trace(events: Sequence[dict]) -> dict:
    """Chrome trace-event JSON (load in Perfetto / chrome://tracing):
    the logical tick axis becomes the time axis (one tick =
    ``CHROME_TICK_US`` trace-µs), measured wall spans render as
    duration events inside their tick's slot, and wall-less logical
    events render as instants — so the *causal* trace gets a scrubbable
    timeline without pretending host wall-clock ordered it."""
    out: List[dict] = []
    seen_pids = set()
    tick_idx: Dict[int, int] = {}
    # Flow arrows: each sampled op's flow.* events
    # chain into one Perfetto flow — ph "s" at the first lifecycle
    # event, "t" steps, "f" at the last — so one op's journey is
    # visible ACROSS tick slots alongside the per-tick phase track.
    # Span identity for the arrow id: (doc, agent, seq) for remote
    # spans, (doc, agent, lk) for local ones.
    flow_groups: Dict[tuple, List[int]] = {}
    for idx, ev in enumerate(events):
        if str(ev.get("k", "")).startswith("flow."):
            key = (ev.get("doc"), ev.get("agent"),
                   "lk", ev["lk"]) if "lk" in ev else \
                  (ev.get("doc"), ev.get("agent"), "seq", ev.get("seq"))
            flow_groups.setdefault(key, []).append(idx)
    flow_mark: Dict[int, Tuple[str, str]] = {}
    for key, idxs in flow_groups.items():
        if len(idxs) < 2:
            continue  # an arrow needs two ends
        fid = "/".join(str(p) for p in key)
        flow_mark[idxs[0]] = ("s", fid)
        for j in idxs[1:-1]:
            flow_mark[j] = ("t", fid)
        flow_mark[idxs[-1]] = ("f", fid)
    for idx, ev in enumerate(events):
        kind = ev.get("k", "?")
        pid = int(ev.get("shard", 0)) if isinstance(
            ev.get("shard"), int) else 0
        if pid not in seen_pids:
            seen_pids.add(pid)
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "args": {"name": f"shard {pid}"}})
        # Intra-tick ordering comes from a PER-TICK ordinal, clamped
        # inside the tick's slot — the global sequence `i` is unbounded
        # on long runs and would drift events into later ticks' slots.
        t = int(ev.get("t", 0))
        off = tick_idx.get(t, 0)
        tick_idx[t] = off + 1
        ts = t * CHROME_TICK_US + min(off * 1e-3,
                                      CHROME_TICK_US - 1.0)
        args = {k: v for k, v in ev.items() if k != WALL_KEY}
        wall = _wall_ms(ev)
        base = {"name": kind, "cat": kind.split(".")[0], "pid": pid,
                "tid": kind, "ts": round(ts, 3), "args": args}
        is_flow = kind.startswith("flow.")
        if wall > 0.0:
            out.append({**base, "ph": "X",
                        "dur": round(wall * 1e3, 3)})  # ms -> trace-µs
        elif is_flow:
            # Flow lifecycle events render as sub-µs duration slices,
            # not instants: the chrome trace format binds s/t/f flow
            # arrows to an ENCLOSING slice on the same pid/tid/ts — an
            # instant gives the importer nothing to attach to and the
            # arrows would be dropped.
            out.append({**base, "ph": "X", "dur": 0.5})
        else:
            out.append({**base, "ph": "i", "s": "t"})
        mark = flow_mark.get(idx)
        if mark is not None:
            ph, fid = mark
            arrow = {"name": "op-flow", "cat": "flow", "pid": pid,
                     "tid": kind, "ts": round(ts, 3), "ph": ph,
                     "id": fid}
            if ph == "f":
                arrow["bp"] = "e"  # bind to the enclosing slice's end
            out.append(arrow)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"tick_pitch_us": CHROME_TICK_US,
                          "note": "time axis is the LOGICAL tick axis; "
                                  "dur spans are segregated wall fields"}}


# ------------------------------------------------------------------ CLI --


def _print_phases(d: dict) -> None:
    print(f"{d['ticks']} ticks, {d['events']} events, "
          f"{d['wall_ms_total']:.1f} ms measured wall")
    print(f"{'phase':<16} {'events':>7} {'wall ms':>10} {'share':>7}")
    for p, row in d["phases"].items():
        print(f"{p:<16} {row['events']:>7} {row['wall_ms']:>10.3f} "
              f"{row['share_pct']:>6.1f}%")
    print("slowest ticks:")
    for r in d["slowest_ticks"]:
        parts = " ".join(f"{p.split('.')[1]}={r[p]:.2f}" for p in PHASES)
        print(f"  tick {r['tick']:>4}: {r['total_ms']:.3f} ms ({parts})")


def _print_table(rows: List[dict], cols: List[str]) -> None:
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in cols} if rows else {c: len(c) for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m text_crdt_rust_tpu_torch.obs.analyze",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("phases", "hotdocs", "fuse", "recompiles", "overlap"):
        p = sub.add_parser(name)
        p.add_argument("trace", nargs="+",
                       help="trace JSONL segment(s) or bundle JSON")
        p.add_argument("--json", action="store_true")
        p.add_argument("--top", type=int, default=10)
        if name == "phases":
            p.add_argument("--stall-budget", action="store_true",
                           help="append the one-line stall budget: the "
                                "phase owning the most wall and its "
                                "share of the measured total")
    p = sub.add_parser("diff")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--json", action="store_true")
    p = sub.add_parser("chrome")
    p.add_argument("trace", nargs="+")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default: stdout)")
    p = sub.add_parser("flow")
    p.add_argument("trace", nargs="+",
                   help="trace JSONL segment(s) or bundle JSON")
    p.add_argument("--json", action="store_true")
    p.add_argument("--audit", action="store_true",
                   help="conservation audit: exit 1 unless every "
                        "emitted span is terminally accounted "
                        "(applied once / rejected / named in-flight "
                        "location), naming the first finding")
    args = ap.parse_args(argv)

    if args.cmd == "diff":
        d = trace_diff(load_events([args.a]), load_events([args.b]))
        if args.json:
            print(json.dumps(d, indent=1, sort_keys=True))
        elif d is None:
            print("logical streams identical")
        else:
            print(f"first divergence at event {d['index']} "
                  f"(tick {d['tick']}): fields {d['fields']}")
            for side in ("a", "b"):
                if side in d:
                    print(f"  {side}: {json.dumps(d[side], sort_keys=True)}")
        return 0 if d is None else 1

    events = load_events(args.trace)
    if args.cmd == "chrome":
        doc = chrome_trace(events)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(doc, f)
            print(f"wrote {len(doc['traceEvents'])} trace events to "
                  f"{args.out}", file=sys.stderr)
        else:
            print(json.dumps(doc))
        return 0

    if args.cmd == "phases":
        d = phase_breakdown(events)
        if args.stall_budget:
            d = {**d, "stall_budget": stall_budget(d)}
        if args.json:
            print(json.dumps(d, indent=1, sort_keys=True))
        else:
            _print_phases(d)
            if args.stall_budget:
                b = d["stall_budget"]
                print(f"stall budget: {b['phase']} owns "
                      f"{b['wall_ms']:.3f} ms = {b['share_pct']:.1f}% "
                      f"of measured tick wall")
    elif args.cmd == "overlap":
        d = overlap_report(events, slowest=args.top)
        if args.json:
            print(json.dumps(d, indent=1, sort_keys=True))
        else:
            print(f"{d['ticks']} ticks: host {d['host_ms']:.1f} ms, "
                  f"dispatch {d['dispatch_ms']:.1f} ms, sync stall "
                  f"{d['stall_ms']:.1f} ms ({d['stall_share_pct']}% of "
                  f"busy wall), overlap window {d['win_ms']:.1f} ms")
            print(f"overlap_frac {d['overlap_frac']} (device-sync "
                  f"demand hidden under host work); idle gap per tick: "
                  f"p50 {d['idle_gap_ms']['p50']} p99 "
                  f"{d['idle_gap_ms']['p99']} max "
                  f"{d['idle_gap_ms']['max']} ms")
            _print_table(d["worst_ticks"],
                         ["tick", "host_ms", "dispatch_ms", "stall_ms",
                          "win_ms"])
    elif args.cmd == "hotdocs":
        d = hot_docs(events, top=args.top)
        if args.json:
            print(json.dumps(d, indent=1, sort_keys=True))
        else:
            print(f"{d['docs']} docs, {d['apply_events']} applies, "
                  f"{d['item_ops']} item-ops")
            _print_table(d["top"], ["doc", "events", "items"])
    elif args.cmd == "fuse":
        d = fusion_table(events, top=args.top)
        if args.json:
            print(json.dumps(d, indent=1, sort_keys=True))
        else:
            print(f"{d['fused_docs']} fused docs: {d['steps_in']} -> "
                  f"{d['steps_out']} steps ({d['rows_saved']} rows "
                  f"saved, {d['reduction_x']}x)")
            _print_table(d["top"], ["doc", "steps_in", "steps_out",
                                    "rows_saved", "fused_ticks"])
    elif args.cmd == "recompiles":
        d = recompile_timeline(events)
        if args.json:
            print(json.dumps(d, indent=1, sort_keys=True))
        else:
            print(f"{d['compiles']} compiles (last at tick "
                  f"{d['last_compile_tick']} of {d['run_last_tick']})")
            _print_table(d["timeline"], ["tick", "i", "shard", "bucket"])
    elif args.cmd == "flow":
        from .flow import flow_report

        d = flow_report(events, expect_terminal=args.audit)
        if args.json:
            print(json.dumps(d, indent=1, sort_keys=True))
        else:
            sp = d["spans"]
            print(f"{sp['emitted']} spans tracked ({d['flow_events']} "
                  f"flow events): {sp['applied']} applied "
                  f"({d['applies']['device']} device / "
                  f"{d['applies']['host']} host), {sp['rejected']} "
                  f"rejected, {sp['in_flight']} in flight")
            a = d["ages_ticks"]
            print(f"op age at apply (ticks): p50 {a['p50']} "
                  f"p99 {a['p99']} max {a['max']} (n={a['count']})")
            for group in ("by_band", "by_class"):
                rows = [{"bucket": k, **v} for k, v in d[group].items()
                        if v["count"]]
                if rows:
                    print(f"{group.replace('_', ' ')}:")
                    _print_table(rows, ["bucket", "count", "p50",
                                        "p99", "max"])
        if args.audit and not d["audit_ok"]:
            f = d["findings"][0]
            print(f"CONSERVATION AUDIT FAILED: {f['kind']} — "
                  f"{f['detail']}", file=sys.stderr)
            return 1
        if args.audit:
            print(f"conservation audit OK: {d['spans']['emitted']} "
                  f"spans terminally accounted", file=sys.stderr)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # `analyze ... | head` is a normal usage
        sys.exit(0)
