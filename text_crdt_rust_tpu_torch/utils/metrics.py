"""Metrics & observability: the reference's ``print_stats`` family
(counterpart of ``text_crdt_rust_tpu/utils/metrics.py``).

The reference instruments itself with a counting global allocator
(`src/alloc.rs:13-50`) and per-container ``print_stats`` dumps — entry
histograms, node counts, RLE compaction ratio ("compacts to N entries",
`split_list/mod.rs:418`), actual-vs-efficient memory (`root.rs:293-326`).
The port's equivalents:

- ``doc_stats``   — one dict per document: items/live/tombstones, merged
                    span count + compaction ratio (the RLE health metric
                    that decides device array sizes), span-length
                    histogram, log entry counts;
- ``memory_stats``— bytes per column for host oracle docs and device
                    ``FlatDoc``s (device bytes ARE the device footprint);
- ``run_stats``   — run-state health of the run-block replays' results;
- ``print_stats`` — the human-readable dump;
- ``Throughput``  — ops/sec accumulator for bench loops (wall clock from
                    the caller's clock, explicit ``ops`` counts).

The document functions take an oracle ``ListCRDT``, a native engine's
``NativeListCRDT`` or a device ``FlatDoc``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np


def _spans_of(doc) -> List[Tuple[int, int, int, int]]:
    if hasattr(doc, "doc_spans"):
        return doc.doc_spans()
    from ..ops.span_arrays import doc_spans
    return doc_spans(doc)


def _counts_of(doc, spans) -> Tuple[int, int]:
    """(total items, live items) for an oracle or a ``FlatDoc``; derived
    from the merged spans for device docs (no second download)."""
    if hasattr(doc, "deleted"):  # oracle
        n = doc.n
        return n, int(np.count_nonzero(~doc.deleted[:n]))
    lens = [s[3] for s in spans]
    return sum(abs(ln) for ln in lens), sum(ln for ln in lens if ln > 0)


def span_histogram(spans, bins=(1, 2, 4, 8, 16, 32, 64, 128)) -> Dict[str, int]:
    """Span-length histogram (the reference's entry-size histograms,
    `root.rs:293-326`)."""
    lens = np.asarray([abs(s[3]) for s in spans] or [0])
    out: Dict[str, int] = {}
    lo = 1
    for hi in bins:
        out[f"{lo}-{hi}"] = int(((lens >= lo) & (lens <= hi)).sum())
        lo = hi + 1
    out[f">{bins[-1]}"] = int((lens > bins[-1]).sum())
    return out


def doc_stats(doc, spans=None) -> dict:
    """Document-health metrics; ``compaction`` is items per merged span —
    the reference's "compacts to N entries" ratio. Pass precomputed
    ``spans`` to avoid re-downloading a device doc."""
    if spans is None:
        spans = _spans_of(doc)
    items, live = _counts_of(doc, spans)
    stats = {
        "items": items,
        "live": live,
        "tombstones": items - live,
        "merged_spans": len(spans),
        "compaction": items / max(1, len(spans)),
        "span_histogram": span_histogram(spans),
    }
    if hasattr(doc, "deletes"):  # oracle-side logs
        stats["deletes_entries"] = doc.deletes.num_entries()
        stats["double_delete_entries"] = doc.double_deletes.num_entries()
        stats["txn_entries"] = doc.txns.num_entries()
    return stats


def memory_stats(doc, spans=None) -> dict:
    """Bytes per column. For a device ``FlatDoc`` these are the actual
    device buffer sizes; ``efficient_bytes`` is what a fully
    RLE-compacted span store would need (16 B/span, `span.rs:126-129`) —
    the reference's actual-vs-efficient comparison. Pass precomputed
    ``spans`` to avoid re-downloading a device doc."""
    if spans is None:
        spans = _spans_of(doc)
    if hasattr(doc, "deleted"):  # oracle numpy columns
        cols = {k: getattr(doc, k).nbytes
                for k in ("order", "origin_left", "origin_right",
                          "deleted", "chars")}
    elif hasattr(doc, "memory_bytes"):  # the native engine's own count
        cols = {"native_engine": int(doc.memory_bytes())}
    else:
        cols = {k: int(getattr(doc, k).numel()
                       * getattr(doc, k).element_size())
                for k in ("signed", "ol_log", "or_log", "rank_log",
                          "chars_log")}
    total = sum(cols.values())
    return {
        "columns": cols,
        "total_bytes": total,
        "efficient_bytes": 16 * len(spans),
        "overhead": total / max(1, 16 * len(spans)),
    }


def run_stats(res, doc_index: int = 0) -> dict:
    """Device RUN-state health metrics of the run-block replays' results
    (``RleResult``/``RleMixedResult``) — the `print_stats` family
    (`root.rs:293-326`) read off the run representation: run/live/
    tombstone rows, chars and chars per run (the compaction ratio that
    sizes the planes), blocks used and block fill, and the run-length
    histogram."""
    K = res.block_k
    ordc = res.ordp[:, doc_index].cpu().numpy()
    lenc = res.lenp[:, doc_index].cpu().numpy()
    rows = res.rows[:, doc_index].cpu().numpy()
    nlog = int(res.meta[0, doc_index])
    blk = res.blkord[:, doc_index].cpu().numpy()
    o_parts, l_parts = [], []
    for sl in range(nlog):
        b, r = int(blk[sl]), int(rows[sl])
        o_parts.append(ordc[b * K: b * K + r])
        l_parts.append(lenc[b * K: b * K + r])
    o = (np.concatenate(o_parts) if o_parts else np.zeros(0, np.int32))
    ln = (np.concatenate(l_parts) if l_parts else np.zeros(0, np.int32))
    live = o > 0
    spans = [(0, 0, 0, int(n if lv else -n)) for n, lv in zip(ln, live)]
    total_rows = int(len(o))
    return {
        "run_rows": total_rows,
        "live_rows": int(live.sum()),
        "tombstone_rows": int((~live & (o != 0)).sum()),
        "chars": int(ln.sum()),
        "live_chars": int(ln[live].sum()),
        "chars_per_run": round(float(ln.sum()) / max(total_rows, 1), 2),
        "blocks_used": nlog,
        "block_fill": round(total_rows / max(nlog * K, 1), 3),
        "run_histogram": span_histogram(spans),
    }


def print_stats(doc, detailed: bool = False) -> None:
    """Human-readable dump (`doc.rs:492-498` analog). Downloads a device
    doc once and shares the spans across both stat passes."""
    spans = _spans_of(doc)
    d = doc_stats(doc, spans=spans)
    m = memory_stats(doc, spans=spans)
    print(f"doc: {d['items']} items ({d['live']} live, "
          f"{d['tombstones']} tombstones), {d['merged_spans']} merged spans "
          f"(compaction {d['compaction']:.1f}x)")
    print(f"  memory: {m['total_bytes']:,} B actual vs "
          f"{m['efficient_bytes']:,} B compacted "
          f"({m['overhead']:.1f}x overhead)")
    if detailed:
        print(f"  span histogram: {d['span_histogram']}")
        for k in ("deletes_entries", "double_delete_entries", "txn_entries"):
            if k in d:
                print(f"  {k}: {d[k]}")


class Counters:
    """Named monotonic counters + high-water and mean gauges for the
    replication and serving stacks (`net/`, `serve/`): frames
    sent/rejected, retries, buffer high-water — and the serve layer's
    admitted / rejected_* / evictions / restores counts plus the
    ``batch_fill_ratio`` mean gauge (`serve/batcher.py`).

    The wire-layer analog of the reference's counting-allocator
    instrumentation (`src/alloc.rs:13-50`): cheap increments everywhere,
    one ``summary()`` dump. ``incr`` counts events; ``hiwater`` keeps the
    max of a gauge (e.g. causal-buffer pending size); ``sample`` feeds a
    running mean/min/max (e.g. per-tick batch fill ratio), reported as
    ``<name>_mean``/``<name>_min``/``<name>_max`` with its sample count
    as ``<name>_samples`` — means alone hide a skewed ``ops_per_step``,
    so the extremes always ride along.  For full
    distributions (percentiles) use ``obs.registry.MetricsRegistry``,
    which extends this class with bounded histograms.
    """

    def __init__(self) -> None:
        self._counts: Dict[str, int] = {}
        self._hiwater: Dict[str, int] = {}
        # name -> (total, count, min, max)
        self._samples: Dict[str, Tuple[float, int, float, float]] = {}

    def incr(self, name: str, by: int = 1) -> None:
        self._counts[name] = self._counts.get(name, 0) + by

    def hiwater(self, name: str, value: int) -> None:
        if value > self._hiwater.get(name, 0):
            self._hiwater[name] = value

    def sample(self, name: str, value: float) -> None:
        v = float(value)
        total, count, vmin, vmax = self._samples.get(
            name, (0.0, 0, float("inf"), float("-inf")))
        self._samples[name] = (total + v, count + 1,
                               min(vmin, v), max(vmax, v))

    def mean(self, name: str) -> float:
        total, count, _vmin, _vmax = self._samples.get(
            name, (0.0, 0, 0.0, 0.0))
        return total / count if count else 0.0

    def _sample_stats(self, name: str) -> Tuple[float, int, float, float]:
        """(total, count, min, max) of one sample gauge (zeros when
        empty) — the registry exporters read through this."""
        total, count, vmin, vmax = self._samples.get(
            name, (0.0, 0, 0.0, 0.0))
        if not count:
            return 0.0, 0, 0.0, 0.0
        return total, count, vmin, vmax

    def get(self, name: str) -> int:
        return self._counts.get(name, self._hiwater.get(name, 0))

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = dict(self._counts)
        for k, v in self._hiwater.items():
            out[k] = v
        for k in self._samples:
            total, count, vmin, vmax = self._sample_stats(k)
            out[f"{k}_mean"] = round(total / count, 6) if count else 0.0
            out[f"{k}_samples"] = count
            out[f"{k}_min"] = vmin
            out[f"{k}_max"] = vmax
        return out


def percentiles(samples, points=(50, 99)) -> Dict[str, float]:
    """Nearest-rank percentiles of a sample list as ``{"p50": ..}``.

    The serve layer's admission→applied latency summary (and the bench
    rows') share this one definition so p99 can't silently mean
    different things in different reports. Empty input -> zeros.
    """
    out: Dict[str, float] = {}
    ss = sorted(float(s) for s in samples)
    for p in points:
        if not ss:
            out[f"p{p}"] = 0.0
        else:
            idx = min(len(ss) - 1, int(round((len(ss) - 1) * p / 100.0)))
            out[f"p{p}"] = ss[idx]
    return out


def measured_hbm_bytes(device=None):
    """(bytes, reason) live device allocation from the runtime.

    Reads ``torch.cuda.memory_stats`` of ``device`` (default: the
    current card) when CUDA is available; returns ``(None, reason)``
    with a human-readable reason otherwise, so rows carry an
    explanation instead of a bare null.
    """
    import torch

    if not torch.cuda.is_available():
        return None, "no CUDA device (torch.cuda.is_available() is false)"
    stats = torch.cuda.memory_stats(device)
    # Usage counters ONLY: the card's capacity is not live allocation.
    for key in ("allocated_bytes.all.current", "allocated_bytes.all.peak"):
        if key in stats:
            return int(stats[key]), None
    return None, (f"memory_stats present but carries no usage counter "
                  f"(keys: {sorted(stats)[:8]})")


def causal_buffer_stats(buf) -> dict:
    """Introspection snapshot of a ``parallel.causal.CausalBuffer`` for
    the session layer and dashboards: pending count and high-water,
    duplicate-drop / eviction counters, per-agent watermark gaps."""
    return {
        "pending": buf.pending,
        "high_water": buf.high_water,
        "duplicates_dropped": buf.duplicates_dropped,
        "evictions": buf.evictions,
        "watermarks": buf.watermarks(),
        "agent_gaps": buf.gap_stats(),
    }


class Throughput:
    """Ops/sec accumulator for bench loops, timed by the caller's clock
    (``Callable[[], float]`` in seconds, e.g. ``time.perf_counter``).

    >>> meter = Throughput(clock)           # doctest: +SKIP
    >>> with meter.measure(ops=1000): ...   # doctest: +SKIP
    >>> meter.ops_per_sec                   # doctest: +SKIP
    """

    def __init__(self, clock: Callable[[], float]) -> None:
        self.clock = clock
        self.ops = 0
        self.seconds = 0.0
        self.samples = 0

    def add(self, ops: int, seconds: float) -> None:
        self.ops += ops
        self.seconds += seconds
        self.samples += 1

    def measure(self, ops: int):
        meter = self

        class _Ctx:
            def __enter__(self):
                self.t0 = meter.clock()
                return self

            def __exit__(self, *exc):
                meter.add(ops, meter.clock() - self.t0)
                return False

        return _Ctx()

    @property
    def ops_per_sec(self) -> float:
        return self.ops / self.seconds if self.seconds else 0.0

    def summary(self) -> dict:
        return {"ops": self.ops, "seconds": round(self.seconds, 6),
                "ops_per_sec": round(self.ops_per_sec, 1),
                "samples": self.samples}
