"""One metrics registry for counters, gauges and bounded histograms
(counterpart of ``text_crdt_rust_tpu/obs/registry.py``).

``utils.metrics.Counters`` holds monotonic counts, high-water gauges,
and mean-only ``sample`` gauges — and means hide real distributions (a
skewed ``ops_per_step`` is invisible without a histogram).  ``MetricsRegistry``
extends ``Counters`` (every existing ``incr``/``hiwater``/``sample``
call site keeps working, min/max now ride along) with:

- ``histo(name, value)`` — **bounded** histograms: count/sum/min/max
  are always exact; percentiles come from a bounded sample buffer that
  decimates deterministically (keep-every-k-th with k doubling) when
  full, feeding the one shared ``utils.metrics.percentiles``
  definition so p99 can't mean different things in different reports;
- ``gauge(name, value)`` — last-value gauges;
- exporters: ``summary()`` (flat dict — what ``DocServer.stats()``,
  the loadgen report and the bench rows consume), ``to_jsonl()``
  (versioned one-metric-per-line JSONL) and ``prometheus_text()``
  (the text exposition format, counters + summary quantiles).

The registry is deliberately deterministic: no wall-clock anywhere,
decimation depends only on the sample sequence — so registry state is
part of the same-seed reproducibility contract the tracer pins.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List

from ..utils.metrics import Counters, percentiles

REGISTRY_SCHEMA_VERSION = 1

# Default bounded-buffer size: percentile error from decimation is
# negligible far below this; memory is bounded at cap floats/histogram.
_DEFAULT_CAP = 1024

_PROM_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name: str, prefix: str = "tcr") -> str:
    """A conformant Prometheus metric name: invalid characters collapse
    to ``_``, and the result may not start with a digit
    (``[a-zA-Z_:][a-zA-Z0-9_:]*`` per the exposition format spec)."""
    s = _PROM_SANITIZE.sub("_", name)
    full = f"{prefix}_{s}" if prefix else s
    if not full or full[0].isdigit():
        full = "_" + full
    return full


def prom_escape_label(value) -> str:
    """Label-VALUE escaping per the text exposition format: backslash,
    double-quote and newline must be escaped inside the quotes."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_escape_help(text: str) -> str:
    """# HELP text escaping: backslash and newline only."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


class Histogram:
    """Bounded histogram with deterministic decimation.

    Exact ``count``/``total``/``min``/``max``; a bounded sample buffer
    for percentiles.  When the buffer fills, every other retained
    sample is dropped and the keep-stride doubles — so the buffer holds
    an evenly-spaced subsample of the whole series (not just its
    prefix or suffix), and two identical series always decimate
    identically.
    """

    __slots__ = ("cap", "samples", "stride", "_phase", "count", "total",
                 "vmin", "vmax")

    def __init__(self, cap: int = _DEFAULT_CAP):
        assert cap >= 2
        self.cap = cap
        self.samples: List[float] = []
        self.stride = 1
        self._phase = 0
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def add(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self._phase += 1
        if self._phase >= self.stride:
            self._phase = 0
            self.samples.append(v)
            if len(self.samples) > self.cap:
                self.samples = self.samples[::2]
                self.stride *= 2

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantiles(self, points=(50, 99)) -> Dict[str, float]:
        return percentiles(self.samples, points)

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p99": 0.0}
        out = {"count": self.count, "mean": round(self.mean, 6),
               "min": self.vmin, "max": self.vmax}
        out.update(self.quantiles())
        return out


class MetricsRegistry(Counters):
    """``Counters`` + gauges + bounded histograms + exporters — the ONE
    sink every serve/net/bench metric flows through."""

    def __init__(self) -> None:
        super().__init__()
        self._gauges: Dict[str, float] = {}
        self._histos: Dict[str, Histogram] = {}

    # -- new instrument surface ---------------------------------------------

    def gauge(self, name: str, value: float) -> None:
        self._gauges[name] = value

    def histo(self, name: str, value: float, cap: int = _DEFAULT_CAP) -> None:
        h = self._histos.get(name)
        if h is None:
            h = self._histos[name] = Histogram(cap)
        h.add(value)

    def histogram(self, name: str) -> Histogram:
        """The named histogram (created empty if absent) — for callers
        that want the exact count/percentile surface, not the flat
        summary keys."""
        h = self._histos.get(name)
        if h is None:
            h = self._histos[name] = Histogram()
        return h

    # -- exporters -----------------------------------------------------------

    def summary(self) -> Dict[str, float]:
        out = super().summary()
        out.update(self._gauges)
        for name, h in self._histos.items():
            for k, v in h.summary().items():
                out[f"{name}_{k}"] = v
        return out

    def to_jsonl(self) -> str:
        """Versioned one-metric-per-line JSONL: a ``meta`` header line,
        then ``{"name", "type", ...}`` per metric — the machine-readable
        export the bench rows and dashboards ingest."""
        lines = [json.dumps({"meta": "metrics",
                             "schema": REGISTRY_SCHEMA_VERSION},
                            sort_keys=True, separators=(",", ":"))]
        for name in sorted(self._counts):
            lines.append(json.dumps(
                {"name": name, "type": "counter",
                 "value": self._counts[name]},
                sort_keys=True, separators=(",", ":")))
        for name in sorted(self._hiwater):
            lines.append(json.dumps(
                {"name": name, "type": "hiwater",
                 "value": self._hiwater[name]},
                sort_keys=True, separators=(",", ":")))
        for name in sorted(self._gauges):
            lines.append(json.dumps(
                {"name": name, "type": "gauge",
                 "value": self._gauges[name]},
                sort_keys=True, separators=(",", ":")))
        for name in sorted(self._samples):
            total, count, vmin, vmax = self._sample_stats(name)
            lines.append(json.dumps(
                {"name": name, "type": "sample", "count": count,
                 "mean": round(total / count, 6) if count else 0.0,
                 "min": vmin, "max": vmax},
                sort_keys=True, separators=(",", ":")))
        for name in sorted(self._histos):
            row = {"name": name, "type": "histogram"}
            row.update(self._histos[name].summary())
            lines.append(json.dumps(row, sort_keys=True,
                                    separators=(",", ":")))
        return "\n".join(lines) + "\n"

    def prometheus_text(self, prefix: str = "tcr") -> str:
        """Prometheus text exposition: counters as ``counter``, hiwater
        and gauges as ``gauge``, samples and histograms as ``summary``
        (quantiles + _sum + _count).  Conformance:
        sanitized names with the leading-digit rule, escaped label
        values, one ``# HELP``/``# TYPE`` pair per metric, and sanitize
        collisions disambiguated (two raw names collapsing to one
        exposition name — or one raw name reused across metric kinds —
        would otherwise emit a duplicate ``# TYPE``, invalid per the
        format spec).  The suffix is a per-base ordinal, so a colliding
        metric's exposed name stays stable as unrelated metrics appear
        between scrapes."""
        seen: dict = {}  # exposition base -> times already emitted

        def _n(name: str) -> str:
            full = prom_name(name, prefix)
            k = seen.get(full, 0)
            seen[full] = k + 1
            return full if k == 0 else f"{full}_{k}"

        out: List[str] = []

        def _head(n: str, raw: str, mtype: str, what: str) -> None:
            out.append(f"# HELP {n} "
                       f"{_prom_escape_help(f'{what} {raw!r}')}")
            out.append(f"# TYPE {n} {mtype}")

        for name in sorted(self._counts):
            n = _n(name)
            _head(n, name, "counter", "monotonic counter")
            out.append(f"{n} {self._counts[name]}")
        for name in sorted(self._hiwater):
            n = _n(name)
            _head(n, name, "gauge", "high-water gauge")
            out.append(f"{n} {self._hiwater[name]}")
        for name in sorted(self._gauges):
            n = _n(name)
            _head(n, name, "gauge", "last-value gauge")
            out.append(f"{n} {self._gauges[name]}")
        for name in sorted(self._samples):
            total, count, _vmin, _vmax = self._sample_stats(name)
            n = _n(name)
            _head(n, name, "summary", "mean-gauge sample")
            out.append(f"{n}_sum {total}")
            out.append(f"{n}_count {count}")
        for name in sorted(self._histos):
            h = self._histos[name]
            n = _n(name)
            _head(n, name, "summary", "bounded histogram")
            for p, v in h.quantiles().items():
                q = float(p[1:]) / 100.0
                out.append(f'{n}{{quantile="{prom_escape_label(q)}"}} {v}')
            out.append(f"{n}_sum {h.total}")
            out.append(f"{n}_count {h.count}")
        return "\n".join(out) + "\n"


def observe(counters, name: str, value: float) -> None:
    """Record ``value`` into ``counters``' histogram ``name`` when the
    sink supports histograms (a ``MetricsRegistry``), else fall back to
    the mean-gauge ``sample`` — so serve components instrument
    unconditionally and plain-``Counters`` call sites keep working."""
    h = getattr(counters, "histo", None)
    if h is not None:
        h(name, value)
    else:
        counters.sample(name, value)
