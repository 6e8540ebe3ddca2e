"""Structured observability for the serving stack (counterpart of
``text_crdt_rust_tpu/obs``).

- ``obs.trace``    — a logical-clock-first span/event tracer emitting
                     versioned JSONL with wall-clock fields segregated,
                     so two same-seed runs produce byte-identical
                     *logical* traces (the determinism oracle); walls
                     come only from the caller's clock;
- ``obs.registry`` — one metrics registry (counters + gauges + bounded
                     histograms) with JSONL and Prometheus-text
                     exporters;
- ``obs.recorder`` — a bounded flight recorder that, on any typed
                     failure or twin/lane bit-identity mismatch, dumps
                     a post-mortem bundle;
- ``obs.flow``     — per-op provenance spans: every sampled op's
                     ``(agent, seq)`` journey emitted as ``flow.*``
                     trace events, with a conservation audit and
                     op-age-at-apply distributions on the logical tick
                     axis;
- ``obs.ledger``   — the cost ledger's schema and per-metric diff;
- ``obs.cells``    — five of its CPU cells re-derived on the port;
- ``obs.analyze``  — trace analytics and its CLI (``python -m
                     text_crdt_rust_tpu_torch.obs.analyze``): per-tick
                     phase breakdown and stall budget, host-vs-device
                     overlap, hot-doc and fusion tables, recompile
                     timeline, two-trace logical diff, Chrome
                     trace-event export, per-op flow census and its
                     conservation audit.
"""
from .flow import FlowTracker, audit_spans, flow_report  # noqa: F401
from .ledger import (  # noqa: F401
    LEDGER_SCHEMA_VERSION,
    diff_ledger,
    load_ledger,
    validate_ledger,
)
from .recorder import FlightRecorder  # noqa: F401
from .registry import Histogram, MetricsRegistry, observe  # noqa: F401
from .trace import TRACE_SCHEMA_VERSION, Tracer, validate_event  # noqa: F401

