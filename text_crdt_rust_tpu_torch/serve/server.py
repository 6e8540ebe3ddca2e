"""The single-process document server: router + batcher + residency +
admission wired behind one facade (counterpart of
``text_crdt_rust_tpu/serve/server.py``).

Usage shape (see ``serve/loadgen.py`` for the closed-loop driver):

    server = DocServer(ServeConfig(engine="rle-lanes-mixed"),
                       clock=time.perf_counter)
    server.admit_doc("doc-7")
    server.submit_frame("doc-7", frame_bytes)       # remote peer traffic
    server.submit_local("doc-7", "editor", pos=0, ins_content="hi")
    server.tick()                                    # one batched step
    server.poll_request_frame("doc-7")               # owed REQUESTs

Everything user-facing is total: overload and malformed input raise
typed ``AdmissionError``s, capacity overflow degrades to the host
oracle, eviction/restore is CRC-guarded — the invariant under all of it
being YATA convergence: after any interleaving of ticks, evictions,
restores, faults and re-requests, every doc is bit-identical to a
replica that saw the same ops cleanly.

The server runs on the card unless ``device="cpu"`` is given (then on
the kernels' plain versions). ``clock`` is the caller's wall clock
(``Callable[[], float]`` in seconds, e.g. ``time.perf_counter``): the
tracer, router, batcher and residency read walls from it alone, into
the trace's ``"w"`` fields and the latency/tick summaries. Without it
those are absent, and the logical stream is the same.

Not ported yet (ROADMAP Queue A): the write-ahead journal
(``journal_dir`` and ``recover()`` raise) and the profiler capture
(``profile_dir`` raises).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

from .. import resolve_device
from ..common import RemoteTxn
from ..config import ServeConfig
from ..models.sync import state_digest
from ..obs.flow import FlowTracker
from ..obs.recorder import FlightRecorder
from ..obs.registry import MetricsRegistry
from ..obs.trace import Tracer
from ..utils.metrics import Counters, percentiles
from .admission import AdmissionControl
from .batcher import ContinuousBatcher, make_lane_backend
from .residency import LaneResidency
from .router import DocState, ShardRouter


class DocServer:
    """One process, ``num_shards`` device batches, thousands of docs."""

    def __init__(self, cfg: Optional[ServeConfig] = None,
                 counters: Optional[Counters] = None, *, device=None,
                 clock: Optional[Callable[[], float]] = None):
        self.cfg = cfg = cfg or ServeConfig()
        if cfg.max_txn_len > cfg.step_buckets[-1]:
            raise ValueError(
                f"max_txn_len {cfg.max_txn_len} exceeds the largest step "
                f"bucket {cfg.step_buckets[-1]}: an admitted event could "
                f"never fit a tick")
        if cfg.journal_dir:
            raise ValueError(
                "journal_dir: the write-ahead journal (serve/journal.py) "
                "is a later slice of the port (ROADMAP Queue A)")
        if cfg.profile_dir:
            raise ValueError(
                "profile_dir: the JAX package's jax.profiler capture is not "
                "ported (ROADMAP Queue A); time the card from the caller")
        self.device = resolve_device(device)
        self.clock = clock
        # One metrics registry for the whole server (counters + gauges +
        # bounded histograms) — a caller-supplied plain Counters still
        # works (histograms degrade to mean gauges).
        self.counters = (counters if counters is not None
                         else MetricsRegistry())
        self.tracer = Tracer(enabled=cfg.trace, ring=cfg.trace_ring,
                             keep_all=cfg.trace_keep, path=cfg.trace_path,
                             rotate_bytes=cfg.trace_rotate_bytes,
                             clock=clock)
        # Per-op provenance: one FlowTracker shared by every layer an op
        # crosses, agent-sampled (flow_sample_mod).
        self.flow = FlowTracker(self.tracer,
                                sample_mod=cfg.flow_sample_mod)
        self.admission = AdmissionControl(
            max_queue_per_doc=cfg.max_queue_per_doc,
            max_queue_global=cfg.max_queue_global,
            max_txn_len=cfg.max_txn_len,
            rate_capacity=cfg.rate_capacity,
            rate_refill=cfg.rate_refill,
            counters=self.counters,
            tracer=self.tracer)
        self.router = ShardRouter(cfg.num_shards, admission=self.admission,
                                  counters=self.counters,
                                  wire_format=cfg.wire_format,
                                  tracer=self.tracer, flow=self.flow,
                                  clock=clock)
        backends = [
            make_lane_backend(cfg.engine, lanes=cfg.lanes_per_shard,
                              capacity=cfg.lane_capacity,
                              order_capacity=cfg.order_capacity,
                              lmax=cfg.lmax, block_k=cfg.lanes_block_k,
                              fuse_w=cfg.fuse_w if cfg.fuse_steps else 1,
                              device=self.device)
            for _ in range(cfg.num_shards)
        ]
        self.residency = LaneResidency(backends, self.router,
                                       spool_dir=cfg.spool_dir,
                                       counters=self.counters,
                                       ckpt_format=cfg.ckpt_format,
                                       ckpt_compact_ops=cfg.ckpt_compact_ops,
                                       ckpt_compact_links=cfg.ckpt_compact_links,
                                       tracer=self.tracer, clock=clock)
        # Flight recorder: bundles land in cfg.obs_dir, else the
        # TCR_TRACE_DIR env knob, else next to the eviction spool.
        obs_dir = (cfg.obs_dir or os.environ.get("TCR_TRACE_DIR")
                   or os.path.join(self.residency.spool_dir, "obs"))
        self.recorder = FlightRecorder(self.tracer, self.counters, obs_dir,
                                       ring_events=cfg.trace_ring)
        self.router.recorder = self.recorder
        self.residency.recorder = self.recorder
        self.batcher = ContinuousBatcher(self.router, self.residency,
                                         step_buckets=cfg.step_buckets,
                                         lmax=cfg.lmax,
                                         counters=self.counters,
                                         fuse_steps=cfg.fuse_steps,
                                         fuse_w=cfg.fuse_w,
                                         tracer=self.tracer,
                                         recorder=self.recorder,
                                         flow=self.flow,
                                         pipeline_ticks=cfg.pipeline_ticks,
                                         sanitize_pipeline=cfg.sanitize_pipeline,
                                         train_ticks=cfg.train_ticks,
                                         clock=clock)
        self.tick_no = 0

    # -- traffic surface ----------------------------------------------------

    def admit_doc(self, doc_id: str) -> None:
        self.router.admit_doc(doc_id)

    def submit_frame(self, doc_id: str, data: bytes) -> List[bytes]:
        return self.router.submit_frame(doc_id, data)

    def submit_mux_frame(self, data: bytes):
        """One doc-multiplexed TXNS frame (the connection-level
        replication lane); returns per-doc-group rejections."""
        return self.router.submit_mux_frame(data)

    def submit_txn(self, doc_id: str, txn: RemoteTxn) -> None:
        self.router.submit_txn(doc_id, txn)

    def submit_local(self, doc_id: str, agent: str, pos: int,
                     del_len: int = 0, ins_content: str = "") -> None:
        self.router.submit_local(doc_id, agent, pos, del_len, ins_content)

    def poll_request_frame(self, doc_id: str) -> Optional[bytes]:
        return self.router.poll_request_frame(doc_id)

    def export_since(self, doc_id: str, start_order: int):
        return self.router.export_since(doc_id, start_order)

    # -- the serving loop ---------------------------------------------------

    def tick(self) -> Dict[str, float]:
        self.tick_no += 1
        self.router.set_tick(self.tick_no)
        return self.batcher.tick(self.tick_no)

    def flush_pipeline(self) -> None:
        """Sync every in-flight pipelined tick (no-op in the serial
        loop).  Latency percentiles and end-of-run verification call
        this so the last tick's device completion is stamped; emits no
        trace events, so the logical stream stays mode-invariant."""
        self.batcher.flush_pipeline()

    def close_obs(self) -> None:
        """Finalize observability at end of run: sync the pipeline and
        close the trace file. Idempotent; drivers (loadgen, probes) call
        it on teardown."""
        self.flush_pipeline()
        self.tracer.close()

    def recover(self) -> Dict[str, int]:
        """Rebuild a crashed server by re-executing its journal: the
        write-ahead journal is a later slice of the port (ROADMAP Queue
        A), so this raises."""
        raise NotImplementedError(
            "DocServer.recover() re-executes the write-ahead journal "
            "(serve/journal.py), a later slice of the port (ROADMAP "
            "Queue A)")

    def drain(self, max_ticks: int = 64) -> int:
        """Tick until every queue is empty (or the budget runs out);
        returns ticks spent. Pending = undrained events only — txns
        blocked in causal buffers need peer re-delivery, not ticks."""
        for i in range(max_ticks):
            if not any(d.events for d in self.router.docs.values()):
                self.flush_pipeline()
                return i
            self.tick()
        self.flush_pipeline()
        return max_ticks

    # -- inspection / verification ------------------------------------------

    def doc_state(self, doc_id: str) -> DocState:
        return self.router.doc(doc_id)

    def ensure_resident(self, doc_id: str) -> DocState:
        doc = self.router.doc(doc_id)
        if not doc.resident:
            self.residency.restore(doc)
        return doc

    def doc_string(self, doc_id: str) -> str:
        return self.ensure_resident(doc_id).oracle.to_string()

    def doc_digest(self, doc_id: str) -> int:
        return state_digest(self.ensure_resident(doc_id).oracle)

    def verify_doc(self, doc_id: str) -> bool:
        """Lane (if any) bit-identical to the host oracle."""
        doc = self.router.doc(doc_id)
        if not doc.resident:
            return True
        return self.residency.verify_lane(doc)

    def flow_summary(self, expect_terminal: bool = False) -> Dict[str, object]:
        """Per-op provenance census + conservation audit over the
        tracked (sampled) spans: terminal-state counts, findings, and
        op-age-at-apply distributions in logical ticks.  With
        ``expect_terminal`` every still-in-flight span is a named
        finding — the end-of-run audit mode."""
        return self.flow.report(expect_terminal=expect_terminal)

    def latency_summary(self) -> Dict[str, float]:
        """Admission->applied latency percentiles in microseconds on the
        caller's clock (empty without one). Flushes the pipeline first:
        an in-flight tick's events are not stamped until their device
        work completes.  With pipelining on, a tick's events are stamped
        at its STAGED sync (the next tick's barrier slot) — an upper
        bound that can run up to one tick of host wall past true device
        completion; results are not observable to readers before that
        sync either way."""
        self.flush_pipeline()
        if self.clock is None:
            return {}
        us = [s * 1e6 for s in self.batcher.latency_samples]
        out = {k: round(v, 1)
               for k, v in percentiles(us, (50, 99)).items()}
        out["samples"] = len(us)
        return out

    def tick_summary(self) -> Dict[str, float]:
        """Serve tick wall-latency percentiles in milliseconds on the
        caller's clock (one sample per ``tick()`` — the fixed-shape
        device pass plus the host drain around it; absent without a
        clock), plus the generalized step-fusion counters: how many
        compiled rows the per-doc tick fusion eliminated (= bucket
        occupancy gained) and the per-shape histogram."""
        # Flush like latency_summary does: an in-flight tick's stall/
        # window is not accounted until its staged sync, and the two
        # summaries must not disagree about the same run.
        self.flush_pipeline()
        out: Dict[str, float] = {}
        if self.clock is not None:
            ms = [s * 1e3 for s in self.batcher.tick_wall_samples]
            out = {k: round(v, 3)
                   for k, v in percentiles(ms, (50, 99)).items()}
            out["samples"] = len(ms)
        fs = self.batcher.fuse_stats
        out["steps_total"] = fs.steps_out
        out["steps_prefuse"] = fs.steps_in
        out["fused_rows_saved"] = fs.rows_saved
        # ops/step: compiled op rows landed per device step row (each
        # pre-fusion row is one op's step).
        out["ops_per_step"] = round(fs.reduction_x, 3)
        for shape, n in fs.fused.items():
            if n:
                out[f"fuse_{shape}"] = n
        # Bytes-on-wire + checkpoint-bytes, the per-stream ops_per_step
        # and fused_rows_saved histograms and the per-bucket device-step
        # wall percentiles, all from the one metrics registry.
        c = self.counters.summary()
        for key in ("wire_bytes_in", "wire_txn_bytes_out",
                    "ckpt_bytes_written", "ckpt_saves_full",
                    "ckpt_saves_delta", "ckpt_bytes_per_evict_mean"):
            if key in c:
                out[key] = c[key]
        for key in c:
            if (key.startswith(("ops_per_step_", "fused_rows_saved_",
                                "device_step_wall_ms_"))
                    and key.rsplit("_", 1)[-1] in
                    ("min", "max", "p50", "p99", "count")):
                out[key] = c[key]
        out["device_compiles"] = c.get("device_compiles", 0)
        # Pipelined tick: the effective depth and, on the caller's clock,
        # how much of the measured device-sync demand the staged sync
        # hid under host work (0.0 in the serial loop) and the residual
        # stall the overlap could not absorb.
        out["pipeline_ticks"] = self.batcher.effective_pipeline_ticks()
        if self.clock is not None:
            out["pipeline_overlap_frac"] = round(
                self.batcher.pipeline_overlap_frac(), 4)
            out["pipeline_stall_ms_total"] = round(
                self.batcher.sync_stall_s * 1e3, 3)
        # Flight-recorder visibility: how many post-mortem bundles this
        # run wrote and how many same-reason repeats were suppressed.
        out["bundles_written"] = c.get("bundles_written", 0)
        out["bundles_suppressed"] = c.get("bundles_suppressed", 0)
        return out

    def stats(self) -> Dict[str, float]:
        out = dict(self.counters.summary())
        out.update(self.residency.resident_counts())
        out.update({f"latency_us_{k}": v
                    for k, v in self.latency_summary().items()})
        out.update({f"tick_ms_{k}": v
                    for k, v in self.tick_summary().items()})
        return out
