"""The single-process document server: router + batcher + residency +
admission wired behind one facade (counterpart of
``text_crdt_rust_tpu/serve/server.py``).

Usage shape (see ``serve/loadgen.py`` for the closed-loop driver):

    server = DocServer(ServeConfig(), clock=time.perf_counter)
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

``journal_dir`` turns on the write-ahead journal (``serve/journal.py``)
that ``recover()`` re-executes after a crash; ``profile_dir`` captures
ticks 1..``profile_ticks`` with ``torch.profiler`` into a Chrome trace
there (``trace.json``).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import torch

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
                              device=self.device,
                              device_prefill=cfg.device_prefill)
            for _ in range(cfg.num_shards)
        ]
        self.residency = LaneResidency(backends, self.router,
                                       spool_dir=cfg.spool_dir,
                                       counters=self.counters,
                                       ckpt_format=cfg.ckpt_format,
                                       ckpt_compact_ops=cfg.ckpt_compact_ops,
                                       ckpt_compact_links=cfg.ckpt_compact_links,
                                       tracer=self.tracer, clock=clock)
        # Write-ahead op journal: admission-edge durability. None (the
        # default) = off; the loadgen/chaos drivers pin a directory so
        # DocServer.recover() can rebuild this server.
        self.journal = None
        if cfg.journal_dir:
            from .journal import Journal
            self.journal = Journal(cfg.journal_dir, cfg.num_shards,
                                   fsync_ticks=cfg.journal_fsync_ticks,
                                   counters=self.counters,
                                   tracer=self.tracer)
            self.router.journal = self.journal
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
        self._profiler = None

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
        self._profile_hook()
        stats = self.batcher.tick(self.tick_no)
        if self.journal is not None:
            # The tick boundary is the journal's fsync point AND the
            # replay pacing marker: recovery re-runs ``tick()`` here so
            # the apply cadence (and with it the local-vs-remote
            # interleaving) reproduces exactly.
            self.journal.tick(self.tick_no)
        return stats

    def flush_pipeline(self) -> None:
        """Sync every in-flight pipelined tick (no-op in the serial
        loop).  Latency percentiles and end-of-run verification call
        this so the last tick's device completion is stamped; emits no
        trace events, so the logical stream stays mode-invariant."""
        self.batcher.flush_pipeline()

    def close_obs(self) -> None:
        """Finalize observability at end of run: sync the pipeline, stop
        a still-running profiler capture (a run shorter than
        ``profile_ticks`` would otherwise never write its trace), close
        the journal and the trace file. Idempotent; drivers (loadgen,
        probes) call it on teardown."""
        self.flush_pipeline()
        if self._profiler is not None:
            try:
                self._stop_profile()
                self.tracer.event("profile", action="stop",
                                  dir=self.cfg.profile_dir)
            except Exception as e:
                self.counters.incr("profile_errors")
                self.tracer.event("profile", action="error",
                                  err=f"{type(e).__name__}: {e}")
        if self.journal is not None:
            self.journal.close()
        self.tracer.close()

    def _stop_profile(self) -> None:
        """Stop the capture after the card finished the captured ticks'
        launches, and write it as ``<profile_dir>/trace.json``."""
        prof, self._profiler = self._profiler, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.cfg.profile_dir, "trace.json"))

    def _profile_hook(self) -> None:
        """Opt-in ``torch.profiler`` capture: ticks 1..profile_ticks into
        ``cfg.profile_dir`` (host activity, and the card's launches on
        CUDA). Failure to start or stop a profiler is counted, never
        raised — profiling must not take the serving loop down."""
        if not self.cfg.profile_dir:
            return
        try:
            if self.tick_no == 1 and self._profiler is None:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                self._profiler = profile(activities=acts)
                self._profiler.start()
                self.tracer.event("profile", action="start",
                                  dir=self.cfg.profile_dir)
            elif (self._profiler is not None
                  and self.tick_no > self.cfg.profile_ticks):
                self._stop_profile()
                self.tracer.event("profile", action="stop",
                                  dir=self.cfg.profile_dir)
        except Exception as e:
            self._profiler = None
            self.counters.incr("profile_errors")
            self.tracer.event("profile", action="error",
                              err=f"{type(e).__name__}: {e}")

    def recover(self) -> Dict[str, int]:
        """Rebuild a crashed server by re-executing its input log.  Call
        on a FRESH server
        constructed with the dead server's ``spool_dir``/``journal_dir``.

        The server is a deterministic state machine, so recovery is
        re-execution: scan the journal (valid prefix per shard; typed
        refusals counted + traced, their suffixes already repaired
        away at Journal reopen so post-recovery appends survive a
        second crash), audit the checkpoint spool
        (corruption reported, file allocator advanced past the crashed
        process's files), then replay the merged record stream through
        the NORMAL admission -> buffer -> batcher path with journaling
        suspended.  ADMIT records reproduce shard assignment and drain
        order; TXNS/LOCAL/FRAME/POLL records re-submit the same inputs;
        TICK markers re-run ``tick()`` so the apply cadence — residency
        trajectory, local-edit position resolution, and the in-flight
        pipelined ticks that were dispatched but never synced at crash
        time — re-derives exactly.  Replayed evictions lay the
        checkpoint chains down again (fresh files; the crashed
        process's spool stays untouched for forensics), and replayed
        restores read them back — the checkpoint path exercises itself.
        Returns replay stats."""
        from ..net import codec
        from . import journal as J
        from .admission import AdmissionError

        if self.journal is None:
            raise ValueError(
                "recover() needs cfg.journal_dir (durability was off)")
        if self.router.docs:
            raise ValueError(
                "recover() must run on a fresh server, before any traffic")
        records, fresh_errors = J.scan(self.cfg.journal_dir)
        # Refusals were detected — and the refused suffixes repaired
        # (truncated/quarantined, so post-recovery segments can never
        # be dropped behind them on the NEXT crash's scan) — when this
        # server's Journal reopened the directory.  Those were counted
        # at reopen; report them through the recovery channel too.
        # ``fresh_errors`` (disk mutated between reopen and recover)
        # should be empty, but if not, count them like any refusal.
        for err in fresh_errors:
            self.counters.incr("journal_refusals")
        errors = list(self.journal.repair_errors) + fresh_errors
        for err in errors:
            self.tracer.event("journal.refuse", segment=err.segment,
                              offset=err.offset, reason=err.reason)
            if self.recorder is not None:
                self.recorder.on_failure("journal", str(err))
        found = self.residency.rediscover()
        stats = {"records": len(records), "refusals": len(errors),
                 "docs": 0, "ckpts_found": len(found), "ops": 0,
                 "txns_replayed": 0, "locals_replayed": 0,
                 "frames_replayed": 0, "polls_replayed": 0,
                 "ticks": 0, "readmissions": 0, "shard_mismatches": 0,
                 "local_gaps": 0}
        with self.journal.suspend():
            for rec in records:
                if rec.kind == J.REC_ADMIT:
                    doc_id = rec.body.decode("utf-8")
                    doc = self.router.admit_doc(doc_id)
                    stats["docs"] += 1
                    if doc.shard != rec.shard:
                        # Replayed least-loaded choice disagreeing with
                        # the recorded one would reorder every later
                        # drain — loud, never silent.
                        stats["shard_mismatches"] += 1
                        self.counters.incr("recovery_shard_mismatches")
                elif rec.kind == J.REC_TXNS:
                    try:
                        kind, groups, _, _ = codec.decode_frame_ex(
                            bytes(rec.body))
                    except codec.CodecError as e:
                        # CRC-chained records should never decode dirty;
                        # if one does, refuse it loudly and keep going.
                        self.counters.incr("journal_refusals")
                        self.tracer.event(
                            "journal.refuse", segment=rec.segment,
                            offset=rec.offset,
                            reason=f"undecodable TXNS body: {e}")
                        continue
                    if kind != codec.KIND_TXNS_MUX:
                        # Same taxonomy as an undecodable body: a TXNS
                        # record carrying a non-mux frame is a typed
                        # per-record refusal, never a replay abort.
                        self.counters.incr("journal_refusals")
                        self.tracer.event(
                            "journal.refuse", segment=rec.segment,
                            offset=rec.offset,
                            reason=f"TXNS body kind {kind} is not "
                                   f"TXNS_MUX")
                        continue
                    for doc_id, txns in groups:
                        for txn in txns:
                            try:
                                self.router.submit_txn(doc_id, txn)
                            except AdmissionError:
                                stats["readmissions"] += 1
                                continue
                            stats["txns_replayed"] += 1
                elif rec.kind == J.REC_LOCAL:
                    (doc_id, agent, pos, del_len, ins,
                     ordinal) = J.decode_local_body(rec.body)
                    doc = self.router.doc(doc_id)
                    if ordinal != doc.local_seen:
                        # Exactly-once audit: the rebuilt ordinal
                        # counter must agree with the recorded one.
                        stats["local_gaps"] += 1
                        self.counters.incr("recovery_local_gaps")
                    try:
                        self.router.submit_local(doc_id, agent, pos,
                                                 del_len, ins)
                    except AdmissionError:
                        stats["readmissions"] += 1
                        continue
                    stats["locals_replayed"] += 1
                elif rec.kind == J.REC_FRAME:
                    doc_id, data = J.decode_frame_body(rec.body)
                    try:
                        self.router.submit_frame(doc_id, data)
                    except AdmissionError:
                        stats["readmissions"] += 1
                        continue
                    stats["frames_replayed"] += 1
                elif rec.kind == J.REC_POLL:
                    doc_id = rec.body.decode("utf-8")
                    try:
                        self.router.poll_request_frame(doc_id)
                    except AdmissionError:
                        stats["readmissions"] += 1
                        continue
                    stats["polls_replayed"] += 1
                elif rec.kind == J.REC_TICK:
                    tick_no, _ = J._read_varint(rec.body, 0,
                                                len(rec.body))
                    if tick_no <= self.tick_no:
                        continue  # one marker per shard: replay once
                    self.tick_no = tick_no - 1
                    self.tick()
                    stats["ticks"] += 1
        stats["ops"] = stats["txns_replayed"] + stats["locals_replayed"]
        self.counters.incr("recovery_ops_replayed", stats["ops"])
        self.counters.incr("recovery_ticks", stats["ticks"])
        self.tracer.event("recovery.replay", records=stats["records"],
                          ops=stats["ops"], ticks=stats["ticks"],
                          docs=stats["docs"],
                          ckpts=stats["ckpts_found"],
                          refusals=stats["refusals"])
        return stats

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
        # Device-resident prefill: the per-tick log-prefill byte economy
        # — what moved host->device vs the full-log round trip, the
        # scatter volume, and the distinct scatter buckets (the JAX
        # package's scatter compiles).  Backends without the surface
        # (the blocked lanes backend) contribute nothing; the summed
        # stats stay seed-deterministic.
        pf = [b.prefill_summary() for b in self.residency.backends
              if hasattr(b, "prefill_summary")]
        if pf:
            out["device_prefill"] = all(p["device_prefill"] for p in pf)
            out["prefill_bytes_per_tick"] = round(
                sum(p["prefill_bytes_per_tick"] for p in pf), 1)
            out["prefill_bytes_full_per_tick"] = round(
                sum(p["prefill_bytes_full_per_tick"] for p in pf), 1)
            # max(.., 1): same floor as the backend's per-backend cut —
            # a run that moved zero prefill bytes (no-insert streams)
            # reports the full-log baseline as its cut, not a 1e9
            # division artifact.
            out["prefill_bytes_cut_x"] = round(
                out["prefill_bytes_full_per_tick"]
                / max(out["prefill_bytes_per_tick"], 1.0), 2)
            out["prefill_scatter_len"] = sum(
                p["prefill_scatter_len"] for p in pf)
            out["prefill_scatter_compiles"] = sum(
                p["prefill_scatter_compiles"] for p in pf)
        # Tick trains: the per-tick device-dispatch economy.
        # ``device_dispatches`` counts device dispatches issued (train
        # launches + prefill scatters); ``dispatch_serial_equiv`` is what
        # the serial loop would have issued for the same stream.
        # ``train_len`` is the realized mean (flushes make partial
        # trains); ``train_compiles`` counts distinct (T, S) train shapes
        # — report-only, never traced, so the logical stream stays
        # train-length-invariant.
        tn = [b.train_summary() for b in self.residency.backends
              if hasattr(b, "train_summary")]
        if tn:
            out["train_ticks"] = self.batcher.effective_train_ticks()
            out["device_dispatches"] = sum(
                t["device_dispatches"] for t in tn)
            out["device_dispatches_per_tick"] = round(
                out["device_dispatches"]
                / max(c.get("device_ticks", 0), 1), 3)
            out["dispatch_serial_equiv"] = sum(
                t["dispatch_serial_equiv"] for t in tn)
            out["dispatch_cut_x"] = round(
                out["dispatch_serial_equiv"]
                / max(out["device_dispatches"], 1), 2)
            out["train_len"] = round(sum(
                t["train_len"] for t in tn) / len(tn), 2)
            out["train_compiles"] = sum(t["train_compiles"] for t in tn)
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
