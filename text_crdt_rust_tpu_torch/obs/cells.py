"""The cost ledger's CPU cells, re-derived on the port: ``serve``,
``flow``, ``recovery``, ``flash-crowd`` and ``fused-trace`` (the cells
``perf/COST_LEDGER.json`` records for the JAX package, at its pinned
shapes; ``perf/cost_ledger_probe.py`` derives them there).

Every metric is a pure function of the seeded workload, so the port's
run of the same workload must reproduce each committed value within its
own ``tol`` (0 for all of these: exact logical counters). Three cells of
the committed ledger are not derived here: ``serve``'s ``hlo`` metrics
(XLA program costs of the JAX package), ``serve-lanes`` (a cost model
replay, ``perf/blocked_lanes_sim.py``) and ``sp`` (the sequence-parallel
engine, not ported).

    from text_crdt_rust_tpu_torch.obs import cells, ledger
    ok, diffs = ledger.diff_ledger(ledger.load_ledger(),
                                   cells.derive_cells(device="cpu"))

Every cell runs on ``device`` (as ``resolve_device``: CUDA unless
``"cpu"`` is named).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

from ..config import ServeConfig
from .ledger import metric

# -- pinned workload shapes (perf/cost_ledger_probe.py:88-127) -----------------
# The committed values are only comparable at these exact shapes.

SEED = 7
SMALL_LOADGEN = dict(docs=6, agents_per_doc=2, ticks=6,
                     events_per_tick=12, zipf_alpha=1.1, fault_rate=0.10,
                     local_prob=0.25, seed=SEED)
SERVE_SHAPE = dict(num_shards=1, lanes_per_shard=4)
SERVE_TRAIN_TICKS = 2  # the serve cell rides a depth-2 tick train
FUSED_TRACE = "automerge-paper"
FUSED_PATCHES = 4000
FUSED_LMAX = ServeConfig().lmax
FUSED_W = 8
#: The recovery cell's crash shape: two shards under eviction pressure,
#: killed post-dispatch mid-run.
CHAOS_SHAPE = dict(num_shards=2, lanes_per_shard=2)
CHAOS_CRASH_TICK = 3
#: Flash-crowd shape: lanes far smaller than the crowd's appetite.
FLASH_TICK = 2
FLASH_DOC = 1
FLASH_SHAPE = dict(num_shards=1, lanes_per_shard=2)

CELLS = ("serve", "flow", "recovery", "flash-crowd", "fused-trace")
#: Committed metrics the port does not derive, by cell: the ``hlo``
#: family, static costs of the JAX package's compiled XLA programs.
NOT_DERIVED = {
    "serve": ("hlo_flat_b8_flops", "hlo_flat_b8_bytes",
              "hlo_flat_b8_collectives", "hlo_flat_b32_flops",
              "hlo_flat_b32_bytes", "hlo_flat_b32_collectives"),
}


def cell_serve(device=None) -> dict:
    """The small seeded flat-engine loadgen at a depth-2 tick train: the
    step, dispatch, prefill, wire, checkpoint, admission, trace and
    fusion economy."""
    from ..serve.loadgen import ServeLoadGen

    cfg = ServeConfig(engine="flat", train_ticks=SERVE_TRAIN_TICKS,
                      **SERVE_SHAPE)
    gen = ServeLoadGen(cfg=cfg, device=device, **SMALL_LOADGEN)
    rep = gen.run()
    if not rep["converged"]:
        raise AssertionError(f"serve cell did not converge: "
                             f"{rep['mismatches'][:4]}")
    tick = rep["tick_ms"]
    srv = rep["server"]
    wire = rep["wire"]
    m = {
        "item_ops_applied": metric(rep["item_ops_applied"], "steps"),
        "steps_total": metric(tick["steps_total"], "steps"),
        "steps_prefuse": metric(tick["steps_prefuse"], "steps"),
        "fused_rows_saved": metric(tick["fused_rows_saved"], "steps"),
        "device_ticks": metric(srv.get("device_ticks", 0), "steps"),
        "device_steps_padded": metric(srv.get("device_steps", 0),
                                      "steps"),
        "device_compiles": metric(srv.get("device_compiles", 0),
                                  "compile"),
        "device_dispatches": metric(tick.get("device_dispatches", 0),
                                    "steps"),
        "device_dispatches_per_tick": metric(
            tick.get("device_dispatches_per_tick", 0.0), "steps"),
        "train_len": metric(tick.get("train_len", 0.0), "steps"),
        "prefill_bytes_per_tick": metric(
            tick.get("prefill_bytes_per_tick", 0.0), "wire"),
        "prefill_bytes_cut_x": metric(
            tick.get("prefill_bytes_cut_x", 0.0), "wire"),
        "prefill_scatter_len": metric(
            tick.get("prefill_scatter_len", 0), "wire"),
        "prefill_scatter_compiles": metric(
            tick.get("prefill_scatter_compiles", 0), "compile"),
        "wire_push_bytes": metric(wire["push_bytes"], "wire"),
        "wire_pull_bytes": metric(wire["pull_bytes"], "wire"),
        "wire_ctrl_bytes": metric(wire["ctrl_bytes"], "wire"),
        "wire_txn_bytes": metric(wire["txn_bytes"], "wire"),
        "ops_replicated": metric(wire["ops_replicated"], "wire"),
        "bytes_per_op": metric(wire["bytes_per_op"], "wire"),
        "evictions": metric(srv.get("evictions", 0), "ckpt"),
        "restores": metric(srv.get("restores", 0), "ckpt"),
        "ckpt_bytes_written": metric(srv.get("ckpt_bytes_written", 0),
                                     "ckpt"),
        "ckpt_saves_delta": metric(srv.get("ckpt_saves_delta", 0),
                                   "ckpt"),
        "ckpt_saves_full": metric(srv.get("ckpt_saves_full", 0), "ckpt"),
        "ckpt_bytes_per_evict_mean": metric(
            srv.get("ckpt_bytes_per_evict_mean", 0.0), "ckpt"),
        "admitted": metric(srv.get("admitted", 0), "admission"),
        "admitted_items": metric(srv.get("admitted_items", 0),
                                 "admission"),
        "rejected_frame_rejected": metric(
            srv.get("rejected_frame_rejected", 0), "admission"),
        "codec_failures": metric(srv.get("obs_failures_codec", 0),
                                 "admission"),
        "trace_events": metric(rep["obs"]["trace_events"], "trace"),
        "bundles_written": metric(rep["obs"]["bundles_written"],
                                  "trace"),
        "bundles_suppressed": metric(rep["obs"]["bundles_suppressed"],
                                     "trace"),
    }
    for k in sorted(tick):
        if k.startswith("fuse_"):
            m[k] = metric(tick[k], "fuse")
    return {
        "kind": "cpu",
        "workload": {**SMALL_LOADGEN, **SERVE_SHAPE, "engine": "flat",
                     "train_ticks": SERVE_TRAIN_TICKS,
                     "wire": cfg.wire_format, "ckpt": cfg.ckpt_format},
        "metrics": m,
    }


def _flow_metrics(rep: dict) -> dict:
    """The ``flow`` family off a loadgen report's flow block: span
    terminal-state census and op-age-at-apply percentiles, all exact.
    The audit must be green before anything is recorded."""
    f = rep["flow"]
    if not f["audit_ok"] or f["spans"]["in_flight"]:
        raise AssertionError(f"flow audit not green: {f['findings'][:4]}")
    m = {
        "flow_events": metric(f["flow_events"], "flow"),
        "spans_emitted": metric(f["spans"]["emitted"], "flow"),
        "spans_applied": metric(f["spans"]["applied"], "flow"),
        "spans_rejected": metric(f["spans"]["rejected"], "flow"),
        "spans_in_flight": metric(f["spans"]["in_flight"], "flow"),
        "dup_applies": metric(f["duplicates"], "flow"),
        "applies_device": metric(f["applies"]["device"], "flow"),
        "applies_host": metric(f["applies"]["host"], "flow"),
        "age_p50_ticks": metric(f["ages_ticks"]["p50"], "flow"),
        "age_p99_ticks": metric(f["ages_ticks"]["p99"], "flow"),
        "age_max_ticks": metric(f["ages_ticks"]["max"], "flow"),
    }
    for band, st in f["by_band"].items():
        if st["count"]:
            m[f"age_{band}_p50_ticks"] = metric(st["p50"], "flow")
            m[f"age_{band}_p99_ticks"] = metric(st["p99"], "flow")
    for cls, st in f["by_class"].items():
        if st["count"]:
            key = cls.replace("-", "_")
            m[f"age_{key}_count"] = metric(st["count"], "flow")
            m[f"age_{key}_p50_ticks"] = metric(st["p50"], "flow")
    return m


def cell_flow(device=None) -> dict:
    """Per-op provenance: the small seeded loadgen at FULL flow sampling
    — span census and op-age-at-apply in exact logical ticks."""
    from ..serve.loadgen import ServeLoadGen

    cfg = ServeConfig(engine="flat", flow_sample_mod=1, **SERVE_SHAPE)
    gen = ServeLoadGen(cfg=cfg, device=device, **SMALL_LOADGEN)
    rep = gen.run()
    if not rep["converged"]:
        raise AssertionError(f"flow cell did not converge: "
                             f"{rep['mismatches'][:4]}")
    return {
        "kind": "cpu",
        "workload": {**SMALL_LOADGEN, **SERVE_SHAPE, "engine": "flat",
                     "flow_sample_mod": 1},
        "metrics": _flow_metrics(rep),
    }


def cell_recovery(device=None) -> dict:
    """Durability: the pinned post-dispatch crash — recover a fresh
    server from the journal, resume, and require byte-identity to the
    uncrashed twin and green crash-boundary audits before recording the
    journal's byte bill and replay economy."""
    from ..serve.chaos import run_crash_scenario

    cell = run_crash_scenario(
        "post-dispatch", CHAOS_CRASH_TICK,
        ticks=SMALL_LOADGEN["ticks"] + 3, docs=SMALL_LOADGEN["docs"],
        agents_per_doc=SMALL_LOADGEN["agents_per_doc"],
        events_per_tick=SMALL_LOADGEN["events_per_tick"], seed=SEED,
        fault_rate=SMALL_LOADGEN["fault_rate"], device=device,
        **CHAOS_SHAPE)
    green = (cell["identical"] and cell["converged"]
             and cell["twin_converged"]
             and cell["at_recovery_audit"]["audit_ok"]
             and cell["final_audit"]["audit_ok"])
    if not green:
        raise AssertionError("recovery cell not green: recovered streams "
                             "diverged or a crash audit failed")
    rec = cell["recover"]
    wire = cell["report"]["wire"]
    jper = cell["journal_bytes_per_op"]
    m = {
        "journal_records": metric(rec["records"], "recovery"),
        "journal_refusals": metric(rec["refusals"], "recovery"),
        "replayed_ops": metric(rec["ops"], "recovery"),
        "replayed_txns": metric(rec["txns_replayed"], "recovery"),
        "replayed_locals": metric(rec["locals_replayed"], "recovery"),
        "replayed_frames": metric(rec["frames_replayed"], "recovery"),
        "replayed_polls": metric(rec["polls_replayed"], "recovery"),
        "ticks_to_recover": metric(rec["ticks"], "recovery"),
        "docs_readmitted": metric(rec["docs"], "recovery"),
        "journal_bytes": metric(cell["journal_bytes"], "recovery"),
        "journal_ops": metric(cell["journal_ops"], "recovery"),
        "journal_bytes_per_op": metric(jper, "recovery"),
        "wire_txn_bytes_per_op": metric(wire["bytes_per_op"], "wire"),
        "journal_vs_wire_txn_x": metric(
            round(jper / wire["bytes_per_op"], 3), "recovery"),
    }
    return {
        "kind": "cpu",
        "workload": {**SMALL_LOADGEN, **CHAOS_SHAPE,
                     "ticks": SMALL_LOADGEN["ticks"] + 3,
                     "phase": "post-dispatch",
                     "crash_tick": CHAOS_CRASH_TICK, "fsync_ticks": 1},
        "metrics": m,
    }


def cell_flash_crowd(device=None) -> dict:
    """Flash crowd: from FLASH_TICK on, 90% of every tick's events slam
    doc FLASH_DOC while the lanes are far too small for it — the hot doc
    rides the overflow-degrade path and thrashes eviction/restore, and
    the run still converges."""
    from ..serve.loadgen import ServeLoadGen

    cfg = ServeConfig(engine="flat", lane_capacity=128,
                      order_capacity=256, **FLASH_SHAPE)
    gen = ServeLoadGen(cfg=cfg, device=device,
                       **{**SMALL_LOADGEN, "ticks": 10,
                          "events_per_tick": 24},
                       flash_crowd=(FLASH_TICK, FLASH_DOC))
    rep = gen.run()
    if not rep["converged"]:
        raise AssertionError(f"flash-crowd cell did not converge: "
                             f"{rep['mismatches'][:4]}")
    c = gen.server.counters
    srv = rep["server"]
    if not c.get("lane_overflow_degraded"):
        raise AssertionError("flash shape never overflowed — the cell "
                             "tests nothing")
    hot = gen.worlds[FLASH_DOC]
    m = {
        "item_ops_applied": metric(rep["item_ops_applied"], "steps"),
        "hot_doc_chars": metric(len(hot.twin), "steps"),
        "lane_overflow_degraded": metric(
            c.get("lane_overflow_degraded"), "admission"),
        "evictions": metric(srv.get("evictions", 0), "ckpt"),
        "restores": metric(srv.get("restores", 0), "ckpt"),
        "ckpt_bytes_written": metric(srv.get("ckpt_bytes_written", 0),
                                     "ckpt"),
        "rejected_submissions": metric(rep["rejected_submissions"],
                                       "admission"),
        "wire_txn_bytes": metric(rep["wire"]["txn_bytes"], "wire"),
    }
    return {
        "kind": "cpu",
        "workload": {**SMALL_LOADGEN, **FLASH_SHAPE, "ticks": 10,
                     "events_per_tick": 24, "lane_capacity": 128,
                     "order_capacity": 256,
                     "flash_crowd": f"{FLASH_TICK}:{FLASH_DOC}"},
        "metrics": m,
    }


def cell_fused_trace(device=None) -> dict:
    """Generalized step fusion over a pinned real-trace prefix compiled
    at the serve lmax (host-only; ``device`` is unused)."""
    from ..ops import batch as B
    from ..utils.testdata import (
        flatten_patches,
        load_testing_data,
        trace_path,
    )

    patches = flatten_patches(
        load_testing_data(trace_path(FUSED_TRACE)))[:FUSED_PATCHES]
    ops, _ = B.compile_local_patches(patches, lmax=FUSED_LMAX, dmax=None)
    _fused, fs = B.fuse_steps(ops, fuse_w=FUSED_W)
    m = {
        "steps_prefuse": metric(fs.steps_in, "fuse"),
        "steps_fused": metric(fs.steps_out, "fuse"),
        "rows_saved": metric(fs.rows_saved, "fuse"),
        "reduction_x": metric(round(fs.reduction_x, 3), "fuse"),
    }
    for shape, n in sorted(fs.fused.items()):
        m[f"fuse_{shape}"] = metric(n, "fuse")
    return {
        "kind": "cpu",
        "workload": {"trace": FUSED_TRACE, "patches": FUSED_PATCHES,
                     "lmax": FUSED_LMAX, "fuse_w": FUSED_W},
        "metrics": m,
    }


_BUILDERS = {"serve": cell_serve, "flow": cell_flow,
             "recovery": cell_recovery, "flash-crowd": cell_flash_crowd,
             "fused-trace": cell_fused_trace}


def derive_cells(names: Optional[Iterable[str]] = None,
                 device=None) -> Dict[str, dict]:
    """The named cells (all of ``CELLS`` by default), freshly derived."""
    return {n: _BUILDERS[n](device=device) for n in (names or CELLS)}


def committed_view(ledger: dict, name: str) -> dict:
    """One committed cell without the metrics the port does not derive
    (``NOT_DERIVED``), ready for ``ledger.diff_cell``."""
    cell = dict(ledger["cells"][name])
    skip = set(NOT_DERIVED.get(name, ()))
    cell["metrics"] = {k: v for k, v in cell["metrics"].items()
                       if k not in skip}
    return cell
