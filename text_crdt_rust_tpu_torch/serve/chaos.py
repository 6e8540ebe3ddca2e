"""Deterministic crash-injection harness (counterpart of
``text_crdt_rust_tpu/serve/chaos.py``).

The durability claim of `serve/journal` is only worth what its failure
modes are tested against.  This module kills a journaled loadgen run at
seeded, named phases of the tick loop, recovers a fresh ``DocServer``
from the surviving journal + checkpoint spool, resumes the SAME
generation state (worlds, rng, fault channels — real clients survive a
server death), and compares the post-recovery logical streams against
an uncrashed same-seed twin.  The oracle is byte-identity: recovery is
re-execution of the input log, so every doc's content AND state digest
must match the twin exactly — "close" is a bug.

Kill phases (``PHASES``):

- ``post-admit``     — the crash tick's submissions are journaled but
                       its ``server.tick()`` never runs (no TICK
                       marker): recovery must re-derive the tick from
                       the bare op records.
- ``post-dispatch``  — the crash tick completes, including pipelined
                       dispatch; the server dies before the NEXT tick
                       would sync it.  Recovery replays through the
                       marker and the staged syncs re-derive.
- ``mid-ckpt``       — post-admit, plus the newest eviction checkpoint
                       file in the spool is truncated mid-write.
                       ``rediscover`` must refuse it loudly; replay
                       re-derives the doc from genesis anyway.
- ``mid-journal``    — post-dispatch, plus shard 0's final record is
                       torn mid-bytes (a power cut inside ``write``).
                       The torn tail is dropped with a typed refusal;
                       the TICK marker is duplicated to every shard so
                       the tick still replays (and even with one shard
                       the resume loop below re-runs it live).

Loudness proof: ``drop_journal_record`` rewrites a segment WITHOUT one
op record, re-chaining the CRCs so the drop is undetectable to the
scanner — the at-recovery conservation audit
(`obs.flow.audit_crash_spans`) must then report a crash-leak.  That
audit, not the digest (anti-entropy would heal the content), is the
detector the acceptance bar demands.

Every run takes ``device`` (as ``resolve_device``: CUDA unless ``"cpu"``
is named) and the caller's ``clock`` (``Callable[[], float]`` in
seconds); without a clock ``recover_wall_s`` is None and nothing else
changes.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
from typing import Callable, Dict, Optional, Tuple

from ..config import ServeConfig
from ..obs.flow import audit_crash_spans
from ..utils.integrity import crc32c
from . import journal as J
from .loadgen import ServeLoadGen
from .server import DocServer

PHASES = ("post-admit", "post-dispatch", "mid-ckpt", "mid-journal")


class CrashSignal(BaseException):
    """The injected kill.  Deliberately a ``BaseException``: a real
    crash (SIGKILL, power cut) is not an ``Exception`` the tick loop's
    typed-error handling may catch and absorb — the batcher's
    ``flush_pipeline`` path must trigger on it and nothing else."""


def logical_stream_digest(server: DocServer) -> str:
    """One hash over every doc's logical stream: content + CRDT state
    digest, in doc-id order.  Two servers with equal digests hold
    byte-identical documents."""
    h = hashlib.sha256()
    for doc_id in sorted(server.router.docs):
        server.ensure_resident(doc_id)
        h.update(doc_id.encode("utf-8"))
        h.update(b"\x00")
        h.update(server.doc_string(doc_id).encode("utf-8"))
        h.update(b"\x00")
        h.update(str(server.doc_digest(doc_id)).encode("utf-8"))
        h.update(b"\x00")
    return h.hexdigest()


# -- fault injectors ---------------------------------------------------------


def truncate_newest_checkpoint(spool_dir: str) -> Optional[str]:
    """Simulate a crash mid-checkpoint-write: cut the newest spool file
    (highest allocation number) in half.  ``rediscover`` must refuse it
    with a typed error, not crash or silently load garbage."""
    cands = [n for n in sorted(os.listdir(spool_dir))
             if n.startswith("doc_") and n.endswith(".npz")]
    if not cands:
        return None
    path = os.path.join(spool_dir, max(cands))
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(max(1, size // 2))
    return path


def tear_last_record(journal_dir: str, shard: int = 0) -> Optional[str]:
    """Simulate a power cut mid-append: truncate the given shard's
    newest segment in the middle of its final record.  The scanner must
    keep the valid prefix and refuse the torn tail by name."""
    records, _ = J.scan(journal_dir)
    mine = [r for r in records if r.shard == shard]
    if not mine:
        return None
    # Segment names embed a zero-padded index, so the lexicographic max
    # is the newest; within it the final record extends to EOF.
    last = max(mine, key=lambda r: (r.segment, r.offset))
    size = os.path.getsize(last.segment)
    cut = last.offset + max(1, (size - last.offset) // 2)
    with open(last.segment, "r+b") as fh:
        fh.truncate(cut)
    return last.segment


def drop_journal_record(journal_dir: str, kind: int = J.REC_TXNS,
                        nth: int = 0) -> Optional[int]:
    """Rewrite a segment WITHOUT its ``nth`` record of ``kind``,
    re-chaining the CRCs so the scanner cannot tell.  This is the
    loudness injection: a journal that silently loses an acked op must
    be caught by the crash-boundary conservation audit, because nothing
    at the storage layer can.  Returns the dropped record's global seq,
    or None if no such record exists."""
    records, _ = J.scan(journal_dir)
    victims = [r for r in records if r.kind == kind]
    if nth >= len(victims):
        return None
    victim = victims[nth]
    keep = sorted((r for r in records
                   if r.segment == victim.segment and r.seq != victim.seq),
                  key=lambda r: r.offset)
    out = bytearray(J._segment_header(victim.shard))
    crc = 0
    for r in keep:
        rec = bytearray()
        J._write_varint(rec, r.seq)
        rec.append(r.kind)
        J._write_varint(rec, len(r.body))
        rec += r.body
        crc = crc32c(bytes(rec), crc)
        rec += crc.to_bytes(4, "little")
        out += rec
    with open(victim.segment, "wb") as fh:
        fh.write(bytes(out))
    return victim.seq


# -- the scenario ------------------------------------------------------------


def run_crash_scenario(phase: str, crash_tick: int, *,
                       ticks: int = 12, docs: int = 16,
                       agents_per_doc: int = 2, events_per_tick: int = 12,
                       seed: int = 7, fault_rate: float = 0.10,
                       num_shards: int = 2, lanes_per_shard: int = 2,
                       ckpt_format: str = "delta", fsync_ticks: int = 1,
                       byzantine: float = 0.0,
                       flash_crowd: Optional[Tuple[int, int]] = None,
                       drop_record_kind: Optional[int] = None,
                       workdir: Optional[str] = None,
                       run_twin: bool = True,
                       twin_digest: Optional[str] = None,
                       train_ticks: int = 1,
                       recover_train_ticks: Optional[int] = None,
                       device=None,
                       clock: Optional[Callable[[], float]] = None
                       ) -> Dict[str, object]:
    """One kill-and-recover cycle at ``phase`` during loadgen tick
    ``crash_tick`` (0-based), resumed to ``ticks``, checked against an
    uncrashed same-seed twin.  Returns the scenario report; asserts
    nothing itself so tests and the ledger probe can pin their own
    expectations (``identical``, audits, recovery stats)."""
    if phase not in PHASES:
        raise ValueError(f"unknown crash phase {phase!r}")
    if not 0 < crash_tick < ticks - 1:
        raise ValueError("crash_tick must leave room to resume "
                         "(0 < crash_tick < ticks-1)")
    own_workdir = workdir is None
    if own_workdir:
        workdir = tempfile.mkdtemp(prefix="tcr-chaos-")
    dirs = {name: os.path.join(workdir, name)
            for name in ("journal", "spool", "twin-journal", "twin-spool")}
    # Tick trains: the victim and twin run at ``train_ticks``; recovery replays the journal at ``recover_train_ticks``
    # (default: same) — the journal's per-tick markers make train
    # length a pure wall-clock knob, so a journal written at one length
    # must recover sha-identical at ANY other.
    base_cfg = dict(num_shards=num_shards, lanes_per_shard=lanes_per_shard,
                    ckpt_format=ckpt_format, journal_fsync_ticks=fsync_ticks,
                    flow_sample_mod=1, train_ticks=train_ticks)
    gen_kwargs = dict(docs=docs, agents_per_doc=agents_per_doc, ticks=ticks,
                      events_per_tick=events_per_tick, seed=seed,
                      fault_rate=fault_rate, byzantine=byzantine,
                      flash_crowd=flash_crowd, device=device, clock=clock)

    try:
        # -- the victim run, up to the kill point ------------------------
        cfg = ServeConfig(journal_dir=dirs["journal"],
                          spool_dir=dirs["spool"], **base_cfg)
        gen = ServeLoadGen(cfg=cfg, **gen_kwargs)
        gen.start()
        gen.run_ticks(0, crash_tick)

        if phase in ("post-admit", "mid-ckpt"):
            # Die INSIDE the crash tick: its submissions hit the journal
            # but the device tick (and the TICK marker) never happen.
            def _killed_tick():
                raise CrashSignal(phase)
            gen.server.tick = _killed_tick
            try:
                gen.run_tick(crash_tick)
            except CrashSignal:
                gen.server.tracer.event("chaos.crash", phase=phase)
            else:
                raise AssertionError("kill point was never reached")
        else:
            # Die AFTER the crash tick completed (dispatch done, marker
            # written) but before anything else syncs the pipeline.
            stats = gen.run_tick(crash_tick)
            gen._applied += stats["ops_applied"]
            gen._steps += stats["steps"]
            gen.server.tracer.event("chaos.crash", phase=phase)
        # The crash: abandon the server object — no flush, no close, no
        # drain.  In-flight pipelined ticks die dispatched-but-unsynced;
        # the journal keeps only what its per-append flush pushed out.
        pre_flow = list(gen.server.flow.records)
        dead_counters = {
            "journal_bytes": gen.server.counters.get("journal_bytes"),
            "journal_ops": gen.server.counters.get("journal_ops"),
        }

        if phase == "mid-ckpt":
            torn = truncate_newest_checkpoint(dirs["spool"])
        elif phase == "mid-journal":
            torn = tear_last_record(dirs["journal"], shard=0)
        else:
            torn = None
        dropped_seq = None
        if drop_record_kind is not None:
            dropped_seq = drop_journal_record(dirs["journal"],
                                              kind=drop_record_kind)

        # -- recovery ----------------------------------------------------
        cfg2_kw = dict(base_cfg)
        if recover_train_ticks is not None:
            cfg2_kw["train_ticks"] = recover_train_ticks
        cfg2 = ServeConfig(journal_dir=dirs["journal"],
                           spool_dir=dirs["spool"], **cfg2_kw)
        server2 = DocServer(cfg2, device=device, clock=clock)
        t0 = clock() if clock is not None else None
        rstats = server2.recover()
        gen.server = server2
        while server2.tick_no < crash_tick + 1:
            # Recovery's last step: the crash tick's device work never
            # ran or left no surviving marker (post-admit, mid-ckpt, a
            # one-shard run whose only TICK record was torn) — its ops
            # ARE journaled and queued, so re-derive the tick live.
            stats = server2.tick()
            gen._applied += stats["ops_applied"]
            gen._steps += stats["steps"]
        recover_wall_s = (None if t0 is None
                          else round(clock() - t0, 4))
        # At-recovery loudness gate: every span applied before the crash
        # must be covered by a replayed apply NOW — before any client
        # resumes and the anti-entropy cycle gets a chance to quietly
        # heal a journal hole.  A dropped op record shows up here: no
        # re-derived tick can apply an op that never reached a queue.
        at_recovery = audit_crash_spans(pre_flow, server2.flow.records)

        # -- resume the surviving clients against the recovered server ---
        gen.run_ticks(crash_tick + 1, ticks)
        report = gen.finalize()
        final_audit = audit_crash_spans(pre_flow, server2.flow.records,
                                        expect_terminal=True)
        digest = logical_stream_digest(server2)

        # -- the uncrashed same-seed twin --------------------------------
        # The twin is phase-independent (same seed, no crash), so the
        # crash matrix computes it ONCE per fault rate and passes its
        # digest in instead of re-running it for every kill phase.
        twin_converged = None
        if run_twin and twin_digest is None:
            cfg_t = ServeConfig(journal_dir=dirs["twin-journal"],
                                spool_dir=dirs["twin-spool"], **base_cfg)
            twin = ServeLoadGen(cfg=cfg_t, **gen_kwargs)
            twin.start()
            twin.run_ticks(0, ticks)
            twin_report = twin.finalize()
            twin_digest = logical_stream_digest(twin.server)
            twin_converged = bool(twin_report["converged"])

        journal_bytes = dead_counters["journal_bytes"]
        journal_ops = dead_counters["journal_ops"]
        return {
            "phase": phase,
            "crash_tick": crash_tick,
            "ticks": ticks,
            "fault_rate": fault_rate,
            "identical": (digest == twin_digest) if run_twin else None,
            "digest": digest,
            "twin_digest": twin_digest,
            "converged": bool(report["converged"]),
            "twin_converged": twin_converged,
            "recover": dict(rstats),
            "recover_wall_s": recover_wall_s,
            "at_recovery_audit": at_recovery,
            "final_audit": final_audit,
            "torn": torn,
            "dropped_seq": dropped_seq,
            "journal_bytes": journal_bytes,
            "journal_ops": journal_ops,
            "journal_bytes_per_op": round(
                journal_bytes / max(1, journal_ops), 2),
            "report": report,
        }
    finally:
        if own_workdir:
            shutil.rmtree(workdir, ignore_errors=True)


def uncrashed_twin_digest(*, ticks, docs, agents_per_doc,
                          events_per_tick, seed, fault_rate,
                          num_shards, lanes_per_shard,
                          ckpt_format: str = "delta",
                          fsync_ticks: int = 1, device=None) -> str:
    """The logical-stream digest of a full uncrashed run at the given
    shape — the oracle every crash cell at that shape compares to."""
    workdir = tempfile.mkdtemp(prefix="tcr-twin-")
    try:
        cfg = ServeConfig(journal_dir=os.path.join(workdir, "journal"),
                          spool_dir=os.path.join(workdir, "spool"),
                          num_shards=num_shards,
                          lanes_per_shard=lanes_per_shard,
                          ckpt_format=ckpt_format,
                          journal_fsync_ticks=fsync_ticks,
                          flow_sample_mod=1)
        gen = ServeLoadGen(cfg=cfg, docs=docs,
                           agents_per_doc=agents_per_doc, ticks=ticks,
                           events_per_tick=events_per_tick, seed=seed,
                           fault_rate=fault_rate, device=device)
        rep = gen.run()
        if not rep["converged"]:
            raise AssertionError(f"twin did not converge: "
                                 f"{rep['mismatches'][:4]}")
        return logical_stream_digest(gen.server)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run_crash_matrix(*, phases=PHASES, fault_rates=(0.0, 0.10),
                     crash_tick: int = 4, ticks: int = 10,
                     docs: int = 16, agents_per_doc: int = 2,
                     events_per_tick: int = 12, seed: int = 7,
                     num_shards: int = 2, lanes_per_shard: int = 2,
                     ckpt_format: str = "delta",
                     verbose: bool = False, device=None,
                     clock: Optional[Callable[[], float]] = None
                     ) -> Dict[str, object]:
    """Every kill phase x fault rate; a cell is green when the
    recovered server's logical streams are byte-identical to the twin,
    the run converged, and both crash-boundary audits pass.  The twin
    is computed once per fault rate (it is phase-independent)."""
    shape = dict(ticks=ticks, docs=docs, agents_per_doc=agents_per_doc,
                 events_per_tick=events_per_tick, seed=seed,
                 num_shards=num_shards, lanes_per_shard=lanes_per_shard,
                 ckpt_format=ckpt_format)
    cells: Dict[str, dict] = {}
    ok = True
    for rate in fault_rates:
        twin = uncrashed_twin_digest(fault_rate=rate, device=device,
                                     **shape)
        for phase in phases:
            cell = run_crash_scenario(
                phase, crash_tick, fault_rate=rate, twin_digest=twin,
                device=device, clock=clock, **shape)
            green = (bool(cell["identical"]) and cell["converged"]
                     and cell["at_recovery_audit"]["audit_ok"]
                     and cell["final_audit"]["audit_ok"])
            cells[f"{phase}@{rate}"] = {
                "green": green,
                "identical": cell["identical"],
                "converged": cell["converged"],
                "at_recovery_ok": cell["at_recovery_audit"]["audit_ok"],
                "final_audit_ok": cell["final_audit"]["audit_ok"],
                "replayed_ops": cell["recover"]["ops"],
                "replayed_records": cell["recover"]["records"],
                "replayed_ticks": cell["recover"]["ticks"],
                "refusals": cell["recover"]["refusals"],
                "readmissions": cell["recover"]["readmissions"],
                "recover_wall_s": cell["recover_wall_s"],
                "journal_bytes": cell["journal_bytes"],
                "journal_ops": cell["journal_ops"],
                "journal_bytes_per_op": cell["journal_bytes_per_op"],
                "torn": cell["torn"],
            }
            ok = ok and green
    return {"ok": ok, "cells": cells}
