"""The port's write-ahead journal, crash recovery and crash harness (on the
flat engine's plain version, on the CPU) against the JAX package's.

- Storage: the journal cases of ``tests/test_serve_recovery.py`` (round
  trip, reopen, torn-tail and bit-flip sweeps, reopen repair, dead-segment
  quarantine, header refusal) run on both packages' ``journal`` modules,
  and the same records give byte-identical segment files.
- A journaled loadgen run writes byte-identical segments in both packages.
- Recovery: a clean shutdown re-executes byte-identically; a torn journal
  recovers, and its post-recovery records survive a second crash.
- Chaos: ``run_crash_scenario`` at all four ``PHASES`` at the ``recovery``
  ledger cell's shape (and a crash right after a tick train), each
  identical to its uncrashed twin with green crash audits, and with the
  JAX package's ``logical_stream_digest``; ``--crash-at`` through the CLI.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from text_crdt_rust_tpu.config import ServeConfig as JServeConfig
from text_crdt_rust_tpu.serve import chaos as JChaos
from text_crdt_rust_tpu.serve import journal as JJ
from text_crdt_rust_tpu.serve.loadgen import ServeLoadGen as JLoadGen
from text_crdt_rust_tpu_torch.config import ServeConfig
from text_crdt_rust_tpu_torch.obs import cells
from text_crdt_rust_tpu_torch.serve import chaos as TChaos
from text_crdt_rust_tpu_torch.serve import journal as TJ
from text_crdt_rust_tpu_torch.serve.loadgen import ServeLoadGen
from text_crdt_rust_tpu_torch.serve.server import DocServer

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": JJ, "port": TJ}

#: The ``recovery`` ledger cell's crash shape.
CHAOS = dict(ticks=cells.SMALL_LOADGEN["ticks"] + 3,
             docs=cells.SMALL_LOADGEN["docs"],
             agents_per_doc=cells.SMALL_LOADGEN["agents_per_doc"],
             events_per_tick=cells.SMALL_LOADGEN["events_per_tick"],
             seed=cells.SEED, fault_rate=cells.SMALL_LOADGEN["fault_rate"],
             **cells.CHAOS_SHAPE)


# -- journal storage contract --------------------------------------------------


def _small_journal(J, d):
    jr = J.Journal(d, num_shards=1)
    jr.admit(0, "docA")
    jr.frame(0, "docA", b"\x07payload")
    jr.local(0, "docA", "editor", 3, 1, "xy", 0)
    jr.tick(1)
    jr.admit(0, "docB")
    jr.poll(0, "docB")
    jr.tick(2)
    jr.close()
    records, errors = J.scan(d)
    assert not errors
    return records


def _segments(d):
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


def test_same_records_give_byte_identical_segments(tmp_path):
    got = {}
    for name, J in PACKAGES.items():
        d = str(tmp_path / name)
        _small_journal(J, d)
        J.Journal(d, num_shards=1).close()  # reopen: a second segment
        got[name] = _segments(d)
    assert got["port"] == got["jax"] and len(got["port"]) >= 1


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_journal_roundtrip_and_reopen(tmp_path, pkg):
    J = PACKAGES[pkg]
    d = str(tmp_path / "jr")
    records = _small_journal(J, d)
    assert [r.kind for r in records] == [
        J.REC_ADMIT, J.REC_FRAME, J.REC_LOCAL, J.REC_TICK, J.REC_ADMIT,
        J.REC_POLL, J.REC_TICK]
    assert J.decode_frame_body(records[1].body) == ("docA", b"\x07payload")
    assert J.decode_local_body(records[2].body) == \
        ("docA", "editor", 3, 1, "xy", 0)
    top = records[-1].seq
    jr = J.Journal(d, num_shards=1)
    jr.admit(0, "docC")
    jr.close()
    records2, errors = J.scan(d)
    assert not errors and records2[-1].seq == top + 1
    assert len({r.segment for r in records2}) == 2


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_journal_torn_tail_and_bitflip_sweeps(tmp_path, pkg):
    J = PACKAGES[pkg]
    d = str(tmp_path / "jr")
    records = _small_journal(J, d)
    last = records[-1]
    seg = last.segment
    pristine = open(seg, "rb").read()
    refused = []
    for cut in range(last.offset + 1, len(pristine)):
        with open(seg, "wb") as fh:
            fh.write(pristine[:cut])
        got, errors = J.scan(d)
        assert [r.seq for r in got] == [r.seq for r in records[:-1]]
        assert len(errors) == 1 and errors[0].offset == last.offset
        assert errors[0].segment == seg
        refused.append(errors[0].reason)
    for at in range(last.offset, len(pristine)):
        mutated = bytearray(pristine)
        mutated[at] ^= 0x01
        with open(seg, "wb") as fh:
            fh.write(bytes(mutated))
        got, errors = J.scan(d)
        assert [r.seq for r in got] == [r.seq for r in records[:-1]]
        assert errors and all(isinstance(e, J.JournalError)
                              for e in errors)
        refused.append(errors[0].reason)
    with open(seg, "wb") as fh:
        fh.write(pristine)
    assert refused


def test_sweeps_refuse_with_the_same_reasons(tmp_path):
    """Both packages refuse every torn/flipped tail with the same typed
    reason at the same offset."""
    out = {}
    for name, J in PACKAGES.items():
        d = str(tmp_path / name)
        records = _small_journal(J, d)
        seg = records[-1].segment
        pristine = open(seg, "rb").read()
        seen = []
        for at in range(records[-1].offset, len(pristine)):
            for mutated in (pristine[:at], bytes(
                    b ^ (1 if i == at else 0)
                    for i, b in enumerate(pristine))):
                with open(seg, "wb") as fh:
                    fh.write(mutated)
                _, errors = J.scan(d)
                seen.append([(os.path.basename(e.segment), e.offset,
                              e.reason) for e in errors])
        out[name] = seen
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_journal_repairs_and_quarantine(tmp_path, pkg):
    J = PACKAGES[pkg]
    d = str(tmp_path / "jr")
    records = _small_journal(J, d)
    last = records[-1]
    size = os.path.getsize(last.segment)
    with open(last.segment, "r+b") as fh:
        fh.truncate(last.offset + max(1, (size - last.offset) // 2))
    jr = J.Journal(d, num_shards=1)
    assert [e.offset for e in jr.repair_errors] == [last.offset]
    jr.admit(0, "docC")
    jr.close()
    got, errors = J.scan(d)
    assert not errors and got[-1].body.decode() == "docC"
    assert os.path.exists(last.segment + ".refused")
    # A refused EARLY segment quarantines the segments behind it.
    d2 = str(tmp_path / "jr2")
    jr = J.Journal(d2, num_shards=1, rotate_bytes=1)
    for i, doc in enumerate(("docA", "docB", "docC")):
        jr.admit(0, doc)
        jr.tick(i + 1)
    jr.close()
    segs = sorted({r.segment for r in J.scan(d2)[0]})
    assert len(segs) == 3
    pristine = open(segs[0], "rb").read()
    with open(segs[0], "wb") as fh:
        fh.write(b"XXXX" + pristine[4:])
    assert "magic" in J.scan(d2)[1][0].reason
    jr2 = J.Journal(d2, num_shards=1, rotate_bytes=1)
    assert len(jr2.repair_errors) == 3
    jr2.admit(0, "docD")
    jr2.close()
    got, errors = J.scan(d2)
    assert not errors
    assert [r.body.decode() for r in got if r.kind == J.REC_ADMIT] == \
        ["docD"]


# -- journaled runs ----------------------------------------------------------------


RUN = dict(docs=6, agents_per_doc=2, ticks=6, events_per_tick=10, seed=13,
           fault_rate=0.10)


def _journaled(tmp_path, tag, cfg_cls, gen_cls, **kw):
    cfg = cfg_cls(num_shards=2, lanes_per_shard=2,
                  journal_dir=str(tmp_path / tag / "journal"),
                  spool_dir=str(tmp_path / tag / "spool"))
    gen = gen_cls(cfg=cfg, **RUN, **kw)
    report = gen.run()
    assert report["converged"], report["mismatches"]
    return cfg, gen


def test_journaled_run_writes_the_jax_segments(tmp_path):
    jcfg, jgen = _journaled(tmp_path, "j", JServeConfig, JLoadGen)
    tcfg, tgen = _journaled(tmp_path, "t", ServeConfig, ServeLoadGen,
                            device="cpu")
    j, t = _segments(jcfg.journal_dir), _segments(tcfg.journal_dir)
    assert list(t) == list(j) and t == j
    assert sum(len(v) for v in t.values()) > 1000
    assert JChaos.logical_stream_digest(jgen.server) == \
        TChaos.logical_stream_digest(tgen.server)


def test_recover_after_clean_shutdown_and_refusals(tmp_path):
    cfg, gen = _journaled(tmp_path, "t", ServeConfig, ServeLoadGen,
                          device="cpu")
    want = TChaos.logical_stream_digest(gen.server)
    assert gen.server.counters.get("journal_bytes") > 0
    with pytest.raises(ValueError, match="fresh server"):
        gen.server.recover()
    srv = DocServer(ServeConfig(num_shards=2, lanes_per_shard=2,
                                journal_dir=cfg.journal_dir,
                                spool_dir=cfg.spool_dir), device="cpu")
    stats = srv.recover()
    assert stats["refusals"] == 0 and stats["docs"] == RUN["docs"]
    assert stats["ops"] > 0 and stats["ticks"] > 0
    assert stats["shard_mismatches"] == 0 and stats["local_gaps"] == 0
    assert TChaos.logical_stream_digest(srv) == want
    srv.close_obs()
    bare = DocServer(ServeConfig(num_shards=1, lanes_per_shard=2),
                     device="cpu")
    with pytest.raises(ValueError, match="journal_dir"):
        bare.recover()
    bare.close_obs()


def test_crash_recover_crash_recover(tmp_path):
    cfg, _ = _journaled(tmp_path, "t", ServeConfig, ServeLoadGen,
                        device="cpu")
    assert TChaos.tear_last_record(cfg.journal_dir, shard=0) is not None

    def server():
        return DocServer(ServeConfig(num_shards=2, lanes_per_shard=2,
                                     journal_dir=cfg.journal_dir,
                                     spool_dir=cfg.spool_dir),
                         device="cpu")

    s2 = server()
    st2 = s2.recover()
    assert st2["refusals"] >= 1
    doc_id = sorted(s2.router.docs)[0]
    for i in range(3):
        s2.submit_local(doc_id, "survivor", 0, 0, f"post{i} ")
        s2.tick()
    s2.flush_pipeline()
    want = TChaos.logical_stream_digest(s2)
    s3 = server()
    st3 = s3.recover()
    assert st3["refusals"] == 0
    assert st3["locals_replayed"] >= st2["locals_replayed"] + 3
    s3.flush_pipeline()
    assert TChaos.logical_stream_digest(s3) == want
    s3.close_obs()


# -- the crash harness ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_twin_digest():
    """The JAX package's uncrashed run at the recovery cell's shape."""
    kw = {k: v for k, v in CHAOS.items()}
    return JChaos.uncrashed_twin_digest(**kw)


def _assert_green(cell):
    assert cell["identical"], (cell["digest"], cell["twin_digest"])
    assert cell["converged"] and cell["twin_converged"] is not False
    assert cell["at_recovery_audit"]["audit_ok"], \
        cell["at_recovery_audit"]["findings"]
    assert cell["final_audit"]["audit_ok"], cell["final_audit"]["findings"]


@pytest.mark.parametrize("phase", TChaos.PHASES)
def test_crash_phase_is_identical_to_its_twin(jax_twin_digest, phase):
    cell = TChaos.run_crash_scenario(phase, cells.CHAOS_CRASH_TICK,
                                     device="cpu", **CHAOS)
    _assert_green(cell)
    assert cell["digest"] == jax_twin_digest
    assert cell["recover"]["ops"] > 0 and cell["recover_wall_s"] is None
    if phase == "mid-journal":
        assert cell["torn"] and cell["recover"]["refusals"] >= 1


def test_crash_right_after_a_tick_train(jax_twin_digest):
    """Killed after the tick that closes a train of 2, recovered at a
    train length of 4: the journal's per-tick markers make train length a
    wall-clock knob, so the streams equal the uncrashed twin's."""
    cell = TChaos.run_crash_scenario(
        "post-dispatch", cells.CHAOS_CRASH_TICK, device="cpu",
        train_ticks=2, recover_train_ticks=4, **CHAOS)
    _assert_green(cell)
    assert cell["digest"] == jax_twin_digest


def test_crash_at_through_the_cli():
    out = subprocess.run(
        [sys.executable, "-m", "text_crdt_rust_tpu_torch.serve.loadgen",
         "--docs", "6", "--agents", "2", "--ticks", "8",
         "--events-per-tick", "10", "--shards", "2", "--lanes", "2",
         "--crash-at", "post-dispatch:3", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    cell = json.loads(out.stdout)
    assert cell["identical"] and cell["converged"]
    assert cell["phase"] == "post-dispatch" and cell["crash_tick"] == 3
    bad = subprocess.run(
        [sys.executable, "-m", "text_crdt_rust_tpu_torch.serve.loadgen",
         "--crash-at", "nope:3", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "PHASE:TICK" in bad.stderr
