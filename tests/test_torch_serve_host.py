"""The serve slice's host layers against the JAX package's, on the CPU:
the wire codec (row and columnar frames, byte for byte, and the refusals
of corrupt frames), the fault channel, the sync layer's digests and
watermarks, the metrics, admission decisions, the tracer's event stream
and the checkpoint files. The same seeded inputs go through both
packages; every comparison is exact."""
import dataclasses
import random

import numpy as np
import pytest

from text_crdt_rust_tpu.models.oracle import ListCRDT as JListCRDT
from text_crdt_rust_tpu.models import sync as JS
from text_crdt_rust_tpu.net import codec as JC
from text_crdt_rust_tpu.net import columnar as JCol
from text_crdt_rust_tpu.net.faults import FaultSpec as JSpec
from text_crdt_rust_tpu.net.faults import FaultyChannel as JChannel
from text_crdt_rust_tpu.obs.registry import MetricsRegistry as JRegistry
from text_crdt_rust_tpu.obs.trace import Tracer as JTracer
from text_crdt_rust_tpu.serve.admission import AdmissionControl as JAdm
from text_crdt_rust_tpu.serve.admission import AdmissionError as JAdmErr
from text_crdt_rust_tpu.utils import checkpoint as JCk
from text_crdt_rust_tpu.utils.integrity import crc32c as jcrc
from text_crdt_rust_tpu.utils.metrics import percentiles as jpct
from text_crdt_rust_tpu.utils.randedit import random_patches
from text_crdt_rust_tpu_torch.convert import txns_from_dicts
from text_crdt_rust_tpu_torch.models import sync as TS
from text_crdt_rust_tpu_torch.models.oracle import ListCRDT as TListCRDT
from text_crdt_rust_tpu_torch.net import codec as TC
from text_crdt_rust_tpu_torch.net import columnar as TCol
from text_crdt_rust_tpu_torch.net.faults import FaultSpec as TSpec
from text_crdt_rust_tpu_torch.net.faults import FaultyChannel as TChannel
from text_crdt_rust_tpu_torch.net.session import DeviceMirror
from text_crdt_rust_tpu_torch.obs.registry import MetricsRegistry as TRegistry
from text_crdt_rust_tpu_torch.obs.trace import Tracer as TTracer
from text_crdt_rust_tpu_torch.serve.admission import AdmissionControl as TAdm
from text_crdt_rust_tpu_torch.serve.admission import AdmissionError as TAdmErr
from text_crdt_rust_tpu_torch.utils import checkpoint as TCk
from text_crdt_rust_tpu_torch.utils.integrity import crc32c as tcrc
from text_crdt_rust_tpu_torch.utils.metrics import Throughput
from text_crdt_rust_tpu_torch.utils.metrics import percentiles as tpct


def _jax_doc(seed: int, steps: int = 14, peers: int = 2) -> JListCRDT:
    """A seeded multi-peer JAX oracle document (the JAX codec tests'
    recipe)."""
    rng = random.Random(seed)
    docs = []
    for p in range(peers):
        doc = JListCRDT()
        agent = doc.get_or_create_agent_id(f"peer-{seed}-{p}")
        patches, _ = random_patches(rng, steps)
        for patch in patches:
            if patch.del_len:
                doc.local_delete(agent, patch.pos, patch.del_len)
            if patch.ins_content:
                doc.local_insert(agent, patch.pos, patch.ins_content)
        docs.append(doc)
    for other in docs[1:]:
        JS.merge_into(docs[0], other)
    return docs[0]


def _both_txns(seed: int, **kw):
    jt = JS.export_txns_since(_jax_doc(seed, **kw), 0)
    return jt, txns_from_dicts([dataclasses.asdict(t) for t in jt])


def _port_doc(txns) -> TListCRDT:
    doc = TListCRDT()
    for t in txns:
        doc.apply_remote_txn(t)
    return doc


@pytest.mark.parametrize("seed", range(6))
def test_frames_byte_identical_and_decode_alike(seed):
    jt, tt = _both_txns(seed, peers=1 + seed % 3)
    assert [dataclasses.asdict(t) for t in tt] == \
        [dataclasses.asdict(t) for t in jt]
    pairs = [
        (JC.encode_txns(jt), TC.encode_txns(tt)),
        (JCol.encode_txns(jt), TCol.encode_txns(tt)),
        (JCol.encode_mux([("a", jt[:3]), ("b", jt[3:])]),
         TCol.encode_mux([("a", tt[:3]), ("b", tt[3:])])),
        (JC.encode_request({"x": 3, "peer": seed}),
         TC.encode_request({"x": 3, "peer": seed})),
    ]
    for jf, tf in pairs:
        assert jf == tf
        jk, jv, _ = JC.decode_frame(jf)
        tk, tv, _ = TC.decode_frame(tf)
        assert jk == tk
        if jk in (JC.KIND_TXNS, JC.KIND_TXNS_MUX):
            flat = (lambda v: [dataclasses.asdict(t) for t in v]) \
                if jk == JC.KIND_TXNS else \
                (lambda v: [(d, [dataclasses.asdict(t) for t in ts])
                            for d, ts in v])
            assert flat(jv) == flat(tv)
        else:
            assert jv == tv
    # Streams split at the same frame boundaries.
    assert JCol.encode_txns_stream(jt, 3) == TCol.encode_txns_stream(tt, 3)


@pytest.mark.parametrize("seed", range(4))
def test_corrupt_frames_refused_alike(seed):
    """Bit flips and truncations of valid frames: both packages refuse
    with ``CodecError`` and the same message, or both accept."""
    jt, tt = _both_txns(seed, steps=6, peers=2)
    rng = random.Random(seed)
    for frame in (TC.encode_txns(tt), TCol.encode_txns(tt),
                  TC.encode_digest({"a": 3, "b": 9}, 1234)):
        cases = [frame[:cut] for cut in range(0, len(frame), 3)]
        for _ in range(40):
            buf = bytearray(frame)
            buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
            cases.append(bytes(buf))
        for data in cases:
            outcome = []
            for mod in (JC, TC):
                try:
                    kind, _, _ = mod.decode_frame(data)
                    outcome.append(("ok", kind))
                except mod.CodecError as e:
                    outcome.append(("refused", str(e)))
            assert outcome[0] == outcome[1], data


def test_fault_channel_identical_on_one_seed():
    jt, tt = _both_txns(5)
    frames = [TC.encode_txns(tt[i:i + 2]) for i in range(0, len(tt), 2)]
    jch = JChannel(spec=JSpec.all(0.2), seed=99)
    tch = TChannel(spec=TSpec.all(0.2), seed=99)
    outs = []
    for ch in (jch, tch):
        got = []
        for f in frames * 4:
            ch.send(f)
            got.extend(ch.drain())
        outs.append(got)
    assert outs[0] == outs[1]
    assert jch.counters == tch.counters
    assert tch.counters["dropped"] > 0 and tch.counters["bitflipped"] > 0


@pytest.mark.parametrize("seed", range(5))
def test_digests_watermarks_and_exports_equal(seed):
    jdoc = _jax_doc(seed, peers=3)
    jt = JS.export_txns_since(jdoc, 0)
    tdoc = _port_doc(txns_from_dicts([dataclasses.asdict(t) for t in jt]))
    jtwin = JListCRDT()
    for t in jt:
        jtwin.apply_remote_txn(t)
    assert TS.state_digest(tdoc) == JS.state_digest(jtwin)
    assert TS.agent_watermarks(tdoc) == JS.agent_watermarks(jtwin)
    assert ({(r.agent, r.seq) for r in TS.remote_frontier(tdoc)}
            == {(r.agent, r.seq) for r in JS.remote_frontier(jtwin)})
    wants = {n: w // 2 for n, w in JS.agent_watermarks(jtwin).items()}
    assert [dataclasses.asdict(t) for t in
            TS.export_txns_for_wants(tdoc, wants)] == \
        [dataclasses.asdict(t) for t in JS.export_txns_for_wants(jtwin,
                                                                  wants)]
    # merge_into: a fresh port replica merges the replayed doc.
    fresh = TListCRDT()
    assert TS.merge_into(fresh, tdoc) == JS.merge_into(JListCRDT(), jtwin)
    assert fresh.to_string() == jtwin.to_string()


def test_percentiles_crc_and_registry_equal():
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 100):
        xs = rng.normal(size=n).tolist()
        assert tpct(xs, (1, 50, 90, 99)) == jpct(xs, (1, 50, 90, 99))
    data = bytes(rng.integers(0, 256, 300, dtype=np.uint8))
    assert tcrc(data) == jcrc(data) and tcrc(data, 7) == jcrc(data, 7)
    regs = (JRegistry(), TRegistry())
    for reg in regs:
        for i in range(50):
            reg.incr("a", i % 3)
            reg.hiwater("hw", i * 7 % 40)
            reg.histo("lat", float(i * 13 % 17), cap=16)
            reg.gauge("g", i)
            reg.sample("fill", i / 50.0)
    assert regs[0].summary() == regs[1].summary()
    assert regs[0].prometheus_text() == regs[1].prometheus_text()
    assert regs[0].to_jsonl() == regs[1].to_jsonl()


def test_throughput_reads_only_the_callers_clock():
    ticks = iter([1.0, 3.5, 10.0, 10.5])
    meter = Throughput(lambda: next(ticks))
    with meter.measure(ops=100):
        pass
    with meter.measure(ops=50):
        pass
    assert meter.summary() == {"ops": 150, "seconds": 3.0,
                               "ops_per_sec": 50.0, "samples": 2}


def test_admission_decisions_equal():
    kw = dict(max_queue_per_doc=4, max_queue_global=9, max_txn_len=6,
              rate_capacity=10, rate_refill=3)
    outcomes = []
    for Adm, Err in ((JAdm, JAdmErr), (TAdm, TAdmErr)):
        adm = Adm(counters=None, **kw)
        got = []
        rng = random.Random(4)
        for i in range(200):
            doc, agent = f"d{rng.randrange(3)}", f"a{rng.randrange(4)}"
            items = rng.randint(1, 8)
            try:
                adm.admit(doc, agent, items, rng.randrange(6), i // 10,
                          seq=i)
                adm.enqueued()
                got.append("ok")
            except Err as e:
                got.append((e.reason, str(e)))
            if adm.global_pending and rng.random() < 0.4:
                adm.dequeued()
        got.append(str(adm.reject_frame("bad crc", doc="d0")))
        got.append(str(adm.reject_unknown_doc("zz")))
        outcomes.append((got, adm.counters.summary(), adm.global_pending))
    assert outcomes[0] == outcomes[1]
    assert any(o != "ok" for o in outcomes[1][0])


def _drive_tracer(tr):
    tr.set_tick(3)
    tr.event("tick.drain", shard=0, events=4, steps=9, wall={"ms": 1.5})
    with tr.span("tick.barrier", shard=1):
        pass
    tr.event("apply", doc="d", ev="txn", agent="a", seq=2, n=3)
    tr.set_tick(4)
    tr.event("residency.evict", doc="d", ckpt="full", bytes=120)
    with pytest.raises(ValueError):
        tr.event("tick.drain", shard=0)
    return tr.logical_bytes(), list(tr.ring)


def test_tracer_event_stream_equal():
    """Same calls, same logical stream; the port's span walls come only
    from the caller's clock."""
    jb, _ = _drive_tracer(JTracer(keep_all=True))
    tb, ring = _drive_tracer(TTracer(keep_all=True))
    assert jb == tb
    assert "w" not in ring[2]    # the span: no clock, no wall
    clock = iter([2.0, 2.25])
    _, ring = _drive_tracer(TTracer(keep_all=True,
                                    clock=lambda: next(clock)))
    assert ring[2]["w"] == {"ms": 250.0}


def test_checkpoint_files_identical(tmp_path):
    jdoc = _jax_doc(11, peers=2)
    jt = JS.export_txns_since(jdoc, 0)
    tdoc = _port_doc(txns_from_dicts([dataclasses.asdict(t) for t in jt]))
    jtwin = JListCRDT()
    for t in jt:
        jtwin.apply_remote_txn(t)
    infos = []
    for mod, doc, name in ((JCk, jtwin, "j"), (TCk, tdoc, "t")):
        info = mod.save_doc(doc, str(tmp_path / f"{name}.npz"),
                            extra_meta={"doc_id": "d"})
        chain = mod.CheckpointChain(str(tmp_path / f"{name}c"))
        chain.save(doc)
        infos.append((info["bytes"], chain.base_info["bytes"]))
    assert infos[0] == infos[1]
    assert (tmp_path / "j.npz").read_bytes() == \
        (tmp_path / "t.npz").read_bytes()
    back = TCk.load_doc(str(tmp_path / "j.npz"))
    assert back.to_string() == jtwin.to_string()
    assert TS.state_digest(back) == JS.state_digest(jtwin)
    raw = bytearray((tmp_path / "t.npz").read_bytes())
    raw[len(raw) // 2] ^= 0x10
    (tmp_path / "bad.npz").write_bytes(bytes(raw))
    with pytest.raises(TCk.CheckpointError):
        TCk.load_doc(str(tmp_path / "bad.npz"))


def test_device_mirror_waits_for_the_flat_slice():
    """The flat slice is in: the mirror builds on the flat engine, raises
    without CUDA unless the CPU is named, and tracks a session's doc."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceMirror(64)
    mirror = DeviceMirror(64, agents=("alice",), device="cpu")
    assert mirror.doc.capacity == 64 and not mirror.degraded
