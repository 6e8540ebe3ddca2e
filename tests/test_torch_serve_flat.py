"""The port's flat serve backend (``FlatLaneBackend`` on the flat engine's
plain version, on the CPU) against the JAX package's (XLA on the CPU).

The same seeded small loadgen drives a JAX server and a port server; after
every ``apply`` of every backend both log the carried ``[B, CAP]`` state
(``signed``, the four by-order logs, ``n``, ``next_order``) and the host
mirrors (``_n_host``, ``_next_order_host``, the pending train sums and
lanes, the buffered tick count), and the two logs must be equal entry for
entry, at pipeline depths 1 and 2 and train lengths 1, 2 and 4. The runs'
records (logical report, every document, trace sha256) must be equal too;
across train lengths they equal the train-length-1 record on everything
but the dispatch economy (``TRAIN_KEYS``). The direct cases pin the
backend's surface: construction through ``ServeConfig()``, the
pending-aware capacity gate, the overflow flag and the train clamps.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from text_crdt_rust_tpu.config import ServeConfig as JServeConfig
from text_crdt_rust_tpu.serve.loadgen import ServeLoadGen as JLoadGen
from text_crdt_rust_tpu_torch.config import ServeConfig
from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch.serve import DocServer
from text_crdt_rust_tpu_torch.serve.batcher import (
    FlatLaneBackend,
    make_lane_backend,
)
from text_crdt_rust_tpu_torch.serve.loadgen import ServeLoadGen

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests" / "data"))

import make_serve_golden as golden  # noqa: E402

SMALL = dict(docs=10, agents_per_doc=2, ticks=8, events_per_tick=10,
             zipf_alpha=1.1, fault_rate=0.10, local_prob=0.25, seed=11)
SMALL_CFG = dict(engine="flat", num_shards=2, lanes_per_shard=3,
                 lane_capacity=128, order_capacity=512,
                 step_buckets=(8, 32), max_txn_len=32)

#: The report fields that count device dispatches and scatter shapes: the
#: only logical fields a tick train changes (it launches T ticks at once).
TRAIN_KEYS = ("device_dispatches", "device_dispatches_per_tick",
              "dispatch_cut_x", "train_len", "train_compiles",
              "train_ticks", "prefill_bytes_per_tick",
              "prefill_bytes_cut_x", "prefill_scatter_compiles")


def train_invariant(record: dict) -> dict:
    """A golden record without its dispatch-economy fields."""
    out = dict(record)
    lg = dict(record["logical"])
    lg.pop("train", None)
    lg["prefill"] = {k: v for k, v in lg["prefill"].items()
                     if k not in ("bytes_per_tick", "bytes_cut_x",
                                  "scatter_compiles")}
    lg["tick_ms"] = {k: v for k, v in lg["tick_ms"].items()
                     if k not in TRAIN_KEYS}
    lg["server"] = {k: v for k, v in lg["server"].items()
                    if k.replace("tick_ms_", "") not in TRAIN_KEYS}
    out["logical"] = lg
    return out


def _snap(backend, cols) -> dict:
    """Copies of the carried state and the host mirrors right now (both
    backends edit some of them in place later)."""
    snap = cols(backend.docs)
    snap.update(n_host=backend._n_host, next_host=backend._next_order_host,
                pending_n=backend._pending_n, pending_o=backend._pending_o,
                pending_active=backend._pending_active,
                buffered=len(backend._train_buf))
    return {k: np.array(v, copy=True) for k, v in snap.items()}


def _jax_cols(docs) -> dict:
    return {"signed": np.asarray(docs.signed).astype(np.int32),
            **{f: np.asarray(getattr(docs, f)).astype(np.uint32)
               for f in ("ol_log", "or_log", "rank_log", "chars_log")},
            "n": np.asarray(docs.n).astype(np.int64),
            "next_order": np.asarray(docs.next_order).astype(np.int64)}


def _port_cols(docs) -> dict:
    return {"signed": docs.signed.numpy().astype(np.int32),
            **{f: getattr(docs, f).numpy().view(np.uint32)
               for f in ("ol_log", "or_log", "rank_log", "chars_log")},
            "n": docs.n.numpy().astype(np.int64),
            "next_order": docs.next_order.numpy().astype(np.int64)
            & 0xFFFF_FFFF}


def _record_applies(server, cols, log: list) -> None:
    for shard, backend in enumerate(server.residency.backends):
        def wrap(apply, backend=backend, shard=shard):
            def rec(stacked):
                apply(stacked)
                log.append((shard, _snap(backend, cols)))
            return rec
        backend.apply = wrap(backend.apply)


def _runs(depth: int, train: int):
    jcfg = JServeConfig(pipeline_ticks=depth, train_ticks=train,
                        trace_keep=True, **SMALL_CFG)
    jgen = JLoadGen(cfg=jcfg, **SMALL)
    jlog: list = []
    _record_applies(jgen.server, _jax_cols, jlog)
    jrep = jgen.run()
    tcfg = ServeConfig(pipeline_ticks=depth, train_ticks=train,
                       trace_keep=True, **SMALL_CFG)
    tgen = ServeLoadGen(cfg=tcfg, device="cpu", **SMALL)
    tlog: list = []
    _record_applies(tgen.server, _port_cols, tlog)
    trep = tgen.run()
    assert jrep["converged"] and trep["converged"], trep["mismatches"]
    return (jlog, golden.record_of(jgen, jrep)), \
        (tlog, golden.record_of(tgen, trep))


@pytest.fixture(scope="module")
def serial_record():
    """The JAX package's train-length-1 record at depth 1 (the reference
    every train length must reproduce)."""
    return golden.jax_record(SMALL, SMALL_CFG, 1)


@pytest.mark.parametrize("depth,train", [(1, 1), (1, 2), (1, 4), (2, 1),
                                         (2, 2), (2, 4)])
def test_backend_equals_the_jax_one_after_every_apply(serial_record, depth,
                                                      train):
    (jlog, jrec), (tlog, trec) = _runs(depth, train)
    assert len(tlog) == len(jlog) > 0
    for i, ((js, jsnap), (ts, tsnap)) in enumerate(zip(jlog, tlog)):
        assert js == ts, f"apply {i}: shard order"
        for k in jsnap:
            np.testing.assert_array_equal(
                tsnap[k], jsnap[k], err_msg=f"apply {i} shard {ts}: {k}")
    assert trec == jrec
    # The logical stream does not depend on the train length.
    assert train_invariant(trec) == train_invariant(serial_record)
    assert trec["trace_sha256"] == serial_record["trace_sha256"]


def test_default_config_builds_the_flat_backend():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DocServer(ServeConfig())
    srv = DocServer(ServeConfig(), device="cpu")
    assert all(isinstance(b, FlatLaneBackend)
               for b in srv.residency.backends)
    assert [b.lanes for b in srv.residency.backends] == [16, 16]
    b = srv.residency.backends[0]
    assert b.docs.signed.shape == (16, 512)
    assert b.docs.ol_log.shape == (16, 1536)
    assert not b.dispatch_reads_device and b.max_pipeline_ticks == 8
    srv.close_obs()
    with pytest.raises(ValueError, match="unknown engine"):
        make_lane_backend("definitely-not-an-engine", lanes=2, capacity=64,
                          order_capacity=128, lmax=4, device="cpu")
    # ``rle`` is registered (configs northstar, 2 and 3) but serves no
    # lanes, as in the JAX package's registry.
    with pytest.raises(ValueError, match="no serve lane backend"):
        make_lane_backend("rle", lanes=2, capacity=64, order_capacity=128,
                          lmax=4, device="cpu")


def _insert_tick(i: int, ins: int, lmax: int = 4) -> TB.OpTensors:
    """One single-lane [S=1, B=1] tick: a local insert of ``ins`` chars."""
    one = TB.pad_ops(TB.empty_ops(lmax), 1)
    one = dataclasses.replace(
        one, ins_len=np.full((1,), ins, np.uint32),
        order_advance=np.full((1,), ins, np.uint32),
        ins_order_start=np.full((1,), 1 + ins * i, np.uint32),
        rows_per_step=np.ones((1,), np.uint32))
    return TB.stack_ops([one])


def test_pending_aware_host_gate_refuses_overflow_trains():
    be = FlatLaneBackend(lanes=1, capacity=8, order_capacity=64, lmax=4,
                         device="cpu")
    be.set_train_ticks(4)
    be.apply(_insert_tick(0, 4))
    assert len(be._train_buf) == 1     # buffered, not dispatched
    with pytest.raises(AssertionError, match="capacity"):
        be.apply(_insert_tick(1, 8))   # 4 pending + 8 > 8
    be.apply(_insert_tick(1, 4))       # 4 + 4 == 8 still fits
    be.flush_train()
    assert int(be._n_host[0]) == 8 and int(be.docs.n[0]) == 8
    assert not be._train_buf and not be._train_flags


def test_overflow_flag_raises_at_drain():
    be = FlatLaneBackend(lanes=1, capacity=8, order_capacity=64, lmax=4,
                         device="cpu")
    be._train_flags.append((torch.ones(1, dtype=torch.int32), None))
    with pytest.raises(RuntimeError, match="overflow flag"):
        be._drain_train_flags(block=True)


def test_train_depth_clamps_and_buckets():
    srv = DocServer(ServeConfig(num_shards=1, lanes_per_shard=2,
                                train_ticks=16), device="cpu")
    assert srv.batcher.effective_train_ticks() == 8
    srv.close_obs()
    srv = DocServer(ServeConfig(num_shards=1, lanes_per_shard=2,
                                train_ticks=4, device_prefill=False),
                    device="cpu")
    assert srv.batcher.effective_train_ticks() == 1
    assert srv.residency.backends[0].dispatch_reads_device
    srv.close_obs()
    for t, want in ((1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8)):
        assert FlatLaneBackend._train_bucket(t) == want, t


def test_host_prefill_path_equals_device_prefill():
    """``device_prefill=False`` (the host log round trip) gives the same
    documents and trace as the default delta scatter."""
    recs = []
    for dp in (True, False):
        cfg = ServeConfig(device_prefill=dp, trace_keep=True, **SMALL_CFG)
        gen = ServeLoadGen(cfg=cfg, device="cpu", **SMALL)
        rep = gen.run()
        assert rep["converged"]
        recs.append(golden.record_of(gen, rep))
    assert recs[0]["docs"] == recs[1]["docs"]
    assert recs[0]["trace_sha256"] == recs[1]["trace_sha256"]
