"""The port's mixed-stream blocked replay (A10, plain PyTorch version, on
the CPU) against the JAX package's Pallas kernel ``_mixed_kernel`` in
interpret mode, bit for bit, and the config-4 storm on
``engine="blocked-mixed"`` at smoke size.

The cases are those of ``tests/test_blocked_mixed.py`` (capacity 64-1,024,
K = 8-32, batch 8, chunk 128): the root tiebreak, two-peer merges,
fragmented and double remote deletes, local/remote convergence, the
interleaved storm (rebalances between remote lookups: stale hints, the
full-state fallback and its healing), the long chunked delete, a
local-only stream against A8, and an unknown delete target (``err[2]``).
Each case compiles its txns with the JAX package and replays the same
``OpTensors`` in both; ``signed``, ``rows``, ``ol``, ``orr`` and ``err``
compare in full. Tolerance: none, the state is integers.
"""
import dataclasses
import random

import numpy as np
import pytest

from text_crdt_rust_tpu.common import (
    RemoteDel,
    RemoteId,
    RemoteIns,
    RemoteTxn,
)
from text_crdt_rust_tpu.models.sync import export_txns_since
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import blocked_mixed as JBM
from text_crdt_rust_tpu_torch import storm
from text_crdt_rust_tpu_torch.ops import blocked as TBL
from text_crdt_rust_tpu_torch.ops import blocked_mixed as TBM
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA

from test_device_flat import oracle_from_patches, random_patches
from test_torch_blocked import (
    assert_blocked_equal,
    assert_flat_equal,
    compile_local,
    port_ops,
)

ROOT = RemoteId("ROOT", 0xFFFFFFFF)
GEOM = dict(batch=8, chunk=128)


def compile_txns(txns, lmax=4, dmax=16):
    table = JB.AgentTable()
    for t in txns:
        table.add(t.id.agent)
        for op in t.ops:
            if hasattr(op, "id"):
                table.add(op.id.agent)
    return JB.compile_remote_txns(txns, table, lmax=lmax, dmax=dmax)[0]


def _both(jops, capacity, block_k):
    jres = JBM.replay_mixed(jops, capacity=capacity, block_k=block_k,
                            interpret=True, **GEOM)
    tres = TBM.replay_mixed(port_ops(jops), capacity=capacity,
                            block_k=block_k, device="cpu", **GEOM)
    assert_blocked_equal(jres, tres)
    return jres, tres


def _oracle_text(txns):
    from text_crdt_rust_tpu.models.oracle import ListCRDT
    doc = ListCRDT()
    for t in txns:
        doc.apply_remote_txn(t)
    return doc.to_string()


def _two_peer(seed):
    rng = random.Random(seed)
    pa, _ = random_patches(rng, 40)
    pb, _ = random_patches(rng, 40)
    a = oracle_from_patches(pa, agent="peer-a")
    b = oracle_from_patches(pb, agent="peer-b")
    return export_txns_since(a, 0) + export_txns_since(b, 0)


def _fragmented_double():
    base = RemoteTxn(id=RemoteId("amy", 0), parents=[],
                     ops=[RemoteIns(ROOT, ROOT, "abcdef")])
    d1 = RemoteTxn(id=RemoteId("bob", 0), parents=[RemoteId("amy", 5)],
                   ops=[RemoteDel(RemoteId("amy", 1), 3)])
    d2 = RemoteTxn(id=RemoteId("cat", 0), parents=[RemoteId("amy", 5)],
                   ops=[RemoteDel(RemoteId("amy", 2), 3)])
    return [base, d1, d2]


def _convergence():
    patches, _ = random_patches(random.Random(5), 60)
    return export_txns_since(oracle_from_patches(patches, agent="conv"), 0)


def _interleaved():
    rng = random.Random(99)
    txns = []
    for name in ("ada", "bea", "cyd", "dot"):
        patches, _ = random_patches(rng, 25)
        txns.extend(export_txns_since(oracle_from_patches(patches,
                                                          agent=name), 0))
    return txns


def _long_delete():
    base = RemoteTxn(id=RemoteId("amy", 0), parents=[],
                     ops=[RemoteIns(ROOT, ROOT, "x" * 50)])
    kill = RemoteTxn(id=RemoteId("bob", 0), parents=[RemoteId("amy", 49)],
                     ops=[RemoteDel(RemoteId("amy", 5), 40)])
    return [base, kill]


CASES = {
    "root-tiebreak": lambda: ([
        RemoteTxn(id=RemoteId(name, 0), parents=[],
                  ops=[RemoteIns(ROOT, ROOT, text)])
        for name, text in [("zed", "zz"), ("amy", "aa"), ("mia", "mm")]],
        4, 64, 8),
    "two-peer-s3": lambda: (_two_peer(3), 4, 512, 16),
    "two-peer-s21": lambda: (_two_peer(21), 4, 512, 16),
    "fragmented-double-delete": lambda: (_fragmented_double(), 4, 64, 8),
    "local-remote-convergence": lambda: (_convergence(), 4, 512, 16),
    "storm-interleaved-peers": lambda: (_interleaved(), 4, 1024, 16),
    "long-remote-delete-chunked": lambda: (_long_delete(), 16, 128, 32),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_matches_jax(name):
    txns, lmax, capacity, block_k = CASES[name]()
    jops = compile_txns(txns, lmax=lmax)
    jres, tres = _both(jops, capacity, block_k)
    assert not np.asarray(jres.err).any()
    assert TBL.lanes_equal(tres)
    td = assert_flat_equal(jops, jres, tres)
    assert TSA.to_string(td) == _oracle_text(txns)


def test_local_stream_equals_a8():
    jops = compile_local(random_patches(random.Random(13), 60)[0])
    jres, tres = _both(jops, 512, 16)
    a8 = TBL.replay_local(port_ops(jops), capacity=512, block_k=16,
                          device="cpu", **GEOM)
    for f in ("signed", "rows", "ol", "orr", "err"):
        assert np.array_equal(getattr(a8, f).numpy(),
                              getattr(tres, f).numpy()), f


def test_unknown_order_flags_err2():
    """A remote delete of orders no item has: the hinted block misses,
    the full-state search misses (``err[2]``), and the unresolved targets
    raise ``err[1]``; the post-error state is the JAX kernel's."""
    jops = compile_txns([_long_delete()[0]], lmax=16)
    fields = {f.name: np.asarray(getattr(jops, f.name))
              for f in dataclasses.fields(jops)}
    fields = {k: np.concatenate([v, np.zeros((1,) + v.shape[1:], v.dtype)])
              for k, v in fields.items()}
    fields["kind"][-1] = JB.KIND_REMOTE_DEL
    fields["del_len"][-1] = 3
    fields["del_target"][-1] = 90
    fields["rows_per_step"][-1] = 1
    bad = JB.OpTensors(**fields)
    jres, tres = _both(bad, 128, 32)
    err = tres.err.numpy()
    assert err[2].all() and err[1].all() and not err[0].any()
    with pytest.raises(RuntimeError, match="past the end"):
        tres.check()


def test_unchunked_remote_deletes_rejected():
    jops = compile_txns(_long_delete(), lmax=16, dmax=None)
    with pytest.raises(ValueError, match="<= 16 targets"):
        TBM.make_replayer_mixed(port_ops(jops), capacity=128, block_k=32,
                                device="cpu")


def test_run_storm_blocked_mixed_matches_the_oracle():
    run = storm.run_storm(4, 10, 2, engine="blocked-mixed", batch=8,
                          device="cpu")
    assert run.ok and TSA.to_string(run.doc) == run.stream.want
    res = run.result
    assert isinstance(res, TBL.BlockedResult) and TBL.lanes_equal(res)
    # bench.py's geometry: 80 chars -> capacity 512, K = 256.
    assert (res.signed.shape, res.block_k) == ((512, 8), 256)
    jres = JBM.replay_mixed(run.stream.ops, capacity=512, batch=8,
                            block_k=256, chunk=1024, interpret=True)
    assert_blocked_equal(jres, res)


def test_run_storm_blocked_mixed_replays_the_delete_storm():
    run = storm.run_storm(4, 10, 2, del_prob=0.35, engine="blocked-mixed",
                          batch=8, device="cpu")
    assert run.ok and TBL.lanes_equal(run.result)
    assert (np.asarray(run.stream.ops.kind) == JB.KIND_REMOTE_DEL).any()
    jres = JBM.replay_mixed(run.stream.ops, capacity=512, batch=8,
                            block_k=256, chunk=1024, interpret=True)
    assert_blocked_equal(jres, run.result)
    with pytest.raises(ValueError, match="unknown engine"):
        storm.make_storm_replayer(None, engine="flat", device="cpu")


def test_storm_cli_blocked_mixed(capsys):
    assert storm.main(["--rounds", "4", "--batch", "2", "--device", "cpu",
                       "--engine", "blocked-mixed"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and '"ok": true' in out[0]
    assert '"engine": "blocked-mixed"' in out[0]
