"""The port's mixed run replay (plain PyTorch version, on the CPU) against
the JAX package's Pallas kernel in interpret mode, bit for bit.

Every case builds its op stream with the JAX package (remote txns from
its oracle and storm generator, compiled by its ``compile_remote_txns``),
carries the same ``OpTensors`` across with ``convert.ops_from_numpy`` and
replays it in both packages, with the fast YATA scan and with the serial
walk alone where the JAX package's own tests run both. All eight outputs
must be equal as numpy arrays (origins as uint32 bit views, state as
int32), error flags and post-error state included, and the expanded
document must reproduce the oracle's text. Tolerance: none — the state is
integers.

Cases share a few shapes (capacity 256 at K = 8, chunk 128, batch 8) so
the JAX package compiles its interpret-mode kernel once per shape.
"""
import dataclasses

import numpy as np
import pytest
from test_torch_remote import j_two_peer_merge

from text_crdt_rust_tpu.models.oracle import ListCRDT as JListCRDT
from text_crdt_rust_tpu.models.sync import export_txns_since as j_export
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import rle as JR
from text_crdt_rust_tpu.ops import rle_mixed as JRM
from text_crdt_rust_tpu.ops import span_arrays as JSA
from text_crdt_rust_tpu.utils.randedit import make_storm as j_make_storm
from text_crdt_rust_tpu.utils.testdata import TestPatch as JPatch
from text_crdt_rust_tpu_torch import convert
from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch.ops import rle as TR
from text_crdt_rust_tpu_torch.ops import rle_mixed as TRM
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA
from text_crdt_rust_tpu_torch.utils import randedit
from text_crdt_rust_tpu_torch.utils.testdata import TestPatch as TPatch

FIELDS = ("ordp", "lenp", "blkord", "rows", "meta", "ol", "orr", "err")
SMALL = dict(capacity=256, block_k=8, chunk=128)


def _compile_txns(txns, lmax=4, dmax=None):
    table = JB.AgentTable(sorted({t.id.agent for t in txns}))
    return JB.compile_remote_txns(txns, table, lmax=lmax, dmax=dmax)[0]


def _oracle_text(txns):
    doc = JListCRDT()
    for t in txns:
        doc.apply_remote_txn(t)
    return doc.to_string()


def _typed(name, see, edit):
    """Txns of one JAX-oracle peer that has seen ``see`` and then makes
    ``edit`` (the helper of ``tests/test_rle_mixed_fast.py``)."""
    doc = JListCRDT()
    agent = doc.get_or_create_agent_id(name)
    for t in see:
        doc.apply_remote_txn(t)
    m = doc.get_next_order()
    edit(doc, agent)
    return j_export(doc, m)


def _merge_appended_windows():
    """``test_merge_appended_or_divergence_window``: a merge-appended
    run later split, probed by a concurrent sibling (two causal
    orders)."""
    t1 = _typed("quin", [], lambda d, g: d.local_insert(g, 0, "XY"))
    t2 = _typed("quin", t1, lambda d, g: d.local_insert(g, 2, "Z"))
    t3 = _typed("cara", t1, lambda d, g: d.local_insert(g, 1, "a"))
    return [[*t1, *t2, *t3], [*t1, *t3, *t2]]


def _split_tail_windows():
    """``test_split_tail_requalifies_as_sibling``: a split tail whose
    origin-right differs from its head run's, classified as a sibling
    (three causal orders)."""
    t1 = _typed("mmm", [], lambda d, g: d.local_insert(g, 0, "ab"))
    t2 = _typed("mmm", t1, lambda d, g: d.local_insert(g, 2, "cd"))
    t3 = _typed("mmm", [*t1, *t2], lambda d, g: d.local_insert(g, 2, "Q"))
    t4 = _typed("zzz", t1, lambda d, g: d.local_insert(g, 2, "z"))
    t5 = _typed("aaa", t1, lambda d, g: d.local_insert(g, 2, "a"))
    return [[*t1, *t2, *t3, *t4, *t5], [*t1, *t2, *t4, *t3, *t5],
            [*t1, *t2, *t5, *t4, *t3]]


def _pseudo_breaker_window():
    """``test_pseudo_breaker_beats_stale_window_kss``: a mid-run window
    start that breaks the scan while a stale kss run waits later."""
    t1 = _typed("mmm", [], lambda d, g: d.local_insert(g, 0, "X"))
    t2 = _typed("mmm", t1, lambda d, g: d.local_insert(g, 1, "Y"))
    t3 = _typed("ppp", t1, lambda d, g: d.local_insert(g, 1, "W"))
    t4 = _typed("zzz", [*t1, *t3], lambda d, g: d.local_insert(g, 1, "z"))
    t5 = _typed("aaa", t1, lambda d, g: d.local_insert(g, 1, "a"))
    return [*t1, *t2, *t3, *t4, *t5]


def _txn_case(txns, shape=SMALL, lmax=4):
    return _compile_txns(txns, lmax=lmax), shape, _oracle_text(txns), None


def _mid_storm():
    txns, _ = j_make_storm(16, 20, 4, seed=7, del_prob=0.35)
    ops = _compile_txns(txns, lmax=8)
    cap = ((max(ops.num_steps * 3, 256) + 31) // 32) * 32
    return ops, dict(capacity=cap, block_k=32, chunk=128), \
        _oracle_text(txns), None


def _local_only():
    p, content = randedit.random_patches(np.random.default_rng(5), 120)
    plist = JB.merge_patches([JPatch(q.pos, q.del_len, q.ins_content)
                              for q in p])
    ops, _ = JB.compile_local_patches(plist, lmax=8, dmax=None)
    return ops, SMALL, content, None


def _overflow():
    ops, _ = JB.compile_local_patches([JPatch(0, 0, "ab")] * 40, lmax=2)
    return ops, dict(capacity=16, block_k=8, chunk=128), None, 0


REMOTE = {
    "small-delete-storm": lambda: _txn_case(
        j_make_storm(3, 4, 2, seed=7, del_prob=0.3)[0]),
    "two-peer-merge-400": lambda: _txn_case(j_two_peer_merge(400)[0]),
    "merge-appended-window-a": lambda: _txn_case(_merge_appended_windows()[0]),
    "merge-appended-window-b": lambda: _txn_case(_merge_appended_windows()[1]),
    "split-tail-window-a": lambda: _txn_case(_split_tail_windows()[0]),
    "split-tail-window-b": lambda: _txn_case(_split_tail_windows()[1]),
    "split-tail-window-c": lambda: _txn_case(_split_tail_windows()[2]),
    "pseudo-breaker-window": lambda: _txn_case(_pseudo_breaker_window()),
    "mid-storm-16x20": _mid_storm,
}
LOCAL = {"local-only": _local_only, "capacity-overflow": _overflow}
CASES = [(n, f) for n in REMOTE for f in (True, False)] + \
    [(n, True) for n in LOCAL]


def _jax_result(ops, shape, fast):
    return JRM.replay_mixed_rle(ops, batch=8, interpret=True,
                                fast_integrate=fast, **shape)


def _port_result(ops, shape, fast):
    tops = convert.ops_from_numpy(
        {f.name: np.asarray(getattr(ops, f.name))
         for f in dataclasses.fields(ops)})
    return tops, TRM.replay_mixed_rle(tops, batch=8, fast_integrate=fast,
                                      device="cpu", **shape)


@pytest.mark.parametrize("name,fast", CASES)
def test_replay_matches_jax(name, fast):
    ops, shape, want, expect_err = {**REMOTE, **LOCAL}[name]()
    jres = _jax_result(ops, shape, fast)
    tops, tres = _port_result(ops, shape, fast)
    got = convert.rle_mixed_result_to_numpy(tres)
    for f in FIELDS:
        j = np.asarray(getattr(jres, f))
        assert got[f].dtype == j.dtype and got[f].shape == j.shape, f
        assert np.array_equal(got[f], j), f
    if expect_err is None:
        jres.check()
        tres.check()
        jdoc = JR.rle_to_flat(ops, jres)
        tdoc = TR.rle_to_flat(tops, tres)
        jcols, tcols = JSA.download(jdoc), TSA.download(tdoc)
        for k, v in jcols.items():
            assert np.array_equal(np.asarray(v), np.asarray(tcols[k])), k
        assert TSA.to_string(tdoc) == want
    else:
        assert got["err"][expect_err].max() == 1
        with pytest.raises(RuntimeError):
            tres.check()


def test_two_peer_merge_drives_the_serial_fallback(monkeypatch):
    """The fast scan's flag must rise on this stream, so the serial walk
    runs inside a fast replay."""
    calls = []
    walk = TRM._PlainMixed.integrate_cursor

    def counted(self, *a):
        calls.append(a)
        return walk(self, *a)

    monkeypatch.setattr(TRM._PlainMixed, "integrate_cursor", counted)
    txns, recv = randedit.make_two_peer_merge(400)
    table = TB.AgentTable(sorted({t.id.agent for t in txns}))
    ops, _ = TB.compile_remote_txns(txns, table, lmax=4)
    res = TRM.replay_mixed_rle(ops, batch=2, device="cpu", **SMALL)
    assert TSA.to_string(TR.rle_to_flat(ops, res)) == recv.to_string()
    assert calls, "the fast scan never fell back to the serial walk"


def test_order_index_miss_fails_check():
    ops, _ = TB.compile_local_patches([TPatch(0, 0, "ab")], lmax=2)
    res = TRM.replay_mixed_rle(ops, capacity=64, batch=2, block_k=8,
                               device="cpu")
    res.check()
    res.err[2] = 1
    with pytest.raises(RuntimeError, match="order index"):
        res.check()
