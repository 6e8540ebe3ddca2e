"""The port's remote-op host layer against the JAX package's, field for
field: the storm generator, the oracle document, its txn export and the
remote-txn compiler.

The same seeds go through both packages (``make_storm`` and the two-peer
merge draw from ``random.Random(seed)`` in both); txns compare as
``dataclasses.asdict`` dicts, compiled streams as numpy arrays, oracle
state as texts, doc spans and logs. Tolerance: none — everything here is
integers and strings.
"""
import dataclasses
import random

import numpy as np
import pytest

from text_crdt_rust_tpu.models.oracle import ListCRDT as JListCRDT
from text_crdt_rust_tpu.models.sync import export_txns_since as j_export
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.utils.randedit import make_storm as j_make_storm
from text_crdt_rust_tpu_torch import convert
from text_crdt_rust_tpu_torch.models.oracle import ListCRDT as TListCRDT
from text_crdt_rust_tpu_torch.models.sync import export_txns_since as t_export
from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch.utils import randedit

STORMS = {
    "delete-storm-3x4": dict(n_peers=3, rounds=4, run_len=2, seed=7,
                             del_prob=0.3),
    "insert-storm-4x8": dict(n_peers=4, rounds=8, run_len=3, seed=7),
    "delete-storm-4x10": dict(n_peers=4, rounds=10, run_len=3, seed=11,
                              del_prob=0.4),
}


def j_two_peer_merge(seed, rounds=6):
    """The JAX package's two-peer merge scenario
    (``tests/test_rle_mixed_fast.py`` ``test_two_peer_random_merge``),
    on the JAX oracle, returning ``(txns, receiver)``."""
    rng = random.Random(seed)
    docs = {name: JListCRDT() for name in ("amy", "bob")}
    agents = {n: d.get_or_create_agent_id(n) for n, d in docs.items()}
    marks = {n: 0 for n in docs}
    applied = {n: set() for n in docs}
    flat = []

    def edit(doc, agent):
        n = len(doc)
        if n == 0 or rng.random() < 0.6:
            pos = rng.randint(0, n)
            doc.local_insert(agent, pos, "".join(
                rng.choice("abcdef") for _ in range(rng.randint(1, 3))))
        else:
            pos = rng.randint(0, n - 1)
            doc.local_delete(agent, pos, min(rng.randint(1, 3), n - pos))

    for _ in range(rounds):
        for name, doc in docs.items():
            for _ in range(rng.randint(1, 4)):
                edit(doc, agents[name])
            flat.extend(j_export(doc, marks[name]))
        for name, doc in docs.items():
            for t in flat:
                key = (t.id.agent, t.id.seq)
                if t.id.agent != name and key not in applied[name]:
                    applied[name].add(key)
                    doc.apply_remote_txn(t)
        for name, doc in docs.items():
            marks[name] = doc.get_next_order()
    receiver = JListCRDT()
    for t in flat:
        receiver.apply_remote_txn(t)
    return flat, receiver


def _dicts(txns):
    return [dataclasses.asdict(t) for t in txns]


def _pair(kind, key):
    """(jax txns, jax receiver, port txns, port receiver) of one scenario."""
    if kind == "storm":
        jt, jr = j_make_storm(**STORMS[key])
        tt, tr = randedit.make_storm(**STORMS[key])
    else:
        jt, jr = j_two_peer_merge(400 + key)
        tt, tr = randedit.make_two_peer_merge(400 + key)
    return jt, jr, tt, tr


SCENARIOS = [("storm", k) for k in STORMS] + [("merge", s) for s in range(3)]


def _assert_oracles_equal(jdoc, tdoc):
    assert tdoc.to_string() == jdoc.to_string()
    assert tdoc.doc_spans() == jdoc.doc_spans()
    assert len(tdoc) == len(jdoc)
    assert tdoc.get_next_order() == jdoc.get_next_order()
    for log in ("deletes", "double_deletes", "txns", "client_with_order"):
        assert [dataclasses.asdict(e) for e in getattr(tdoc, log)] == \
            [dataclasses.asdict(e) for e in getattr(jdoc, log)], log
    assert tdoc.frontier == jdoc.frontier
    tdoc.check()


@pytest.mark.parametrize("kind,key", SCENARIOS)
def test_generated_txns_and_oracle_equal(kind, key):
    jt, jr, tt, tr = _pair(kind, key)
    assert _dicts(tt) == _dicts(jt)
    _assert_oracles_equal(jr, tr)
    # The port's oracle applying the JAX package's txns agrees too.
    doc = TListCRDT()
    for t in convert.txns_from_dicts(_dicts(jt)):
        doc.apply_remote_txn(t)
    _assert_oracles_equal(jr, doc)
    # And so does its export of the whole history.
    assert _dicts(t_export(doc, 0)) == _dicts(j_export(jr, 0))


def _compile_both(jt, tt, lmax, dmax):
    jtab = JB.AgentTable(sorted({t.id.agent for t in jt}))
    ttab = TB.AgentTable(sorted({t.id.agent for t in tt}))
    jops, jas = JB.compile_remote_txns(jt, jtab, lmax=lmax, dmax=dmax)
    tops, tas = TB.compile_remote_txns(tt, ttab, lmax=lmax, dmax=dmax)
    assert tas.next_order == jas.next_order
    return jops, tops


@pytest.mark.parametrize("dmax", [16, None, 1])
@pytest.mark.parametrize("kind,key", SCENARIOS)
def test_compile_remote_txns_equal(kind, key, dmax):
    jt, _, tt, _ = _pair(kind, key)
    jops, tops = _compile_both(jt, tt, lmax=4, dmax=dmax)
    for f in dataclasses.fields(JB.OpTensors):
        j = np.asarray(getattr(jops, f.name))
        t = getattr(tops, f.name)
        assert j.dtype == t.dtype and j.shape == t.shape, f.name
        assert np.array_equal(j, t), f.name


def test_agent_table_ranks_equal():
    names = ["zed", "amy", "peer-010", "peer-002", "ROOT", "mia", "amy"]
    jt, tt = JB.AgentTable(), TB.AgentTable()
    assert [jt.add(n) for n in names] == [tt.add(n) for n in names]
    assert np.array_equal(jt.rank_of_agent(), tt.rank_of_agent())
    named = sorted(set(names) - {"ROOT"})
    assert [tt.rank_of(n) for n in named] == [jt.rank_of(n) for n in named]


def test_compile_refuses_out_of_order_txn():
    txns, _ = randedit.make_storm(2, 2, 2, seed=1)
    table = TB.AgentTable(sorted({t.id.agent for t in txns}))
    with pytest.raises(ValueError, match="out of order"):
        TB.compile_remote_txns(txns[2:], table)
    with pytest.raises(ValueError, match="dmax"):
        TB.compile_remote_txns(txns, table, dmax=0)


def test_txns_from_dicts_round_trip():
    jt, _ = j_two_peer_merge(401)
    tt = convert.txns_from_dicts(_dicts(jt))
    assert _dicts(tt) == _dicts(jt)
    assert any(hasattr(op, "len") for t in tt for op in t.ops)
