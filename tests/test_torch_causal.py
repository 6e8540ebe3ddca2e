"""The port's causal receive buffer (``parallel/causal.py``) and
``common.split_txn_suffix`` against the JAX package's, on shuffled and
re-delivered arrivals: the same txns come out in the same order, and the
buffer reports the same gaps. Txns compare as ``dataclasses.asdict``
dicts; tolerance: none."""
import dataclasses
import random

import pytest

from test_device_flat import oracle_from_patches, random_patches
from text_crdt_rust_tpu.common import split_txn_suffix as j_split
from text_crdt_rust_tpu.models.sync import export_txns_since
from text_crdt_rust_tpu.parallel.causal import CausalBuffer as JBuffer
from text_crdt_rust_tpu_torch import convert
from text_crdt_rust_tpu_torch.common import split_txn_suffix as t_split
from text_crdt_rust_tpu_torch.parallel.causal import CausalBuffer as TBuffer


def _asdicts(txns):
    return [dataclasses.asdict(t) for t in txns]


def _peers(seed, names=("ann", "bob", "cyd"), patches=15):
    rng = random.Random(seed)
    txns = []
    for name in names:
        txns += export_txns_since(oracle_from_patches(
            random_patches(rng, patches)[0], agent=name), 0)
    return txns, rng


@pytest.mark.parametrize("seed", [404, 5, 77])
def test_release_order_matches_jax_on_shuffled_arrivals(seed):
    txns, rng = _peers(seed)
    arrivals = list(txns)
    rng.shuffle(arrivals)
    j, t = JBuffer(), TBuffer()
    j_out, t_out = [], []
    for txn in arrivals:
        j_out.append(_asdicts(j.add(txn)))
        t_out.append(_asdicts(t.add(convert.txns_from_dicts(
            [dataclasses.asdict(txn)])[0])))
        assert t.pending == j.pending and t.last_offer == j.last_offer
    assert t_out == j_out
    assert t.pending == 0 and t.watermarks() == j.watermarks()


def test_gaps_duplicates_and_evictions_match_jax():
    txns, rng = _peers(9, patches=10)
    arrivals = list(txns) + list(txns[:3])   # re-deliveries
    rng.shuffle(arrivals)
    held = arrivals[len(arrivals) // 2:]
    j, t = JBuffer(max_pending=3), TBuffer(max_pending=3)
    for txn in arrivals[:len(arrivals) // 2]:
        jr = _asdicts(j.add(txn))
        tr = _asdicts(t.add(convert.txns_from_dicts(
            [dataclasses.asdict(txn)])[0]))
        assert jr == tr
        assert [dataclasses.asdict(x) for x in t.missing()] == \
            [dataclasses.asdict(x) for x in j.missing()]
        assert t.gap_stats() == j.gap_stats()
    assert (t.evictions, t.duplicates_dropped, t.high_water) == \
        (j.evictions, j.duplicates_dropped, j.high_water)
    assert _asdicts(t.add_all(convert.txns_from_dicts(_asdicts(held)))) == \
        _asdicts(j.add_all(held))


def test_split_txn_suffix_matches_jax():
    txns, _ = _peers(21, names=("ann",), patches=30)
    for txn in txns:
        n = sum(len(op.ins_content) if hasattr(op, "ins_content")
                else op.len for op in txn.ops)
        tt = convert.txns_from_dicts([dataclasses.asdict(txn)])[0]
        for at in range(1, n):
            assert dataclasses.asdict(t_split(tt, at)) == \
                dataclasses.asdict(j_split(txn, at))
