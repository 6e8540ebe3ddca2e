"""The full config-4 storms (16 peers x 200 rounds x run_len 4, seed 7)
on the CPU against the JAX package's ``cfg_4`` pipeline at 8 documents,
K = 128, chunk 1,024: the same compiled stream, replay outputs bit for bit
(the JAX kernel in interpret mode) and the oracle's text.

The txns are generated once, by the JAX package, and carried across with
``convert.txns_from_dicts`` (the oracle generation dominates the cost).
The delete-heavy storm is marked ``slow``. Tolerance: none.
"""
import dataclasses

import pytest
from test_torch_storm import assert_same, jax_pipeline

from text_crdt_rust_tpu.utils.randedit import make_storm as j_make_storm
from text_crdt_rust_tpu_torch import convert, storm
from text_crdt_rust_tpu_torch.ops import rle as TR
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA


def _full_storm(del_prob):
    txns, receiver = j_make_storm(16, 200, 4, seed=7, del_prob=del_prob)
    jops, jres, jtext = jax_pipeline(txns, 4, del_prob)
    assert jtext == receiver.to_string()
    tx = convert.txns_from_dicts([dataclasses.asdict(t) for t in txns])
    tops = storm.compile_storm_txns(tx, 4, del_prob)
    stream = storm.StormStream(txns=tx, ops=tops, want=jtext, char_ops=0)
    tres = storm.make_storm_replayer(stream, batch=8, device="cpu")()
    assert_same(jops, jres, tops, tres)
    assert TSA.to_string(TR.rle_to_flat(tops, tres)) == jtext
    return stream


def test_full_insert_storm_matches_jax():
    stream = _full_storm(0.0)
    assert stream.steps == 3200


@pytest.mark.slow
def test_full_delete_heavy_storm_matches_jax():
    stream = _full_storm(0.35)
    assert stream.steps == 3791
