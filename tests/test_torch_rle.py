"""The port's run-block replay (plain PyTorch version, on the CPU) against
the JAX package's Pallas kernel in interpret mode, bit for bit.

Every case compiles one stream with the JAX package, carries the same
``OpTensors`` across with ``convert.ops_from_numpy`` and replays it in
both packages at the shapes ``tests/test_rle_engine.py`` uses (capacity
64-512 run rows, K = 8/16, batch 8, chunk 128). All eight outputs must be
equal as numpy arrays (origins as uint32 bit views, state as int32),
error flags and post-error state included, and so must the expanded
documents' ``download`` dicts. Tolerance: none — the state is integers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import rle as JR
from text_crdt_rust_tpu.ops import span_arrays as JSA
from text_crdt_rust_tpu.utils.testdata import TestPatch as JPatch
from text_crdt_rust_tpu_torch import convert
from text_crdt_rust_tpu_torch.ops import rle as TR
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA
from text_crdt_rust_tpu_torch.utils import randedit

FIELDS = ("ordp", "lenp", "blkord", "rows", "meta", "ol", "orr", "err")


def _jax_patches(patches):
    return [JPatch(p.pos, p.del_len, p.ins_content) for p in patches]


def _compile(patches, merge=True, fuse_w=1, lmax=None):
    plist = JB.merge_patches(patches) if merge else patches
    if lmax is None:
        lmax = max([len(p.ins_content) for p in plist] + [1])
    ops, _ = JB.compile_local_patches(plist, lmax=lmax, dmax=None,
                                      fuse_w=fuse_w)
    if fuse_w > 1:
        ops, _ = JB.fuse_steps(ops, fuse_w=fuse_w)
    return ops


def _random(seed, steps=80, merge=True):
    p, c = randedit.random_patches(np.random.default_rng(seed), steps)
    return _compile(_jax_patches(p), merge=merge), c


def _bursts(seed):
    p, c = randedit.prepend_bursts(np.random.default_rng(seed), 16,
                                   max_burst=6)
    ops = _compile(_jax_patches(p), fuse_w=4)
    assert JB.fused_width(ops) > 2
    return ops, c


def _spanning():
    """Many tiny runs, then one delete across several blocks."""
    p = [JPatch(0, 0, "ab") for _ in range(24)] + [JPatch(2, 40, "")]
    text = "ab" * 24
    return _compile(p, merge=False), text[:2] + text[42:]


CASES = {
    "random-s1-merged": lambda: ([_random(1)], dict(capacity=256, block_k=8)),
    "random-s2-merged": lambda: ([_random(2)], dict(capacity=256, block_k=8)),
    "random-s3-merged": lambda: ([_random(3)], dict(capacity=256, block_k=8)),
    "random-s1-raw": lambda: ([_random(1, merge=False)],
                              dict(capacity=256, block_k=8)),
    "random-s2-raw": lambda: ([_random(2, merge=False)],
                              dict(capacity=256, block_k=8)),
    "random-s4-k16": lambda: ([_random(4, steps=160)],
                              dict(capacity=512, block_k=16)),
    "bursts-w4-s1": lambda: ([_bursts(1)], dict(capacity=512, block_k=16)),
    "bursts-w4-s2": lambda: ([_bursts(2)], dict(capacity=512, block_k=16)),
    "groups-2": lambda: ([_random(5), _random(6, steps=60)],
                         dict(capacity=256, block_k=8)),
    "delete-spanning-blocks": lambda: ([_spanning()],
                                       dict(capacity=128, block_k=8)),
    "capacity-overflow": lambda: (
        [(_compile([JPatch(0, 0, "ab") for _ in range(40)], merge=False),
          None)], dict(capacity=16, block_k=8)),
    "bad-delete": lambda: (
        [(_compile([JPatch(0, 0, "abc"), JPatch(0, 10, "")]), None)],
        dict(capacity=32, block_k=8)),
}


def _port_ops(jops):
    return convert.ops_from_numpy(
        {f.name: np.asarray(getattr(jops, f.name))
         for f in dataclasses.fields(jops)})


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_matches_jax(name):
    streams, shape = CASES[name]()
    jops = [s for s, _ in streams]
    tops = [_port_ops(s) for s in jops]
    kw = dict(batch=8, chunk=128, **shape)
    jres = JR.make_replayer_rle(jops, interpret=True, **kw)()
    tres = TR.make_replayer_rle(tops, device="cpu", **kw)()
    assert len(jres) == len(tres) == len(streams)
    for gi, (j, t) in enumerate(zip(jres, tres)):
        got = convert.rle_result_to_numpy(t)
        for f in FIELDS:
            want = np.asarray(getattr(j, f))
            assert got[f].dtype == want.dtype, (gi, f)
            assert np.array_equal(got[f], want), (gi, f)
    err = np.asarray(jres[0].err)
    if name == "capacity-overflow":
        assert err[0].all() and not err[1].any()
    elif name == "bad-delete":
        assert err[1].all() and not err[0].any()
    else:
        assert not err.any()
        for (jo, content), to, j, t in zip(streams, tops, jres, tres):
            jd = JSA.download(JR.rle_to_flat(jo, j))
            td = TSA.download(TR.rle_to_flat(to, t))
            assert jd.keys() == td.keys()
            for k in jd:
                assert np.array_equal(jd[k], td[k]), k
            assert np.array_equal(JR.expand_runs(j), TR.expand_runs(t))
            assert TSA.to_string(TR.rle_to_flat(to, t)) == content


@pytest.mark.parametrize("seed", [7, 8])
def test_flat_doc_from_numpy_round_trip(seed):
    jops, _ = _random(seed)
    jdoc = JR.rle_to_flat(jops, JR.replay_local_rle(
        jops, capacity=256, batch=8, block_k=8, chunk=128, interpret=True))
    tdoc = convert.flat_doc_from_numpy(
        {f.name: np.asarray(getattr(jdoc, f.name))
         for f in dataclasses.fields(jdoc)}, device="cpu")
    assert tdoc.signed.dtype == torch.int32
    jd, td = JSA.download(jdoc), TSA.download(tdoc)
    assert jd.keys() == td.keys()
    for k in jd:
        assert np.array_equal(jd[k], td[k]), k
    assert TSA.to_string(tdoc) == JSA.to_string(jdoc)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_simulate_run_rows_matches_jax(seed):
    p, _ = randedit.random_patches(np.random.default_rng(seed), 120)
    assert TR.simulate_run_rows(p) == JR.simulate_run_rows(_jax_patches(p))


# -- the delete block math with aux planes (the rle_mixed path) ---------------

K, B = 8, 4


def _jax_delete_kernel(s_ref, bo_ref, bl_ref, a0, a1, a2,
                       o_bo, o_bl, o0, o1, o2, o_s):
    idx = jax.lax.broadcasted_iota(jnp.int32, (K, B), 0)
    base, p, rem = s_ref[0, 0], s_ref[1, 0], s_ref[2, 0]
    no, nl, added, tot, aux = JR._delete_block_math(
        bo_ref[...], bl_ref[...], idx, K, base, p, rem,
        aux=(a0[...], a1[...], a2[...]))
    o_bo[...] = no
    o_bl[...] = nl
    o0[...] = aux[0]
    o1[...] = aux[1]
    o2[...] = aux[2]
    o_s[...] = jnp.zeros((8, B), jnp.int32).at[0].set(added).at[1].set(tot)


_SH = jax.ShapeDtypeStruct((K, B), jnp.int32)
_jax_delete = jax.jit(pl.pallas_call(
    _jax_delete_kernel,
    out_shape=[_SH] * 5 + [jax.ShapeDtypeStruct((8, B), jnp.int32)],
    interpret=True))


@pytest.mark.parametrize("seed", range(8))
def test_delete_block_math_with_aux_matches_jax(seed):
    rng = np.random.default_rng(seed)
    r0 = int(rng.integers(1, K - 1))
    lens = np.zeros(K, np.int32)
    lens[:r0] = rng.integers(1, 6, r0)
    orders = np.zeros(K, np.int32)
    orders[:r0] = rng.integers(1, 100, r0) * np.where(
        rng.random(r0) < 0.7, 1, -1)
    live = int(np.where(orders > 0, lens, 0).sum())
    base = int(rng.integers(0, 5))
    p = base + int(rng.integers(0, max(live, 1)))
    rem = int(rng.integers(1, live + 3))
    bo = np.tile(orders[:, None], (1, B))
    bl = np.tile(lens[:, None], (1, B))
    aux = [np.tile(rng.integers(-3, 50, K, dtype=np.int32)[:, None], (1, B))
           for _ in range(3)]
    scal = np.zeros((8, B), np.int32)
    scal[:3, 0] = (base, p, rem)
    jo = [np.asarray(x) for x in _jax_delete(scal, bo, bl, *aux)]

    idx = torch.arange(K, dtype=torch.int32)[:, None]
    no, nl, added, tot, taux = TR._delete_block_math(
        torch.from_numpy(bo), torch.from_numpy(bl), idx, K, base, p, rem,
        aux=tuple(torch.from_numpy(a) for a in aux))
    got = [no, nl, *taux]
    for g, want in zip(got, jo[:5]):
        assert np.array_equal(g.numpy(), want)
    assert (added, tot) == (int(jo[5][0, 0]), int(jo[5][1, 0]))
