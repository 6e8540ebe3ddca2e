"""The port's CUDA kernels against their plain PyTorch versions on the
card, bit for bit. They need an NVIDIA card and nvcc and skip without
them. The repository's conftest imports JAX, which the card's machine
need not have, so run them there without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import random

import numpy as np
import pytest
import torch

from text_crdt_rust_tpu_torch.ops import _kernels
from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch import storm
from text_crdt_rust_tpu_torch.ops import rle as TR
from text_crdt_rust_tpu_torch.ops import rle_mixed as TRM
from text_crdt_rust_tpu_torch.utils import randedit
from text_crdt_rust_tpu_torch.utils.testdata import TestPatch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _compile(patches, fuse_w=1):
    merged = TB.merge_patches(patches)
    lmax = max([len(p.ins_content) for p in merged] + [1])
    ops, _ = TB.compile_local_patches(merged, lmax=lmax, fuse_w=fuse_w)
    if fuse_w > 1:
        ops, _ = TB.fuse_steps(ops, fuse_w=fuse_w)
    return ops


def _random(seed, steps=200):
    return _compile(randedit.random_patches(np.random.default_rng(seed),
                                            steps)[0])


CASES = {
    "random-k8": lambda: ([_random(1)], dict(capacity=512, block_k=8)),
    "random-k16-b40": lambda: ([_random(2)],
                               dict(capacity=512, block_k=16, batch=40)),
    "bursts-w8-k32": lambda: ([_compile(randedit.prepend_bursts(
        np.random.default_rng(3), 30)[0], fuse_w=8)],
        dict(capacity=1024, block_k=32)),
    "groups-3": lambda: ([_random(4), _random(5, 100), _random(6, 50)],
                         dict(capacity=512, block_k=8)),
    "capacity-overflow": lambda: (
        [_compile([TestPatch(0, 0, "ab")] * 40)], dict(capacity=16, block_k=8)),
    "bad-delete": lambda: (
        [_compile([TestPatch(0, 0, "abc"), TestPatch(0, 10, "")])],
        dict(capacity=32, block_k=8)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(card, name):
    streams, shape = CASES[name]()
    shape.setdefault("batch", 8)
    rep = TR.make_replayer_rle(streams, device=card, chunk=128, **shape)
    plain = TR.rle_replay_plain(*rep.staged, **rep.shape)
    before = _kernels.launches.get("rle_replay", 0)
    kern = TR.rle_replay_cuda(*rep.staged, **rep.shape)
    torch.cuda.synchronize()
    assert _kernels.launches["rle_replay"] == before + 1
    for k, p in zip(kern, plain):
        assert k.dtype == p.dtype and k.shape == p.shape
        assert torch.equal(k, p)


def _storm(n_peers, rounds, run_len, del_prob):
    txns, _ = randedit.make_storm(n_peers, rounds, run_len, seed=7,
                                  del_prob=del_prob)
    return storm.compile_storm_txns(txns, run_len, del_prob)


def _two_peer():
    txns, _ = randedit.make_two_peer_merge(400)
    table = TB.AgentTable(sorted({t.id.agent for t in txns}))
    return TB.compile_remote_txns(txns, table, lmax=4)[0]


MIXED_CASES = {
    "small-delete-storm-k8": lambda: (_storm(3, 4, 2, 0.3),
                                      dict(capacity=256, block_k=8)),
    "mid-storm-k32": lambda: (_storm(16, 20, 4, 0.35),
                              dict(capacity=1184, block_k=32)),
    "mid-storm-k32-serial": lambda: (
        _storm(16, 20, 4, 0.35),
        dict(capacity=1184, block_k=32, fast_integrate=False)),
    "two-peer-merge-k8": lambda: (_two_peer(),
                                  dict(capacity=1024, block_k=8)),
    "local-only-k8": lambda: (_random(7, 120),
                              dict(capacity=512, block_k=8)),
    "capacity-overflow": lambda: (
        _compile([TestPatch(0, 0, "ab")] * 40), dict(capacity=16, block_k=8)),
}


@pytest.mark.parametrize("name", sorted(MIXED_CASES))
def test_mixed_kernel_matches_plain(card, name):
    ops, shape = MIXED_CASES[name]()
    rep = TRM.make_replayer_rle_mixed(ops, batch=16, chunk=128, device=card,
                                      **shape)
    plain = TRM.rle_mixed_replay_plain(*rep.staged, **rep.shape)
    before = _kernels.launches.get("rle_mixed_replay", 0)
    kern = TRM.rle_mixed_replay_cuda(*rep.staged, **rep.shape)
    torch.cuda.synchronize()
    assert _kernels.launches["rle_mixed_replay"] == before + 1
    for k, p in zip(kern, plain):
        assert k.dtype == p.dtype and k.shape == p.shape
        assert torch.equal(k, p)


def _lanes(lane_txns, lmax=4):
    opses = []
    for txns in lane_txns:
        table = TB.AgentTable(sorted({t.id.agent for t in txns}))
        opses.append(TB.compile_remote_txns(txns, table, lmax=lmax)[0])
    return TB.stack_ops(opses)


def _local_lanes():
    """Three lanes of local edits, compiled at one shared insert width."""
    merged = [TB.merge_patches(randedit.random_patches(
        np.random.default_rng(s), 60)[0]) for s in (8, 9, 10)]
    lmax = max(len(p.ins_content) for m in merged for p in m)
    return TB.stack_ops([TB.compile_local_patches(m, lmax=lmax)[0]
                         for m in merged])


def _out_of_blocks():
    """Lane 1 outgrows 8 rows (inserts between deletes cannot merge)."""
    busy = []
    for k in range(24):
        busy.append(TestPatch(0, 0, "ab"))
        if k % 2:
            busy.append(TestPatch(1, 1, ""))
    return TB.stack_ops([
        TB.compile_local_patches([TestPatch(0, 0, "ab")], lmax=2)[0],
        TB.compile_local_patches(busy, lmax=2)[0]])


LANES_CASES = {
    "storms-k8": lambda: (_lanes([randedit.make_storm(
        3, 5, 2, seed=50 + k, del_prob=0.35)[0] for k in range(3)]),
        dict(capacity=128, block_k=8)),
    "two-peer-k16": lambda: (_lanes([randedit.make_two_peer_merge(s)[0]
                                     for s in (400, 401)]),
                             dict(capacity=512, block_k=16)),
    "local-k8": lambda: (_local_lanes(), dict(capacity=512, block_k=8)),
    "out-of-blocks": lambda: (_out_of_blocks(),
                              dict(capacity=8, block_k=8)),
}


@pytest.mark.parametrize("name", sorted(LANES_CASES))
@pytest.mark.parametrize("blocked", [False, True])
def test_lanes_kernel_matches_plain(card, name, blocked):
    from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as RLM

    ops, shape = LANES_CASES[name]()
    if blocked:
        rep = RLM.make_replayer_lanes_mixed_blocked(
            ops, chunk=16, device=card, **shape)
        kern_fn, plain_fn = (RLM.lanes_mixed_blocked_replay_cuda,
                             RLM.lanes_mixed_blocked_replay_plain)
        kname = "rle_lanes_mixed_blocked"
    else:
        rep = RLM.make_replayer_lanes_mixed(
            ops, capacity=shape["capacity"], chunk=16, device=card)
        kern_fn, plain_fn = (RLM.lanes_mixed_replay_cuda,
                             RLM.lanes_mixed_replay_plain)
        kname = "rle_lanes_mixed"
    args = (*rep.staged, *rep.initial(), *rep.deltas)
    plain = plain_fn(*args, **rep.shape)
    before = _kernels.launches.get(kname, 0)
    kern = kern_fn(*args, **rep.shape)
    torch.cuda.synchronize()
    assert _kernels.launches[kname] == before + 1
    for k, p in zip(kern, plain):
        assert k.dtype == p.dtype and k.shape == p.shape
        assert torch.equal(k, p)


def _local_streams(seeds, n=60, fuse_w=1):
    """Divergent local edit streams, one per seed, at one insert width."""
    merged = [TB.merge_patches(randedit.random_patches(
        np.random.default_rng(s), n)[0]) for s in seeds]
    lmax = max(len(p.ins_content) for m in merged for p in m)
    return TB.stack_ops([TB.compile_local_patches(m, lmax=lmax,
                                                  fuse_w=fuse_w)[0]
                         for m in merged])


def _bursts():
    """Backwards insert bursts compiled into W-row fused steps (W > 2)."""
    opses = []
    for seed in (3, 4):
        ps, _ = randedit.prepend_bursts(np.random.default_rng(seed), 12)
        opses.append(TB.compile_local_patches(ps, lmax=16, fuse_w=5)[0])
    return TB.stack_ops(opses)


def _bad_deletes():
    return TB.stack_ops([
        TB.compile_local_patches([TestPatch(0, 0, "abc"),
                                  TestPatch(0, 10, "")], lmax=8)[0],
        TB.compile_local_patches([TestPatch(0, 0, "abcdefgh"),
                                  TestPatch(2, 3, "")], lmax=8)[0]])


# name -> (stacked local streams, capacity, block_k)
LOCAL_LANES_CASES = {
    "random-k8": lambda: (_local_streams((1, 2, 3, 4, 5)), 512, 8),
    "random-k16": lambda: (_local_streams((6, 7, 8), 120), 512, 16),
    "bursts-k16": lambda: (_bursts(), 256, 16),
    "out-of-blocks": lambda: (_out_of_blocks(), 8, 8),
    "bad-delete": lambda: (_bad_deletes(), 16, 8),
}


@pytest.mark.parametrize("name", sorted(LOCAL_LANES_CASES))
@pytest.mark.parametrize("blocked", [False, True])
def test_local_lanes_kernel_matches_plain(card, name, blocked):
    from text_crdt_rust_tpu_torch.ops import rle_lanes as TL

    ops, capacity, block_k = LOCAL_LANES_CASES[name]()
    if blocked:
        rep = TL.make_replayer_lanes_blocked(
            ops, capacity=capacity, block_k=block_k, chunk=16, device=card)
        kern_fn, plain_fn = (TL.lanes_blocked_replay_cuda,
                             TL.lanes_blocked_replay_plain)
        kname = "rle_lanes_blocked"
    else:
        rep = TL.make_replayer_lanes(ops, capacity=capacity, chunk=16,
                                     device=card)
        kern_fn, plain_fn = TL.lanes_replay_cuda, TL.lanes_replay_plain
        kname = "rle_lanes"
    args = (*rep.staged, *rep.initial())
    plain = plain_fn(*args, **rep.shape)
    before = _kernels.launches.get(kname, 0)
    kern = kern_fn(*args, **rep.shape)
    torch.cuda.synchronize()
    assert _kernels.launches[kname] == before + 1
    for k, p in zip(kern, plain):
        assert k.dtype == p.dtype and k.shape == p.shape
        assert torch.equal(k, p)


def _kevin(n, fuse_w):
    return TB.compile_local_patches([TestPatch(0, 0, " ")] * n, lmax=fuse_w,
                                    fuse_w=fuse_w)[0]


def _far_jump(n):
    ps = [TestPatch(0, 0, "abcdefgh")]
    for k in range(n):
        ps += [TestPatch(0, 0, "xy"), TestPatch(8 + 2 * k, 0, "pq")]
    return TB.compile_local_patches(ps, lmax=8)[0]


# name -> (streams, replayer kwargs); the plane rows of unused blocks are
# zeroed by both versions, so every output compares in full.
HBM_CASES = {
    "random-k8": lambda: ([_random(1)], dict(capacity=512, block_k=8)),
    "bursts-w8-k64": lambda: ([_compile(randedit.prepend_bursts(
        np.random.default_rng(3), 60)[0], fuse_w=8)],
        dict(capacity=2048, block_k=64)),
    "groups-3-k8": lambda: ([_random(4), _random(5, 100), _random(6, 50)],
                            dict(capacity=512, block_k=8)),
    "kevin-w64-k512": lambda: ([_kevin(6000, 64)],
                               dict(capacity=512 * 32, block_k=512)),
    "far-jump-k512": lambda: ([TB.compile_local_patches(
        randedit.random_patches(np.random.default_rng(13), 1500)[0],
        lmax=8)[0], _far_jump(300)],
        dict(capacity=512 * 16, block_k=512, batch=4)),
    "kevin-w64-k2048": lambda: ([_kevin(20000, 64)],
                                dict(capacity=2048 * 32, block_k=2048)),
    "kevin-k2048-no-origins": lambda: ([_kevin(20000, 64)], dict(
        capacity=2048 * 32, block_k=2048, store_origins=False)),
    "capacity-overflow": lambda: (
        [_compile([TestPatch(0, 0, "ab")] * 40)],
        dict(capacity=16, block_k=8)),
    "bad-delete": lambda: (
        [_compile([TestPatch(0, 0, "abc"), TestPatch(0, 10, "")])],
        dict(capacity=32, block_k=8)),
}


@pytest.mark.parametrize("name", sorted(HBM_CASES))
def test_hbm_kernel_matches_plain(card, name):
    from text_crdt_rust_tpu_torch.ops import rle_hbm as TH

    streams, kw = HBM_CASES[name]()
    kw.setdefault("batch", 8)
    rep = TH.make_replayer_rle_hbm(streams, device=card, chunk=128, **kw)
    plain = TH.rle_hbm_replay_plain(*rep.staged, **rep.shape)
    before = _kernels.launches.get("rle_hbm_replay", 0)
    kern = TH.rle_hbm_replay_cuda(*rep.staged, **rep.shape)
    torch.cuda.synchronize()
    assert _kernels.launches["rle_hbm_replay"] == before + 1
    for k, p in zip(kern, plain):
        assert k.dtype == p.dtype and k.shape == p.shape
        assert torch.equal(k, p)
    flags = kern[7][:2].amax(dim=1).tolist()
    assert flags == {"capacity-overflow": [1, 0],
                     "bad-delete": [0, 1]}.get(name, [0, 0])


# -- the per-character blocked replays (A8, A9, A10) --------------------------


def _chars(patches, lmax=4):
    return TB.compile_local_patches(patches, lmax=lmax, dmax=lmax)[0]


def _char_random(seed, steps=120):
    return _chars(randedit.random_patches(random.Random(seed), steps)[0])


# name -> (streams, capacity, block_k, expected error rows)
BLOCKED_CASES = {
    "random-k16": lambda: ([_char_random(7)], 512, 16, [0, 0, 0]),
    "prepends-k8": lambda: ([_chars([TestPatch(0, 0, "ab")] * 40)], 256, 8,
                            [0, 0, 0]),
    "trace-shape-k32": lambda: ([_char_random(5, 400)], 2048, 32,
                                [0, 0, 0]),
    "bad-delete": lambda: (
        [_chars([TestPatch(0, 0, "abc"), TestPatch(0, 10, "")])], 64, 8,
        [0, 1, 0]),
}


def _launched(name, fn):
    before = _kernels.launches.get(name, 0)
    out = fn()
    torch.cuda.synchronize()
    assert _kernels.launches[name] == before + 1
    return out


def _assert_equal(kern, plain):
    for k, p in zip(kern, plain):
        assert k.dtype == p.dtype and k.shape == p.shape
        assert torch.equal(k, p)


@pytest.mark.parametrize("name", sorted(BLOCKED_CASES))
def test_blocked_kernel_matches_plain(card, name):
    from text_crdt_rust_tpu_torch.ops import blocked as TBL

    streams, capacity, block_k, flags = BLOCKED_CASES[name]()
    rep = TBL.make_replayer(streams[0], capacity, batch=8, block_k=block_k,
                            chunk=128, device=card)
    plain = TBL.blocked_replay_plain(*rep.staged, **rep.shape)
    kern = _launched("blocked_replay",
                     lambda: TBL.blocked_replay_cuda(*rep.staged,
                                                     **rep.shape))
    _assert_equal(kern, plain)
    assert kern[4][:3].amax(dim=1).tolist() == flags


@pytest.mark.parametrize("name", sorted(BLOCKED_CASES) + ["groups-3"])
def test_blocked_hbm_kernel_matches_plain(card, name):
    from text_crdt_rust_tpu_torch.ops import blocked_hbm as TBH

    if name == "groups-3":
        streams = [_char_random(s, 60 + 20 * s) for s in range(3)]
        capacity, block_k, flags = 1024, 16, [0, 0, 0]
    else:
        streams, capacity, block_k, flags = BLOCKED_CASES[name]()
    rep = TBH.make_replayer_hbm(streams, capacity, batch=8, block_k=block_k,
                                chunk=128, device=card)
    plain = TBH.blocked_hbm_replay_plain(*rep.staged, **rep.shape)
    kern = _launched("blocked_hbm_replay",
                     lambda: TBH.blocked_hbm_replay_cuda(*rep.staged,
                                                         **rep.shape))
    _assert_equal(kern, plain)
    assert kern[4][:3].amax(dim=1).tolist() == flags


def _unknown_order():
    import dataclasses

    ops = _storm(2, 3, 2, 0.0)
    fields = {f.name: np.asarray(getattr(ops, f.name))
              for f in dataclasses.fields(ops)}
    fields = {k: np.concatenate([v, np.zeros((1,) + v.shape[1:], v.dtype)])
              for k, v in fields.items()}
    fields["kind"][-1] = TB.KIND_REMOTE_DEL
    fields["del_len"][-1] = 3
    fields["del_target"][-1] = 90
    fields["rows_per_step"][-1] = 1
    return TB.OpTensors(**fields)


# name -> (stream, capacity, block_k, expected error rows)
BLOCKED_MIXED_CASES = {
    "storm-4x10-k16": lambda: (_storm(4, 10, 2, 0.0), 256, 16, [0, 0, 0]),
    "storm-16x20-k32": lambda: (_storm(16, 20, 4, 0.0), 4096, 32,
                                [0, 0, 0]),
    "delete-storm-k16": lambda: (_storm(6, 20, 3, 0.3), 1024, 16,
                                 [0, 0, 0]),
    "local-k16": lambda: (_char_random(13, 60), 512, 16, [0, 0, 0]),
    "unknown-order": lambda: (_unknown_order(), 256, 16, [0, 1, 1]),
}


@pytest.mark.parametrize("name", sorted(BLOCKED_MIXED_CASES))
def test_blocked_mixed_kernel_matches_plain(card, name):
    from text_crdt_rust_tpu_torch.ops import blocked_mixed as TBM

    ops, capacity, block_k, flags = BLOCKED_MIXED_CASES[name]()
    rep = TBM.make_replayer_mixed(ops, capacity, batch=8, block_k=block_k,
                                  chunk=128, device=card)
    plain = TBM.blocked_mixed_replay_plain(*rep.staged, **rep.shape)
    kern = _launched("blocked_mixed_replay",
                     lambda: TBM.blocked_mixed_replay_cuda(*rep.staged,
                                                           **rep.shape))
    _assert_equal(kern, plain)
    assert kern[4][:3].amax(dim=1).tolist() == flags
