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
from text_crdt_rust_tpu_torch import corpus, random_edits, storm
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
    "random-k2048": lambda: ([_random(7, 400)],
                             dict(capacity=4096, block_k=2048)),
    "groups-k2048": lambda: ([_random(8, 300), _random(9, 200)],
                             dict(capacity=4096, block_k=2048, batch=3)),
    # K past 2,048: the window and scratch rows in 65,536 B.
    "random-k4096": lambda: ([_random(10, 400)],
                             dict(capacity=8192, block_k=4096)),
    # Config 2's geometry (K = 256, NB 236) on its 2,000-step stream.
    "config2-k256-nb236": lambda: (
        [random_edits.make_random_edits_stream(2000).rle.ops],
        dict(capacity=60416, block_k=256)),
    # Config 3's ragged groups, rustcode's 42,493-character paste chained
    # in 512-character steps.
    "config3-ragged-chained": lambda: _corpus(400),
    # Twenty divergent doc groups in one launch.
    "groups-20": lambda: ([_random(20 + g, 60) for g in range(20)],
                          dict(capacity=512, block_k=8, batch=4)),
}


def _corpus(prefix):
    st = corpus.make_corpus_stream(prefix=prefix)
    return ([s.ops for s in st.streams],
            dict(capacity=st.capacity, block_k=corpus.BLOCK_K))


@pytest.mark.parametrize("warps", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(card, name, warps):
    streams, shape = CASES[name]()
    shape.setdefault("batch", 8)
    rep = TR.make_replayer_rle(streams, device=card, chunk=128, **shape)
    plain = TR.rle_replay_plain(*rep.staged, **rep.shape)
    before = _kernels.launches.get("rle_replay", 0)
    stats = torch.zeros(rep.shape["groups"], rep.shape["batch"], TR.STATS,
                        dtype=torch.int64, device=card)
    kern = TR.rle_replay_cuda(*rep.staged, **rep.shape, warps=warps,
                              stats=stats if warps == 2 else None)
    torch.cuda.synchronize()
    assert _kernels.launches["rle_replay"] == before + 1
    for k, p in zip(kern, plain):
        assert k.dtype == p.dtype and k.shape == p.shape
        assert torch.equal(k, p)
    if warps == 2:  # every chain counts its steps with work
        steps = int(((rep.staged[1] > 0) | (rep.staged[2] > 0))
                    .reshape(rep.shape["groups"], -1).sum(dim=1)[0])
        assert int(stats[0, 0, 3]) == steps


def _storm(n_peers, rounds, run_len, del_prob):
    txns, _ = randedit.make_storm(n_peers, rounds, run_len, seed=7,
                                  del_prob=del_prob)
    return storm.compile_storm_txns(txns, run_len, del_prob)


def _storm_seed(n_peers, rounds, run_len, del_prob, seed):
    txns, _ = randedit.make_storm(n_peers, rounds, run_len, seed=seed,
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
    # Windows spanning many blocks of 8 rows, splits between lookups.
    "storm-k8-multiblock": lambda: (
        _storm_seed(16, 40, 4, 0.35, 11), dict(capacity=2224, block_k=8)),
    # K = 2,048: the run planes in shared memory, then in device memory.
    "mid-storm-k2048": lambda: (_storm(16, 20, 4, 0.35),
                                dict(capacity=2048 * 8, block_k=2048)),
    "mid-storm-k2048-device-planes": lambda: (
        _storm(16, 20, 4, 0.35), dict(capacity=2048 * 16, block_k=2048)),
    "mid-storm-k4096": lambda: (_storm(16, 20, 4, 0.35),
                                dict(capacity=4096 * 4, block_k=4096)),
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


def _stream5(n_docs=4, chunks=2, steps=60):
    """Two chunks of config-5 local streams: the first is the warm start."""
    from text_crdt_rust_tpu_torch import stream

    return stream.make_stream_5(n_docs=n_docs, chunks=chunks,
                                steps_per_chunk=steps).stacked


def _stream5r():
    """Two chunks of config-5r remote streams (three documents)."""
    from text_crdt_rust_tpu_torch import stream

    return stream.make_stream_5r(n_docs=3, chunks=2, steps_per_chunk=40,
                                 seed_base=900).stacked


def _warm_state(make, plain_fn, warm_ops, card, stale, **kw):
    """The state after ``warm_ops`` (plain version on the card), as a
    warm start; ``stale`` leaves each un-blocked document's last two rows
    past ``rows`` (nonzero rows past the rows in use)."""
    rep = make(warm_ops, chunk=16, device=card, **kw)
    state = list(plain_fn(*rep.staged, *rep.initial(),
                          *getattr(rep, "deltas", ()), **rep.shape)[2:-1])
    if stale:
        state[2] = torch.clamp(state[2] - 2, min=0)
    return tuple(state)


# name -> (stacked streams, shapes[, the warm-start stream, stale rows])
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
    # W = 5 bursts overflow 16 rows: the splices wrap, err[0] is raised
    # and the inserts still land.
    "overflow-wrap": lambda: (_bursts(), dict(capacity=16, block_k=16)),
    # 32,768 rows a document do not fit a thread block's shared memory:
    # the un-blocked kernel keeps the first 29,056 there.
    "capacity-past-shared-memory": lambda: (
        _local_lanes(), dict(capacity=32768, block_k=1024)),
    "stale-rows": lambda: (_stream5()[1], dict(capacity=256, block_k=8),
                           _stream5()[0], True),
    # Remote ops on rows past `rows` (a stream whose walks all end: the
    # CPU tests check that it never stalls).
    "stale-rows-remote": lambda: (_stream5r()[1],
                                  dict(capacity=256, block_k=8),
                                  _stream5r()[0], True),
    "two-peer-k2048": lambda: (_lanes([randedit.make_two_peer_merge(s)[0]
                                       for s in (402, 403)]),
                               dict(capacity=4096, block_k=2048)),
    # Two documents a thread block on A7 (6 K ints of scratch each).
    "two-peer-k4096": lambda: (_lanes([randedit.make_two_peer_merge(s)[0]
                                       for s in (404, 405, 406)]),
                               dict(capacity=8192, block_k=4096)),
}


@pytest.mark.parametrize("warps", [1, 2, 4])
@pytest.mark.parametrize("name", ["storms-k8", "two-peer-k16", "local-k8",
                                  "stale-rows-remote", "overflow-wrap"])
def test_blocked_lanes_kernel_warps(card, name, warps):
    """A7 at 1, 2 and 4 documents a thread block, with its counters."""
    from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as RLM

    ops, shape, *warm = LANES_CASES[name]()
    make = RLM.make_replayer_lanes_mixed_blocked
    init = None
    if warm:
        init = _warm_state(make, RLM.lanes_mixed_blocked_replay_plain,
                           warm[0], card, False, **shape)
    rep = make(ops, chunk=16, device=card, init=init, **shape)
    args = (*rep.staged, *rep.initial(), *rep.deltas)
    plain = RLM.lanes_mixed_blocked_replay_plain(*args, **rep.shape)
    B = ops.kind.shape[1]
    stats = torch.zeros(B, RLM.BLOCKED_STATS, dtype=torch.int64, device=card)
    kern = RLM.lanes_mixed_blocked_replay_cuda(*args, **rep.shape,
                                               warps=warps, stats=stats)
    torch.cuda.synchronize()
    for k, p in zip(kern, plain):
        assert torch.equal(k, p)
    assert torch.equal(stats[:, 16].cpu(), plain[4][0].long().cpu())
    assert bool((stats[:, 17] <= plain[2].shape[0] // shape["block_k"])
                .all())


def _stale_past_rws(state):
    """One row past ``rws`` left in slot 0's block of every lane with two
    rows there."""
    st = list(state)
    st[4] = st[4].clone()
    st[4][0] = torch.where(st[4][0] >= 2, st[4][0] - 1, st[4][0])
    return tuple(st)


@pytest.mark.parametrize("warps", [1, 4])
def test_blocked_lanes_kernel_rows_past_rws(card, warps):
    """A7 from a warm state with nonzero rows past ``rws``: the bounded
    search must still find what the whole-plane search finds."""
    from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as RLM

    make = RLM.make_replayer_lanes_mixed_blocked
    warm = _warm_state(make, RLM.lanes_mixed_blocked_replay_plain,
                       _stream5r()[0], card, False, capacity=256, block_k=8)
    rep = make(_stream5r()[1], chunk=16, device=card, capacity=256,
               block_k=8, init=_stale_past_rws(warm))
    args = (*rep.staged, *rep.initial(), *rep.deltas)
    plain = RLM.lanes_mixed_blocked_replay_plain(*args, **rep.shape)
    kern = RLM.lanes_mixed_blocked_replay_cuda(*args, **rep.shape,
                                               warps=warps)
    torch.cuda.synchronize()
    for k, p in zip(kern, plain):
        assert torch.equal(k, p)


@pytest.mark.parametrize("name", sorted(LANES_CASES))
@pytest.mark.parametrize("blocked", [False, True])
def test_lanes_kernel_matches_plain(card, name, blocked):
    from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as RLM

    ops, shape, *warm = LANES_CASES[name]()
    if blocked:
        make = RLM.make_replayer_lanes_mixed_blocked
        kw = dict(shape)
        kern_fn, plain_fn = (RLM.lanes_mixed_blocked_replay_cuda,
                             RLM.lanes_mixed_blocked_replay_plain)
        kname = "rle_lanes_mixed_blocked"
    else:
        make = RLM.make_replayer_lanes_mixed
        kw = dict(capacity=shape["capacity"])
        kern_fn, plain_fn = (RLM.lanes_mixed_replay_cuda,
                             RLM.lanes_mixed_replay_plain)
        kname = "rle_lanes_mixed"
    init = None
    if warm:
        init = _warm_state(make, plain_fn, warm[0], card,
                           warm[1] and not blocked, **kw)
    rep = make(ops, chunk=16, device=card, init=init, **kw)
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


# name -> (stacked local streams, capacity, block_k[, the warm-start
# stream, stale rows])
LOCAL_LANES_CASES = {
    "random-k8": lambda: (_local_streams((1, 2, 3, 4, 5)), 512, 8),
    "random-k16": lambda: (_local_streams((6, 7, 8), 120), 512, 16),
    "bursts-k16": lambda: (_bursts(), 256, 16),
    "out-of-blocks": lambda: (_out_of_blocks(), 8, 8),
    "bad-delete": lambda: (_bad_deletes(), 16, 8),
    "overflow-wrap": lambda: (_bursts(), 16, 16),
    "capacity-past-shared-memory": lambda: (_local_streams((1, 2, 3)),
                                            32768, 1024),
    "stale-rows": lambda: (_stream5()[1], 256, 8, _stream5()[0], True),
    # Three documents a thread block at K = 2,048 (7 K ints each).
    "random-k2048": lambda: (_local_streams((9, 10, 11, 12, 13), 120),
                             4096, 2048),
    "random-k4096": lambda: (_local_streams((14, 15, 16), 120), 8192, 4096),
}


@pytest.mark.parametrize("name", sorted(LOCAL_LANES_CASES))
@pytest.mark.parametrize("blocked", [False, True])
def test_local_lanes_kernel_matches_plain(card, name, blocked):
    from text_crdt_rust_tpu_torch.ops import rle_lanes as TL

    ops, capacity, block_k, *warm = LOCAL_LANES_CASES[name]()
    if blocked:
        make, kw = TL.make_replayer_lanes_blocked, dict(block_k=block_k)
        kern_fn, plain_fn = (TL.lanes_blocked_replay_cuda,
                             TL.lanes_blocked_replay_plain)
        kname = "rle_lanes_blocked"
    else:
        make, kw = TL.make_replayer_lanes, {}
        kern_fn, plain_fn = TL.lanes_replay_cuda, TL.lanes_replay_plain
        kname = "rle_lanes"
    init = None
    if warm:
        init = _warm_state(make, plain_fn, warm[0], card,
                           warm[1] and not blocked, capacity=capacity, **kw)
    rep = make(ops, capacity=capacity, chunk=16, device=card, init=init,
               **kw)
    args = (*rep.staged, *rep.initial())
    plain = plain_fn(*args, **rep.shape)
    before = _kernels.launches.get(kname, 0)
    kern = kern_fn(*args, **rep.shape)
    torch.cuda.synchronize()
    assert _kernels.launches[kname] == before + 1
    for k, p in zip(kern, plain):
        assert k.dtype == p.dtype and k.shape == p.shape
        assert torch.equal(k, p)


@pytest.mark.parametrize("on_chip", [True, False])
@pytest.mark.parametrize("warps", [1, 3, 4])
@pytest.mark.parametrize("name", ["random-k8", "bursts-k16", "out-of-blocks",
                                  "bad-delete", "overflow-wrap",
                                  "stale-rows"])
def test_blocked_local_lanes_kernel_placements(card, name, warps, on_chip):
    """A5 with each document's rows in shared memory and in device memory,
    at 1, 3 and 4 documents a thread block (a last block with fewer), with
    its counters: the steps with work and the blocks in use agree with
    the stream and the plain version."""
    from text_crdt_rust_tpu_torch.ops import rle_lanes as TL

    ops, capacity, block_k, *warm = LOCAL_LANES_CASES[name]()
    init = None
    if warm:
        init = _warm_state(TL.make_replayer_lanes_blocked,
                           TL.lanes_blocked_replay_plain, warm[0], card,
                           False, capacity=capacity, block_k=block_k)
    rep = TL.make_replayer_lanes_blocked(ops, capacity=capacity, chunk=16,
                                         device=card, init=init,
                                         block_k=block_k)
    args = (*rep.staged, *rep.initial())
    plain = TL.lanes_blocked_replay_plain(*args, **rep.shape)
    B = rep.staged[0].shape[1]
    stats = torch.zeros(B, TL.BLOCKED_STATS, dtype=torch.int64, device=card)
    kern = TL.lanes_blocked_replay_cuda(*args, **rep.shape, warps=warps,
                                        on_chip=on_chip, stats=stats)
    torch.cuda.synchronize()
    for k, p in zip(kern, plain):
        assert torch.equal(k, p)
    work = ((rep.staged[1] > 0) | (rep.staged[2] > 0)).sum(dim=0)
    assert torch.equal(stats[:, 0].cpu(), work.long().cpu())
    assert torch.equal(stats[:, 14].cpu(), plain[4][0].long().cpu())
    assert bool((stats[:, 15] == int(on_chip)).all())


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("mixed", [False, True])
def test_unblocked_lanes_kernel_warps(card, warps, mixed):
    """The un-blocked kernels at 1-8 documents a thread block against their
    plain versions, with each column in shared memory (the wrapper's
    choice), in device memory from the start (``rows_on_chip=0``) and in
    a window of rows that the larger columns outgrow mid-launch (their
    extents end at 11-16 rows and at 59-75 rows)."""
    from text_crdt_rust_tpu_torch.ops import rle_lanes as TL
    from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as RLM

    if mixed:
        ops = _lanes([randedit.make_storm(3, 5, 2, seed=60 + k,
                                          del_prob=0.35)[0]
                      for k in range(11)])
        rep = RLM.make_replayer_lanes_mixed(ops, capacity=256, chunk=16,
                                            device=card)
        args = (*rep.staged, *rep.initial(), *rep.deltas)
        kern_fn, plain_fn = (RLM.lanes_mixed_replay_cuda,
                             RLM.lanes_mixed_replay_plain)
        n_stats, window = RLM.STATS, 14
    else:
        ops = _local_streams(range(20, 31))
        rep = TL.make_replayer_lanes(ops, capacity=256, chunk=16,
                                     device=card)
        args = (*rep.staged, *rep.initial())
        kern_fn, plain_fn = TL.lanes_replay_cuda, TL.lanes_replay_plain
        n_stats, window = TL.STATS, 68
    plain = plain_fn(*args, **rep.shape)
    B = ops.kind.shape[1]
    for rows in (None, 0, window):
        stats = torch.zeros(B, n_stats, dtype=torch.int64, device=card)
        kern = kern_fn(*args, **rep.shape, warps=warps, rows_on_chip=rows,
                       stats=stats)
        torch.cuda.synchronize()
        for k, p in zip(kern, plain):
            assert k.dtype == p.dtype and k.shape == p.shape
            assert torch.equal(k, p)
        on_chip = stats[:, -1].tolist()
        ends = stats[:, 1].tolist()
        assert bool((stats[:, 1] >= stats[:, 0]).all())
        if rows is None:
            assert all(on_chip)
        elif rows == 0:
            assert not any(on_chip)
        else:
            # A column moves before a step that could pass the window, so
            # one that ends in shared memory ends within it, and some move.
            assert all(e <= window for e, on in zip(ends, on_chip) if on)
            assert sum(on_chip) < B


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
    "kevin-w64-k4096": lambda: ([_kevin(20000, 64)],
                                dict(capacity=4096 * 16, block_k=4096)),
    "capacity-overflow": lambda: (
        [_compile([TestPatch(0, 0, "ab")] * 40)],
        dict(capacity=16, block_k=8)),
    "bad-delete": lambda: (
        [_compile([TestPatch(0, 0, "abc"), TestPatch(0, 10, "")])],
        dict(capacity=32, block_k=8)),
    # The window ring: inserts and deletes on both sides of a block's
    # middle (each side's move is the shorter one), and full tables whose
    # W-row prepends splice on past K rows with err row 0 raised.
    "mid-block-k64": lambda: ([_random(21, 600)],
                              dict(capacity=64 * 64, block_k=64)),
    "full-table-w3-k8": lambda: ([_kevin(300, 3)],
                                 dict(capacity=16, block_k=8)),
    "full-table-w7-k16": lambda: ([_kevin(700, 7)],
                                  dict(capacity=32, block_k=16)),
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
    assert flags == {"capacity-overflow": [1, 0], "bad-delete": [0, 1],
                     "full-table-w3-k8": [1, 0],
                     "full-table-w7-k16": [1, 0]}.get(name, [0, 0])


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
    "random-k2048": lambda: ([_char_random(9, 600)], 8192, 2048, [0, 0, 0]),
    "random-k4096": lambda: ([_char_random(10, 600)], 8192, 4096, [0, 0, 0]),
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


def _far_jumps(n=300):
    """2,048 characters typed, then single-character edits whose
    positions jump across the document: nearly every step leaves the
    kernel's cache of blocks."""
    patches = [TestPatch(16 * i, 0, "x" * 16) for i in range(128)]
    size = 2048
    for i in range(n):
        at = (i * 7919) % size
        if i % 3 == 2:
            patches.append(TestPatch(at, 1, ""))
            size -= 1
        else:
            patches.append(TestPatch(at, 0, "y"))
            size += 1
    return _chars(patches, lmax=16)


# The device-memory engine's own cases: name -> (streams, capacity,
# block_k, expected error rows).
HBM_CHAR_CASES = {
    "groups-3": lambda: ([_char_random(s, 60 + 20 * s) for s in range(3)],
                         1024, 16, [0, 0, 0]),
    "far-jumps-k32": lambda: ([_far_jumps()], 8192, 32, [0, 0, 0]),
    "random-k2048": lambda: ([_chars(randedit.random_patches(
        random.Random(3), 300)[0], lmax=16)], 8192, 2048, [0, 0, 0]),
}


@pytest.mark.parametrize("name",
                         sorted(BLOCKED_CASES) + sorted(HBM_CHAR_CASES))
def test_blocked_hbm_kernel_matches_plain(card, name):
    from text_crdt_rust_tpu_torch.ops import blocked_hbm as TBH

    streams, capacity, block_k, flags = (HBM_CHAR_CASES.get(name)
                                         or BLOCKED_CASES[name])()
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


def _absent_origin():
    """The small storm with its last remote insert's origin-left set to
    an order no item has: the left cursor's search of the whole state
    misses (``err[2]``) and clamps the cursor past the end."""
    import dataclasses

    ops = _storm(2, 3, 2, 0.0)
    fields = {f.name: np.asarray(getattr(ops, f.name)).copy()
              for f in dataclasses.fields(ops)}
    last = int(np.nonzero(fields["kind"] == TB.KIND_REMOTE_INS)[0][-1])
    fields["origin_left"][last] = 60
    return TB.OpTensors(**fields)


def _tie_runs():
    """40 concurrent inserts at ROOT, then three agents that saw only the
    last of them insert before it: their scans pin scan_start and carry it
    past 32 positions (the kernel's sub-window) to the break."""
    from text_crdt_rust_tpu_torch.common import (
        ROOT_REMOTE_ID,
        RemoteId,
        RemoteIns,
        RemoteTxn,
    )

    peers = [f"p{i:02d}" for i in range(40)]
    txns = [RemoteTxn(id=RemoteId(n, 0), parents=[],
                      ops=[RemoteIns(ROOT_REMOTE_ID, ROOT_REMOTE_ID, "x")])
            for n in peers]
    last = RemoteId(peers[-1], 0)
    txns += [RemoteTxn(id=RemoteId(n, 0), parents=[last],
                       ops=[RemoteIns(ROOT_REMOTE_ID, last, "y")])
             for n in ("a", "p20x", "p35x")]
    return storm.compile_storm_txns(txns, 1, 0.0)


def _absent_left_in_scan(oll):
    """Two orders' origin-left table entries set to orders no item has
    (one past the table, one inside it): the conflict scans that pass
    those items take the serial step with the search of the whole state
    (``err[2]``)."""
    oll[5] = 70000
    oll[9] = 100


# name -> (stream, capacity, block_k, expected error rows); the storms of
# 40 and 48 peers put more than 32 concurrent inserts at one origin, and
# the tie runs carry a pinned scan_start across the kernel's 32-position
# sub-windows.
BLOCKED_MIXED_CASES = {
    "storm-4x10-k16": lambda: (_storm(4, 10, 2, 0.0), 256, 16, [0, 0, 0]),
    "storm-16x20-k32": lambda: (_storm(16, 20, 4, 0.0), 4096, 32,
                                [0, 0, 0]),
    "delete-storm-k16": lambda: (_storm(6, 20, 3, 0.3), 1024, 16,
                                 [0, 0, 0]),
    "local-k16": lambda: (_char_random(13, 60), 512, 16, [0, 0, 0]),
    "unknown-order": lambda: (_unknown_order(), 256, 16, [0, 1, 1]),
    "ties-40x3-k16": lambda: (_storm(40, 3, 1, 0.0), 512, 16, [0, 0, 0]),
    "ties-48x4-k32": lambda: (_storm(48, 4, 2, 0.0), 1024, 32, [0, 0, 0]),
    "tie-runs-past-32-k16": lambda: (_tie_runs(), 256, 16, [0, 0, 0]),
    "absent-origin": lambda: (_absent_origin(), 256, 16, [0, 0, 1]),
    "absent-left-in-scan": lambda: (_storm(4, 10, 2, 0.0), 256, 16,
                                    [0, 0, 1]),
    "storm-k2048": lambda: (_storm(8, 20, 4, 0.0), 4096, 2048, [0, 0, 0]),
    "storm-k4096": lambda: (_storm(8, 20, 4, 0.0), 8192, 4096, [0, 0, 0]),
    # 49,152 rows leave no room for the view beside the document: it goes
    # to device memory.
    "storm-view-in-device-memory": lambda: (_storm(4, 10, 2, 0.0), 49152,
                                            256, [0, 0, 0]),
}
MIXED_TABLE_EDITS = {"absent-left-in-scan": _absent_left_in_scan}


@pytest.mark.parametrize("name", sorted(BLOCKED_MIXED_CASES))
def test_blocked_mixed_kernel_matches_plain(card, name):
    from text_crdt_rust_tpu_torch.ops import blocked_mixed as TBM

    ops, capacity, block_k, flags = BLOCKED_MIXED_CASES[name]()
    rep = TBM.make_replayer_mixed(ops, capacity, batch=8, block_k=block_k,
                                  chunk=128, device=card)
    if name in MIXED_TABLE_EDITS:
        oll = rep.staged[9].clone()
        MIXED_TABLE_EDITS[name](oll)
        rep.staged = rep.staged[:9] + (oll,) + rep.staged[10:]
    plain = TBM.blocked_mixed_replay_plain(*rep.staged, **rep.shape)
    kern = _launched("blocked_mixed_replay",
                     lambda: TBM.blocked_mixed_replay_cuda(*rep.staged,
                                                           **rep.shape))
    _assert_equal(kern, plain)
    assert kern[4][:3].amax(dim=1).tolist() == flags


def _serve_ticks(S: int, lanes: int = 16, ticks: int = 3, seed: int = 0):
    """Three ``[S, lanes]`` serve ticks of remote txns from seeded
    two-agent histories, compiled per lane with a carried compiler state
    and fused as the batcher fuses them (W <= 8 at K = 32)."""
    import copy

    from text_crdt_rust_tpu_torch.models.oracle import ListCRDT
    from text_crdt_rust_tpu_torch.models.sync import export_txns_since

    rng = random.Random(seed)
    hist = []
    for b in range(lanes):
        # Mostly typing at the end (runs merge, so the rows stay inside
        # the lanes' row budget while the steps fill S), some scattered
        # inserts and deletes (splits).
        doc = ListCRDT()
        ids = [doc.get_or_create_agent_id(f"l{b}a{i}") for i in range(2)]
        for i in range(rng.randint(ticks * S, 2 * ticks * S)):
            if doc.get_next_order() > 1400:   # order capacity 1536
                break
            n = len(doc)
            a = ids[(i // 8) % 2]
            r = rng.random()
            if n > 2 and r < 0.1:
                doc.local_delete(a, rng.randrange(n - 1), 1)
            elif r < 0.2:
                doc.local_insert(a, rng.randint(0, n), "xy")
            else:
                doc.local_insert(a, n, "abcd"[: rng.randint(1, 4)])
        hist.append(export_txns_since(doc, 0))
    state = [(TB.AgentTable(), None, 0) for _ in range(lanes)]
    out = []
    for _ in range(ticks):
        streams = []
        for b in range(lanes):
            table, assigner, at = state[b]
            cur = TB.empty_ops(16)
            while at < len(hist[b]):
                t = hist[b][at]
                tab, asg = copy.deepcopy((table, assigner))
                for name in sorted({t.id.agent}):
                    tab.add(name)
                ops, asg = TB.compile_remote_txns([t], tab, assigner=asg,
                                                  lmax=16)
                nxt = TB.concat_ops([cur, ops])
                if nxt.num_steps > S:
                    break
                cur, table, assigner, at = nxt, tab, asg, at + 1
            state[b] = (table, assigner, at)
            if cur.num_steps > 1:
                cur, _ = TB.fuse_steps(cur, fuse_w=8)
            streams.append(TB.pad_ops(cur, S))
        out.append(TB.stack_ops(streams))
    return out


@pytest.mark.parametrize("S", [8, 32, 128])
def test_serve_lanes_backend_kernel_matches_plain(card, S):
    """The serve lanes backend at the serve geometry (K = 32, capacity
    512, OCAP 1536, 16 lanes): on the card every tick launches A7, and
    three warm-started ticks leave the state the plain backend leaves,
    bit for bit."""
    from text_crdt_rust_tpu_torch.serve.lanes_backend import (
        LanesMixedLaneBackend)

    geo = dict(lanes=16, capacity=512, order_capacity=1536, lmax=16,
               block_k=32, fuse_w=8)
    kb = LanesMixedLaneBackend(device=card, **geo)
    pb = LanesMixedLaneBackend(device="cpu", **geo)
    before = _kernels.launches.get("rle_lanes_mixed_blocked", 0)
    for tick in _serve_ticks(S):
        kb.apply(tick)
        pb.apply(tick)
    torch.cuda.synchronize()
    assert _kernels.launches["rle_lanes_mixed_blocked"] == before + 3
    assert kb.shapes_seen == pb.shapes_seen == {S}
    kb.barrier()
    pb.barrier()
    for k, p in zip(kb._state, pb._state):
        assert torch.equal(k.cpu(), p)
    assert np.array_equal(kb._lane_rows, pb._lane_rows)
    for b in range(16):
        assert np.array_equal(kb.lane_signed(b), pb.lane_signed(b))


# -- the flat engine's step-chain kernel (ops/csrc/flat_replay.cu) -------------


def _flat_local(seed, lmax=16):
    ops, _ = TB.compile_local_patches(
        randedit.random_patches(np.random.default_rng(seed), 120)[0],
        lmax=lmax)
    return ops


def _flat_storm(seed, lmax=16):
    txns, _ = randedit.make_storm(4, 8, 5, seed=seed, del_prob=0.3)
    table = TB.AgentTable(sorted({t.id.agent for t in txns}))
    ops, _ = TB.compile_remote_txns(txns, table, lmax=lmax)
    return ops


def _flat_fuzz(seed, steps=60, cap=256, lmax=16):
    """Arbitrary op columns: garbage orders, wrapping delete ranges."""
    rng = np.random.default_rng(seed)
    u = np.uint32

    def col(lo, hi):
        return rng.integers(lo, hi, steps, dtype=np.int64).astype(u)

    ins = col(0, lmax + 1)
    return TB.OpTensors(
        kind=col(0, 3), pos=col(0, cap // 4), del_len=col(0, 9),
        del_target=np.where(rng.random(steps) < 0.3,
                            col(0xFFFF_FFF0, 0x1_0000_0000),
                            col(0, 2 * cap)).astype(u),
        origin_left=np.where(rng.random(steps) < 0.2, 0xFFFF_FFFF,
                             rng.integers(0, 3 * cap, steps)).astype(u),
        origin_right=np.where(rng.random(steps) < 0.2, 0xFFFF_FFFF,
                              rng.integers(0, 3 * cap, steps)).astype(u),
        ins_len=ins, ins_order_start=(np.arange(steps) * lmax).astype(u),
        order_advance=ins.copy(), rank=col(0, 5),
        rows_per_step=(ins > 0).astype(u),
        chars=rng.integers(97, 123, (steps, lmax)).astype(u))


def _flat_fuzz_wrap(seed, lmax=16):
    """``_flat_fuzz`` with every 7th ``ins_len`` wrapping (negative as
    int32: the splice's full circular roll) and every 11th above ``lmax``,
    alternately within and past the roll's mask of its low bits."""
    o = _flat_fuzz(seed, lmax=lmax)
    ins = np.asarray(o.ins_len).copy()
    big = ins[3::11]
    big[:] = np.where(np.arange(big.size) % 2, lmax + 3, 3 * lmax + 5)
    ins[seed::7] = np.uint32(0xFFFF_FFF0 + seed)
    o.ins_len = ins
    return o


def _flat_train(T, lanes=6):
    """T ticks cut from per-lane streams, idle lanes and idle steps
    included, re-padded to one step count (as the serve backend pads)."""
    rng = np.random.default_rng(T)
    per = [_flat_local(10 + b) if b % 2 else _flat_storm(20 + b)
           for b in range(lanes)]
    at = [0] * lanes
    ticks = []
    for _ in range(T):
        cols = []
        for b in range(lanes):
            take = 0 if rng.random() < 0.3 else int(rng.integers(1, 12))
            lo, hi = at[b], min(per[b].num_steps, at[b] + take)
            at[b] = hi
            cols.append(TB._map_fields(lambda a: np.asarray(a)[lo:hi],
                                       per[b]) if hi > lo
                        else TB.empty_ops(16))
        ticks.append(TB.stack_ops([TB.pad_ops(c, max(
            1, max(x.num_steps for x in cols))) for c in cols]))
    s = max(t.num_steps for t in ticks) + 2
    return TB.stack_ticks([TB.pad_ops(t, s) for t in ticks])


def _flat_merge(seed, lmax=16):
    """Two peers' edits with cross-merges: remote inserts whose origins
    are real items (the YATA scan's lookups), remote deletes."""
    txns, _ = randedit.make_two_peer_merge(seed, rounds=12)
    table = TB.AgentTable(sorted({t.id.agent for t in txns}))
    ops, _ = TB.compile_remote_txns(txns, table, lmax=lmax)
    return ops


def _stack(streams):
    s = max(o.num_steps for o in streams)
    return TB.stack_ops([TB.pad_ops(o, s) for o in streams])


def _fresh(docs, ops):
    return docs


def _prefilled(docs, ops):
    return TB.prefill_logs(docs, ops)


def _played(docs, ops):
    """The first half of ``ops`` applied by the plain version, prefilled;
    the second half is what the case replays."""
    from text_crdt_rust_tpu_torch.ops import flat as TF

    docs = TB.prefill_logs(docs, ops)
    half = TB._map_fields(lambda a: np.asarray(a)[:ops.num_steps // 2],
                          ops)
    TF.flat_replay(docs, half, skip_idle=False)
    return docs


def _rows_past_n(docs, ops):
    """A played column with nonzero garbage rows written past ``n``."""
    docs = _played(docs, ops)
    rng = np.random.default_rng(11)
    cap = docs.signed.shape[1]
    for b in range(docs.signed.shape[0]):
        at = min(int(docs.n[b]), cap - 40)
        docs.signed[b, at:at + 40] = torch.from_numpy(
            rng.integers(-400, 400, 40).astype(np.int32))
        docs.n[b] = max(at - 4, 0)
    return docs


def _duplicate_order(docs, ops):
    """A played column where every 5th row repeats (tombstoned) the order
    two rows above it: a lookup must find the first of the two."""
    docs = _played(docs, ops)
    for b in range(docs.signed.shape[0]):
        for i in range(2, int(docs.n[b]), 5):
            docs.signed[b, i] = -abs(int(docs.signed[b, i - 2]))
    return docs


def _second_half(ops):
    return TB._map_fields(lambda a: np.asarray(a)[ops.num_steps // 2:], ops)


FLAT_CASES = {
    "local": lambda: (TB.stack_ops([_flat_local(s) for s in range(5)]),
                      False, _fresh),
    "storm": lambda: (TB.stack_ops([_flat_storm(s) for s in range(4)]),
                      False, _fresh),
    "fuzz": lambda: (TB.stack_ops([_flat_fuzz(s) for s in range(3)]),
                     False, _fresh),
    "fuzz-wrap": lambda: (TB.stack_ops([_flat_fuzz_wrap(s)
                                        for s in range(5)]), False, _fresh),
    "train-T1": lambda: (_flat_train(1), True, _fresh),
    "train-T4": lambda: (_flat_train(4), True, _fresh),
    "train-T8": lambda: (_flat_train(8), True, _fresh),
    "merge": lambda: (_stack([_flat_merge(s) for s in range(6)]), False,
                      _prefilled),
    "rows-past-n": lambda: (_stack([_flat_merge(s) for s in range(6)]),
                            False, _rows_past_n),
    "duplicate-order": lambda: (_stack([_flat_merge(s) for s in range(6)]),
                                False, _duplicate_order),
}
_FLAT_STATE = ("signed", "ol_log", "or_log", "rank_log", "n", "next_order")
_flat_plain_runs = {}


def _flat_case(name, cap, ocap=2048):
    """A case's ops, skip flag, input docs (CPU) and the plain version's
    result on them, computed once per (case, capacity)."""
    from text_crdt_rust_tpu_torch.ops import flat as TF
    from text_crdt_rust_tpu_torch.ops import span_arrays as TSA

    key = (name, cap, ocap)
    if key not in _flat_plain_runs:
        ops, skip, prep = FLAT_CASES[name]()
        lanes = np.asarray(ops.kind).shape[-1]
        docs = prep(TSA.stack_docs(TSA.make_flat_doc(cap, ocap, device="cpu"),
                                   lanes), ops)
        if prep in (_played, _rows_past_n, _duplicate_order):
            ops = _second_half(ops)
        plain = TF._batched_copy(docs)
        pf = TF.flat_replay(plain, ops, skip_idle=skip)
        _flat_plain_runs[key] = (ops, skip, docs, plain, pf)
    return _flat_plain_runs[key]


def _on_card(docs, card):
    from text_crdt_rust_tpu_torch.ops import flat as TF

    out = TF._batched_copy(docs)
    for f in _FLAT_STATE + ("chars_log",):
        setattr(out, f, getattr(out, f).to(card))
    return out


def _flat_cuda(docs, ops, skip, **kw):
    """One ``flat_replay_cuda`` launch on ``docs`` (on the card), ``kw``
    passed on (``stats``)."""
    from text_crdt_rust_tpu_torch.ops import flat as TF

    cols = TF.op_stack(ops)
    T, S = cols.shape[1], cols.shape[2]
    active = (TF.active_steps(ops).reshape(T, S) if skip
              else np.ones((T, S), bool))
    dev = docs.signed.device
    return TF.flat_replay_cuda(
        docs.signed, docs.ol_log, docs.or_log, docs.rank_log, docs.n,
        docs.next_order, torch.from_numpy(cols.view(np.int32).copy()).to(dev),
        torch.from_numpy(active.astype(np.int32)).to(dev), ops.lmax, **kw)


def _assert_flat_equal(kern, kf, plain, pf):
    assert torch.equal(kf.cpu(), pf)
    for f in _FLAT_STATE:
        assert torch.equal(getattr(kern, f).cpu(), getattr(plain, f)), f


@pytest.mark.parametrize("lanes_per_block", [1, 2, 4])
@pytest.mark.parametrize("cap", [256, 512, 4096])
@pytest.mark.parametrize("name", sorted(FLAT_CASES))
def test_flat_kernel_matches_plain(card, name, cap, lanes_per_block,
                                   monkeypatch):
    """One launch of the flat kernel through ``flat_replay``, at 1, 2 and
    4 lanes a thread block, leaves every lane's columns, counts and
    overflow flags as the plain version does, bit for bit (fresh logs
    read alike by both; small capacities set the flag; garbage columns
    with wrapping and oversized ``ins_len``; the merge cases prefilled,
    with garbage rows past ``n`` and with a tombstoned copy of an order
    above its first row)."""
    from text_crdt_rust_tpu_torch.ops import flat as TF

    ops, skip, docs, plain, pf = _flat_case(name, cap)
    monkeypatch.setattr(TF, "LANES_PER_BLOCK", (lanes_per_block,))
    assert TF.launch_geometry(cap).lanes_per_block == lanes_per_block
    kern = _on_card(docs, card)
    before = _kernels.launches.get("flat_replay", 0)
    kf = TF.flat_replay(kern, ops, skip_idle=skip)
    torch.cuda.synchronize()
    assert _kernels.launches["flat_replay"] == before + 1
    _assert_flat_equal(kern, kf, plain, pf)


@pytest.mark.parametrize("cap,lanes_per_block", [(16384, 2), (32768, 1)])
def test_flat_kernel_large_capacity_matches_plain(card, cap,
                                                  lanes_per_block):
    """Capacities whose columns do not fit four lanes a block take fewer,
    by shape; each equals the plain version."""
    from text_crdt_rust_tpu_torch.ops import flat as TF

    assert TF.launch_geometry(cap).lanes_per_block == lanes_per_block
    for name in ("merge", "duplicate-order", "fuzz-wrap", "train-T4"):
        ops, skip, docs, plain, pf = _flat_case(name, cap)
        kern = _on_card(docs, card)
        kf = TF.flat_replay(kern, ops, skip_idle=skip)
        torch.cuda.synchronize()
        _assert_flat_equal(kern, kf, plain, pf)


def test_flat_kernel_wide_batch_matches_plain(card):
    """1,024 lanes at capacity 512 (the serve wide shape's launch width):
    eight prefilled merge streams and eight local ones, tiled."""
    from text_crdt_rust_tpu_torch.ops import flat as TF
    from text_crdt_rust_tpu_torch.ops import span_arrays as TSA

    base = _stack([_flat_merge(s) for s in range(8)]
                  + [_flat_local(s) for s in range(8)])
    ops = TB._map_fields(lambda a: np.tile(
        np.asarray(a), (1, 64) + (1,) * (np.asarray(a).ndim - 2)), base)
    assert np.asarray(ops.kind).shape[-1] == 1024
    docs = TB.prefill_logs(TSA.stack_docs(
        TSA.make_flat_doc(512, 1536, device="cpu"), 1024), ops)
    plain = TF._batched_copy(docs)
    pf = TF.flat_replay(plain, ops, skip_idle=False)
    kern = _on_card(docs, card)
    kf = TF.flat_replay(kern, ops, skip_idle=False)
    torch.cuda.synchronize()
    _assert_flat_equal(kern, kf, plain, pf)


@pytest.mark.parametrize("name", ["merge", "train-T4", "rows-past-n"])
def test_flat_kernel_stats_build_matches_plain_build(card, name):
    """The counting build leaves what the main build leaves (and the
    plain version); its counters are sane: steps with work, an extent
    within the column covering every nonzero row, cycles."""
    from text_crdt_rust_tpu_torch.ops import flat as TF

    ops, skip, docs, plain, pf = _flat_case(name, 512)
    lanes = docs.signed.shape[0]
    stats = torch.zeros(lanes, TF.FLAT_STATS, dtype=torch.int64,
                        device=card)
    kern = _on_card(docs, card)
    kf = _flat_cuda(kern, ops, skip, stats=stats)
    main = _on_card(docs, card)
    mf = _flat_cuda(main, ops, skip)
    torch.cuda.synchronize()
    _assert_flat_equal(kern, kf, plain, pf)
    _assert_flat_equal(main, mf, plain, pf)
    st = dict(zip(TF.FLAT_STAT_NAMES, stats.cpu().T))
    nz = plain.signed != 0
    last = torch.where(nz.any(1), 512 - torch.argmax(
        nz.flip(1).to(torch.int8), dim=1), torch.zeros(lanes,
                                                       dtype=torch.int64))
    assert bool((st["extent"] >= last).all() and (st["extent"] <= 512).all())
    assert int(st["steps_with_work"].sum()) > 0
    assert bool((st["cy_all"] > 0).all())
    print(TF.describe_stats(stats.cpu()))


def test_flat_serve_backend_on_the_card_matches_plain(card):
    """The flat backend at ``ServeConfig()``'s geometry through a train of
    4 and a serial tick: the card's lanes equal the plain backend's."""
    from text_crdt_rust_tpu_torch.serve.batcher import FlatLaneBackend

    geo = dict(lanes=6, capacity=512, order_capacity=1536, lmax=16)
    kb = FlatLaneBackend(device=card, **geo)
    pb = FlatLaneBackend(device="cpu", **geo)
    train = _flat_train(4)
    ticks = [TB._map_fields(lambda a, t=t: np.asarray(a)[t], train)
             for t in range(4)]
    for be in (kb, pb):
        be.set_train_ticks(4)
        for t in ticks:
            be.apply(t)
        be.set_train_ticks(1)
        be.apply(TB.stack_ops([TB.pad_ops(TB.empty_ops(16), 2)] * 6))
        be.flush_train()
    for b in range(6):
        assert np.array_equal(kb.lane_signed(b), pb.lane_signed(b))
    for f in ("signed", "ol_log", "or_log", "rank_log", "chars_log", "n",
              "next_order"):
        assert torch.equal(getattr(kb.docs, f).cpu(), getattr(pb.docs, f))


def test_sp_doc_one_nccl_rank_matches_cpu(card):
    """Config sp's ``SpDoc`` in a one-rank NCCL world on the card equals the
    same run on one gloo CPU rank (run rows, expanded orders, text), and a
    two-rank world sharing the card over gloo equals it too; the A1 parity
    holds on the card."""
    from text_crdt_rust_tpu_torch import sp

    plan1 = sp.plan_sp(3000, 1)
    kern = sp.run_sp(backend="nccl", plan=plan1)
    plain = sp.run_sp(backend="gloo", device="cpu", plan=plan1,
                      parity=False)
    assert kern.ok and kern.parity_ok and plain.ok
    assert kern.shape["device"] == "cuda:0"
    # S1: one launch a stream attempt at sp = 1, nothing on the CPU.
    assert kern.replay["launches"]["sp_replay"] == (
        plan1.chunks + kern.replay["reshards"])
    assert plain.replay["launches"].get("sp_replay", 0) == 0
    # Mesh calls: each attempt's closing OR (and a reshard's read-back).
    assert kern.replay["collectives"] <= (
        plan1.chunks + 2 * kern.replay["reshards"])
    for k in ("expand", "text", "rows"):
        assert np.array_equal(np.asarray(kern.read[k]),
                              np.asarray(plain.read[k])), k
    two = sp.run_sp(backend="gloo", device="cuda:0",
                    plan=sp.plan_sp(3000, 2, slack=1.0), parity=False)
    assert two.ok and two.shape["shared_card"]
    assert np.array_equal(two.read["expand"], kern.read["expand"])
    assert two.replay["launches"]["sp_replay"] > two.plan.chunks


def _sp_cols(ops, chunk=None):
    """Op-column blocks ``[9, S]`` (int32 bits) of ``ops``, whole or cut
    every ``chunk`` steps."""
    from text_crdt_rust_tpu_torch.parallel.sp_apply import OP_FIELDS
    cols = np.stack([np.asarray(getattr(ops, f), np.uint32).view(np.int32)
                     for f in OP_FIELDS])
    step = chunk or cols.shape[1]
    return [cols[:, i:i + step] for i in range(0, cols.shape[1], step)]


def _sp_local(patches, lmax=8):
    return TB.compile_local_patches(TB.merge_patches(patches), lmax=lmax,
                                    dmax=None)[0]


def _sp_remote(txns, lmax=8):
    table = TB.AgentTable(sorted({t.id.agent for t in txns}))
    return TB.compile_remote_txns(txns, table, lmax=lmax, dmax=None)[0]


def _sp_order_miss():
    from text_crdt_rust_tpu_torch.common import RemoteId, RemoteIns, RemoteTxn
    root = RemoteId("ROOT", 0xFFFFFFFF)
    txns = [RemoteTxn(id=RemoteId("a", 0), parents=[],
                      ops=[RemoteIns(root, root, "ab")]),
            RemoteTxn(id=RemoteId("a", 2), parents=[],
                      ops=[RemoteIns(RemoteId("a", 1), root, "cd")])]
    cols = _sp_cols(_sp_remote(txns))[0].copy()
    cols[4, 1] = 90                     # an absent origin
    return [cols]


def _sp_tombstone_split():
    """A remote insert between two deleted characters: it splits a
    tombstone run, whose tail keeps its sign."""
    from text_crdt_rust_tpu_torch.common import (RemoteDel, RemoteId,
                                                 RemoteIns, RemoteTxn)
    root = RemoteId("ROOT", 0xFFFFFFFF)
    seen = [RemoteId("amy", 5)]
    txns = [RemoteTxn(id=RemoteId("amy", 0), parents=[],
                      ops=[RemoteIns(root, root, "abcdef")]),
            RemoteTxn(id=RemoteId("bob", 0), parents=seen,
                      ops=[RemoteDel(RemoteId("amy", 1), 3)]),
            RemoteTxn(id=RemoteId("cat", 0), parents=seen,
                      ops=[RemoteDel(RemoteId("amy", 2), 3)]),
            RemoteTxn(id=RemoteId("bob", 3), parents=seen,
                      ops=[RemoteIns(RemoteId("amy", 2), RemoteId("amy", 3),
                                     "XY")])]
    return _sp_cols(_sp_remote(txns))


def _sp_storm(seed, del_prob=0.0):
    return _sp_remote(randedit.make_storm(4, 8, 3, seed=seed,
                                          del_prob=del_prob)[0])


_SP_RANDOM = lambda: _sp_local(randedit.random_patches(
    random.Random(1), 300)[0])

#: name -> (rows a shard, table rows a shard, op-column blocks, stale rows
#: past ``rows`` (sp = 1), an even reload after each block, the error bit
#: the last block raises, 0 for none)
SP_CASES = {
    "local": lambda: (1024, 64, _sp_cols(_SP_RANDOM(), 64), None, False, 0),
    "local-capacity": lambda: (24, 64, _sp_cols(_SP_RANDOM(), 64), None,
                               False, 1),
    "local-resharded": lambda: (480, 64, _sp_cols(_SP_RANDOM(), 64), None,
                                True, 0),
    "bad-delete": lambda: (32, 64, _sp_cols(_sp_local(
        [TestPatch(0, 0, "ab"), TestPatch(0, 5, "")])), None, False, 2),
    "storm": lambda: (96, 1024, _sp_cols(_sp_storm(5), 16), None, True, 0),
    "storm-deletes": lambda: (128, 1024, _sp_cols(_sp_storm(7, 0.4), 16),
                              None, True, 0),
    "storm-deletes-capacity": lambda: (20, 1024, _sp_cols(
        _sp_storm(7, 0.4), 16), None, False, 1),
    "two-peer": lambda: (128, 1024, _sp_cols(_sp_remote(
        randedit.make_two_peer_merge(3, rounds=6)[0], lmax=4), 24), None,
        True, 0),
    "order-miss": lambda: (16, 64, _sp_order_miss(), None, False, 8),
    "tombstone-split": lambda: (16, 64, _sp_tombstone_split(), None, False,
                                0),
    "stale-rows": lambda: (256, 64, _sp_cols(_sp_local(
        randedit.random_patches(random.Random(4), 60)[0]), 30),
        (200, [5, -9, 77], [3, 1, 2]), False, 0),
    # S1's tile index (32-row tiles): E crossing 32 and 1,024 rows with R
    # not a multiple of 32; E past 16,384 rows (512 tiles, more than one
    # block scan of the index at 512 threads); shifts at q = 0 and at E =
    # R into the capacity error; a delete spanning many tiles; the full
    # pass (a live row of negative length, a live total past 2^31 with
    # every tile sane or not); a duplicated order on the remote path.
    "extent-marks": lambda: (1150, 64, _sp_blocks(_sp_edits(
        np.random.default_rng(11), 90, *_SP_DOCS["extent-marks"][2:]), 30),
        None, False, 0),
    "beyond-16k": lambda: (17000, 64, _sp_blocks(_sp_edits(
        np.random.default_rng(12), 48, *_SP_DOCS["beyond-16k"][2:],
        tail=0.5), 24), None, False, 0),
    "shift-edges": lambda: (45, 64, [_sp_op_cols(
        [(0, 0, 0, 0, 0, 0, 0, 1, k) for k in range(45)])], None, False, 1),
    # The stale live row at R - 1 is pushed off by the first shift: the
    # last delete, one past the 80 characters left, must flag.
    "shift-edges-stale": lambda: (70, 64, [_sp_op_cols(
        [(0, 0 if k % 3 else k, 0, 0, 0, 0, 0, 2, 2 * k) for k in range(40)]
        + [(0, 0, 81, 0, 0, 0, 0, 0, 0)])], (69, [7], [2]), False, 2),
    "delete-many-tiles": lambda: (700, 64, [_sp_delete_many(), _sp_op_cols(
        [(0, 10, 500, 0, 0, 0, 0, 0, 0)])], None, False, 2),
    # Error bits None: not asserted (they are compared as an output).
    "negative-live": lambda: (200, 64, [_sp_edits(
        np.random.default_rng(13), 60, *_SP_DOCS["negative-live"][2:])],
        None, False, None),
    "wrapping-total": lambda: (200, 64, [_sp_edits(
        np.random.default_rng(14), 60, *_SP_DOCS["wrapping-total"][2:])],
        None, False, None),
    "wrapping-total-sane": lambda: (200, 64, [_sp_edits(
        np.random.default_rng(15), 60,
        *_SP_DOCS["wrapping-total-sane"][2:])], None, False, None),
    "remote-full-pass": lambda: (64, 64, [_sp_op_cols(
        [(1, 0, 0, 0, 2, 3, 1, 2, 50), (1, 0, 0, 0, 41, ROOT_U32, 2, 1, 52),
         (2, 0, 2, 20, 0, 0, 0, 0, 0), (1, 0, 0, 0, 0, 1, 3, 2, 53)])],
        None, False, None),
    "duplicated-order": lambda: (64, 64, [_sp_op_cols(
        [(1, 0, 0, 0, 2, 3, 1, 2, 40), (2, 0, 2, 1, 0, 0, 0, 0, 0),
         (1, 0, 0, 0, 41, ROOT_U32, 2, 1, 42),
         (1, 0, 0, 0, 0, 1, 3, 1, 43)])], None, False, 0),
}

ROOT_U32 = 0xFFFFFFFF


def _sp_op_cols(rows):
    """Op columns ``[9, S]`` (int32 bits) from (kind, pos, del_len,
    del_target, origin_left, origin_right, rank, ins_len,
    ins_order_start) rows."""
    a = np.asarray(rows, np.int64) & 0xFFFFFFFF
    return np.ascontiguousarray(a.astype(np.uint32).view(np.int32).T)


def _sp_blocks(cols, step):
    return [np.ascontiguousarray(cols[:, i:i + step])
            for i in range(0, cols.shape[1], step)]


def _sp_edits(rng, steps, total, order, tail=0.0):
    """Local edits on a document of ``total`` live characters, orders from
    ``order``: deletes, inserts and both in one step at random positions
    (``tail``: that share of them in the document's last 64
    characters)."""
    rows = []
    for _ in range(steps):
        lo = max(0, total - 64) if rng.random() < tail else 0
        d = (int(rng.integers(1, min(6, total) + 1))
             if total > 0 and rng.random() < 0.5 else 0)
        il = int(rng.integers(1, 4)) if d == 0 or rng.random() < 0.3 else 0
        p = int(rng.integers(min(lo, total - d), total - d + 1))
        rows.append((0, p, d, 0, 0, 0, 0, il, order))
        total += il - d
        order += il
    return _sp_op_cols(rows)


def _sp_doc(lens, dead=()):
    """Runs of consecutive orders with these lengths (the rows ``dead``
    deleted): (ordp, lenp, live total, next order)."""
    lens = np.asarray(lens, np.int64)
    start = np.concatenate(([0], np.cumsum(np.maximum(lens, 1))[:-1]))
    sign = np.ones(len(lens), np.int64)
    sign[list(dead)] = -1
    live = _wrapped(int(np.where(sign > 0, lens, 0).sum()))
    return ((sign * (start + 1)).astype(np.int32), lens.astype(np.int32),
            max(live, 0), int(np.maximum(lens, 1).sum()))


def _sp_doc_negative():
    lens = np.random.default_rng(21).integers(1, 5, 120)
    lens[17], lens[70] = -3, -40
    return _sp_doc(lens, dead=(5, 40))


def _wrapped(n):
    """n as the int32 a wrapping sum leaves."""
    return (n + (1 << 31)) % (1 << 32) - (1 << 31)


def _sp_delete_many():
    """Deletes spanning many tiles (and inserts in what they leave) on
    ``_SP_DOCS["delete-many-tiles"]``."""
    total, order = _SP_DOCS["delete-many-tiles"][2:]
    return _sp_op_cols([
        (0, 5, total - 300, 0, 0, 0, 0, 0, 0),
        (0, 3, 0, 0, 0, 0, 0, 2, order), (0, 0, 40, 0, 0, 0, 0, 0, 0),
        (0, 1, 100, 0, 0, 0, 0, 3, order + 2), (0, 2, 3, 0, 0, 0, 0, 0, 0),
        (0, 0, 162, 0, 0, 0, 0, 0, 0)])


#: name -> (ordp, lenp, live total, next order) of a document loaded
#: before the streams (``SpDoc.load``: spread evenly over the shards).
_SP_DOCS = {
    "extent-marks": _sp_doc(np.random.default_rng(31).integers(1, 4, 1000)),
    "beyond-16k": _sp_doc(np.random.default_rng(32).integers(1, 4, 16_600)),
    "delete-many-tiles": _sp_doc(
        np.random.default_rng(33).integers(1, 5, 600), dead=(7, 100, 101)),
    "negative-live": _sp_doc_negative(),
    # Live totals past 2^32, so that the wrapped total the plain version
    # sees is small: its row-level counts then cross 2^31 and back.
    "wrapping-total": _sp_doc([3, 1 << 30, 2, 1 << 30, 5, 1 << 30, 4,
                               1 << 30] + [2] * 40),
    "wrapping-total-sane": _sp_doc([(1 << 25) + 3] * 130 + [3] * 20),
    # A deleted run of negative length: every raw count takes the full
    # pass.
    "remote-full-pass": (np.asarray([1, 21, -31, 41], np.int32),
                         np.asarray([5, 2, -3, 4], np.int32), 11, 50),
    "duplicated-order": (np.asarray([1, 21, 1, 30], np.int32),
                         np.asarray([5, 2, 5, 3], np.int32), 15, 40),
}

#: name -> by-order tables (oll, orl, rkl) loaded with the document.
_SP_TABLES = {
    "remote-full-pass": (
        np.asarray([ROOT_U32, 0, 1, 2, 3] + [ROOT_U32] * 45,
                   np.uint32).view(np.int32),
        np.full(50, -1, np.int32), np.zeros(50, np.int32)),
    "duplicated-order": (
        np.asarray([ROOT_U32, 0, 1, 2, 3] + [ROOT_U32] * 35,
                   np.uint32).view(np.int32),
        np.full(40, -1, np.int32), np.zeros(40, np.int32)),
}


@pytest.fixture(scope="module")
def sp_worlds():
    """A one-rank NCCL world and two ranks sharing the card over gloo."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from text_crdt_rust_tpu_torch.parallel.launch import World
    w1 = World(1, "nccl", timeout=300)
    w2 = World(2, "gloo", "cuda:0", timeout=300)
    yield {1: w1, 2: w2}
    w1.close()
    w2.close()


@pytest.mark.parametrize("name, nsp", [(n, k) for n in sorted(SP_CASES)
                                       for k in (1, 2)
                                       if not (n.endswith("stale")
                                               or n == "stale-rows")
                                       or k == 1])
def test_sp_kernel_matches_plain(sp_worlds, name, nsp):
    """S1 (one launch a block at sp = 1, one a segment at sp = 2) leaves
    every output as the plain version does from the same state, bit for
    bit: the whole ``[R]`` planes (rows past ``rows`` too), ``rows``, the
    tables, both logs and the error bits; the error paths included."""
    import torch_world_jobs as jobs

    R, OTS, streams, stale, reshard, last_err = SP_CASES[name]()
    runs = _SP_DOCS[name][:2] if name in _SP_DOCS else None
    got = sp_worlds[nsp].run(jobs.sp_kernel_job, nsp, R, OTS, runs,
                             streams, stale, reshard,
                             tables=_SP_TABLES.get(name))
    for err, rows, bad, launches in got:
        assert bad == [], (name, nsp, bad)
        assert launches == 1 if nsp == 1 else launches > 1
    if last_err:
        assert got[-1][0] & last_err, got[-1]
    elif last_err == 0:
        assert got[-1][0] == 0 and len(got) == len(streams)


#: The cases whose states send S1 to its full pass: a live row of negative
#: length, a live total past 2^31 (tiles sane or not), a deleted row of
#: negative length on the remote path.
_SP_FULL_PASS = ("negative-live", "wrapping-total", "wrapping-total-sane",
                 "remote-full-pass")


@pytest.mark.parametrize("name", ["local", "beyond-16k", "storm-deletes",
                                  "duplicated-order", *_SP_FULL_PASS])
def test_sp_kernel_stats_build_matches_main(card, name):
    """S1's counting build (``stats=``) leaves every output as the main
    build does, block after block at sp = 1, and its counters say which
    path ran: full passes exactly on the states that need them, the
    extent, the shifts."""
    from text_crdt_rust_tpu_torch.parallel import sp_kernel as SK
    from text_crdt_rust_tpu_torch.parallel.sp_apply import TAB_UNKNOWN

    R, OTS, streams, stale, _, _ = SP_CASES[name]()
    st = [torch.zeros(R, dtype=torch.int32, device=card) for _ in range(2)]
    st += [torch.zeros(1, dtype=torch.int32, device=card)]
    st += [torch.full((OTS,), TAB_UNKNOWN, dtype=torch.int32, device=card)
           for _ in range(2)]
    st += [torch.zeros(OTS, dtype=torch.int32, device=card)]
    if name in _SP_DOCS:
        o, ln = _SP_DOCS[name][:2]
        st[0][:len(o)] = torch.as_tensor(o, device=card)
        st[1][:len(o)] = torch.as_tensor(ln, device=card)
        st[2][0] = len(o)
    for k, t in enumerate(_SP_TABLES.get(name, ())):
        st[3 + k][:len(t)] = torch.as_tensor(t, device=card)
    stats = torch.zeros(SK.SP_STATS, dtype=torch.int64, device=card)
    for cols in streams:
        main = SK.sp_replay_cuda(*st, cols)
        counted = SK.sp_replay_cuda(*st, cols, stats=stats)
        torch.cuda.synchronize()
        for m, k in zip(main, counted):
            assert torch.equal(m, k)
        st = [t.clone() for t in main[:6]]
    d = dict(zip(SK.SP_STAT_NAMES, stats.tolist()))
    assert (d["fallbacks"] > 0) == (name in _SP_FULL_PASS), d
    assert d["segments"] > 0 and d["moves"] > 0 and d["cy_all"] > 0, d
    rows = int(st[2][0])
    assert min(R, rows + 2) <= d["extent"] <= R, (d["extent"], rows)


def test_streamed_runs_on_the_card_match_cpu(card):
    """``StreamedRuns`` with its tiles on the card answers as on the CPU."""
    from text_crdt_rust_tpu_torch.ops.stream_scan import StreamedRuns

    rng = np.random.default_rng(4)
    rows = 50_000
    lens = rng.integers(1, 9, rows).astype(np.int32)
    starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
    sign = np.where(rng.random(rows) < 0.7, 1, -1)
    perm = rng.permutation(rows)
    ordp = (sign * (starts[perm] + 1)).astype(np.int32)
    lenp = lens[perm]
    on = StreamedRuns(ordp, lenp, tile=4096, device=card)
    off = StreamedRuns(ordp, lenp, tile=4096, device="cpu")
    assert on.live_total() == off.live_total()
    for r in rng.integers(0, on.live_total() + 2, 300).tolist():
        assert on.position_of_live_rank(r) == off.position_of_live_rank(r)
    for o in rng.integers(-1, int(lens.sum()) + 2, 300).tolist():
        assert on.order_to_position(o) == off.order_to_position(o)
