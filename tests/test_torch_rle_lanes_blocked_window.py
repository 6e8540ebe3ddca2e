"""A plain-Python model of the bounded order search of the blocked
per-lane mixed replay kernel (``ops/csrc/rle_lanes_mixed_blocked.cu``,
A7) held equal to ``lanes_mixed_blocked_replay_plain`` after every op of
seeded streams.

The kernel computes what the plain version computes. When an order's
hint and its two forward hops miss, the TPU kernel searches every row of
the document's plane; the kernel searches the blocks [0, bhi) only, where
``bhi`` is one past the last block holding a nonzero ordp row: found from
the input (every row, stale rows past ``rws`` included) and raised by
every write to a block (a splice's scatter, a split's two blocks). That
is exact if no row at or past ``bhi * K`` ever holds an order.

The model tracks ``bhi`` per lane through the plain version's block
writes; after every op it checks that every row at or past ``bhi`` has
ordp 0, at every order lookup that the search over [0, bhi) finds what
the search over all rows finds, and at the end that the blocks at or past
``bhi`` come out as they went in.
Inputs: 5r-like streams (a warm-start chain of remote and local ops),
the shared case builders with tiny blocks (splits, stale hints, hops,
plane fallbacks), warm starts with nonzero rows past ``rws``, splits at
table capacity (err row 0), a delete past the end (err row 1), an
unknown order (err row 2) and K = 2,048. Tolerance: none, the state is
integers.
"""
import pytest
import torch

from test_torch_lanes_mixed_blocked import CASES, LANES, OCAP
from test_torch_rle_lanes_mixed import pad_lanes, to_port
from text_crdt_rust_tpu_torch import stream
from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as TM



class Bound:
    """Per lane: bhi, and the searches checked."""

    def __init__(self, ordp, K):
        CAP, B = ordp.shape
        self.K, self.NB = K, CAP // K
        nz = (ordp != 0).reshape(self.NB, K, B).any(dim=1)  # [NB, B]
        idx = torch.arange(1, self.NB + 1)[:, None]
        self.bhi = torch.where(nz, idx, 0).amax(dim=0)  # [B]
        self.searches = 0

    def wrote(self, b, act):
        b, act = b.reshape(-1), act.reshape(-1)
        ok = act & (b >= 0) & (b < self.NB)
        self.bhi = torch.where(ok, torch.maximum(self.bhi, b + 1), self.bhi)

    def check_rows(self, ordp):
        rows = torch.arange(ordp.shape[0])[:, None]
        past = rows >= (self.bhi * self.K)[None, :]
        assert not bool((past & (ordp != 0)).any()), "nonzero row past bhi"

    def check_search(self, ordp, lenp, o):
        """The first row holding order o (per lane) over all rows and over
        the rows below bhi * K agree."""
        CAP = ordp.shape[0]
        rows = torch.arange(CAP)[:, None]
        so = ordp.abs() - 1
        hit = (ordp != 0) & (so <= o) & (o < so + lenp)
        full = torch.where(hit, rows, CAP).amin(dim=0)
        inside = hit & (rows < (self.bhi * self.K)[None, :])
        bounded = torch.where(inside, rows, CAP).amin(dim=0)
        assert torch.equal(full, bounded)
        self.searches += 1


def _replay_with_bound(monkeypatch, run_args, shape):
    """Runs the plain version with the model follobndg every block write,
    every op and every order lookup. Returns the outputs and the model."""
    state = {}
    orig_scatter, orig_scatter2 = TM.scatter_block, TM.scatter_block2

    def scatter_block(plane, b, vals, act, K, NB):
        if plane is state["plain"].ordp:
            state["bound"].wrote(b, act)
        return orig_scatter(plane, b, vals, act, K, NB)

    def scatter_block2(plane, b, v1, nbv, v2, do, K, NB):
        if plane is state["plain"].ordp:
            state["bound"].wrote(b, do)
            state["bound"].wrote(nbv, do)
        return orig_scatter2(plane, b, v1, nbv, v2, do, K, NB)

    base = TM._PlainBlocked

    class BoundBlocked(base):
        def __init__(self, *args):
            super().__init__(*args)
            state["plain"] = self
            state["bound"] = Bound(self.ordp, self.K)

        def locate_order(self, o, want, flag):
            state["bound"].check_search(self.ordp, self.lenp, o)
            return super().locate_order(o, want, flag)

        def locate_order_pure(self, o):
            state["bound"].check_search(self.ordp, self.lenp, o)
            return super().locate_order_pure(o)

    for name in ("do_local_delete", "do_local_insert", "do_remote_insert",
                 "do_remote_delete"):
        def op(self, *a, _name=name):
            getattr(base, _name)(self, *a)
            state["bound"].check_rows(self.ordp)
        setattr(BoundBlocked, name, op)

    monkeypatch.setattr(TM, "_PlainBlocked", BoundBlocked)
    monkeypatch.setattr(TM, "scatter_block", scatter_block)
    monkeypatch.setattr(TM, "scatter_block2", scatter_block2)
    outs = TM.lanes_mixed_blocked_replay_plain(*run_args, **shape)
    bnd = state["bound"]
    # The write-back: blocks at or past bhi leave the launch as they came.
    ord0, len0 = run_args[10], run_args[11]
    rows = torch.arange(ord0.shape[0])[:, None]
    past = rows >= (bnd.bhi * bnd.K)[None, :]
    assert torch.equal(torch.where(past, outs[2], 0),
                       torch.where(past, ord0, 0))
    assert torch.equal(torch.where(past, outs[3], 0),
                       torch.where(past, len0, 0))
    return outs, bnd


def _stale(state):
    """A warm state with one row past ``rws`` left in slot 0's block of
    every lane that has two rows there (nonzero rows past the rows in
    use)."""
    st = list(state)
    rws = st[4].clone()
    rws[0] = torch.where(rws[0] >= 2, rws[0] - 1, rws[0])
    st[4] = rws
    return tuple(st)


def _case(name):
    stacked, shape, _txns, err_row = CASES[name]()
    rep = TM.make_replayer_lanes_mixed_blocked(
        to_port(pad_lanes(stacked, LANES)), order_capacity=OCAP, chunk=128,
        device="cpu", **shape)
    return rep, err_row


# The shared cases but the three longest two- and n-peer merges (the
# 5r-like chain below covers remote merges).
FAST_CASES = sorted(set(CASES) - {"two-peer-3-k16", "two-peer-21-k16",
                                  "n-peer-1-k16"})


@pytest.mark.parametrize("name", FAST_CASES)
def test_bound_model_matches_plain(monkeypatch, name):
    rep, err_row = _case(name)
    args = (*rep.staged, *rep.initial(), *rep.deltas)
    outs, bnd = _replay_with_bound(monkeypatch, args, rep.shape)
    flags = outs[-1][:3].amax(dim=1).tolist()
    if err_row is None:
        assert flags == [0, 0, 0]
    else:
        assert flags[err_row] == 1


def _chain_5r(n_docs=3, chunks=2, steps=12):
    """The stacked chunks of a small 5r-like stream (local and remote
    ops per document)."""
    return stream.make_stream_5r(n_docs=n_docs, chunks=chunks,
                                 steps_per_chunk=steps,
                                 seed_base=900).stacked


@pytest.mark.parametrize("stale", [False, True])
def test_bound_model_on_5r_chain(monkeypatch, stale):
    """A 5r-like warm-start chain (K = 8, capacity 256), the second chunk
    from the first one's state, with a nonzero row past ``rws`` in slot
    0's block of every lane when ``stale``."""
    first, second = _chain_5r()
    make = TM.make_replayer_lanes_mixed_blocked
    rep = make(first, capacity=256, block_k=8, chunk=16, device="cpu")
    with monkeypatch.context() as mp:
        outs, b1 = _replay_with_bound(
            mp, (*rep.staged, *rep.initial(), *rep.deltas), rep.shape)
    state = outs[2:-1]
    if stale:
        state = _stale(state)
    rep = make(second, capacity=256, block_k=8, chunk=16, device="cpu",
               init=state)
    with monkeypatch.context() as mp:
        outs, b2 = _replay_with_bound(
            mp, (*rep.staged, *rep.initial(), *rep.deltas), rep.shape)
    assert outs[-1][:3].amax().item() == 0
    assert b1.searches + b2.searches > 0


def test_bound_model_k2048(monkeypatch):
    """K = 2,048: the first chunk of the 5r-like stream, two blocks."""
    rep = TM.make_replayer_lanes_mixed_blocked(
        _chain_5r()[0], capacity=4096, block_k=2048, chunk=16, device="cpu")
    outs, _ = _replay_with_bound(
        monkeypatch, (*rep.staged, *rep.initial(), *rep.deltas), rep.shape)
    assert outs[-1][:3].amax().item() == 0
