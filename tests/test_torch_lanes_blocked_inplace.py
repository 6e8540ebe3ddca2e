"""A plain-Python model of the redesigned blocked per-lane local replay
kernel (``ops/csrc/rle_lanes_blocked.cu``, A5) held equal to
``lanes_blocked_replay_plain`` after every op of seeded streams.

The kernel computes what the plain version computes; it changes where the
rows live and how a step edits them:

- each document's rows stay where they live for the whole launch (shared
  memory, or its lane-major planes in device memory), and every step
  edits its block there: no block is gathered into scratch and scattered
  back. A block id outside [0, NB) (a corrupt table) gets a copy of block
  0 that is never written back, as ``gather_block`` reads block 0 and
  ``scatter_block`` writes nothing there;
- an in-block locate stops at the first 32-row round whose live prefix
  reaches the rank, and a delete's pass works only in the rounds its
  range covers, carrying its at most two partly covered runs (row, run,
  covered range) from the pass to the splits;
- a splice of ``a`` rows at row q shifts only rows [q + a, K), in place,
  top down (of the TPU kernel's circular roll only that shows; rows
  pushed past K are lost, as the roll wraps them onto rows the splice
  overwrites), unless the roll amount is not ``a`` (a step wider than
  the stream's WMAX), where the whole roll runs from a copy;
- the live prefix is kept up over the slots in use only, [l, nlog): its
  entries past nlog are scratch that no read reaches before a split's
  shift overwrites them;
- a split writes the moved half to the fresh block first, then zeroes
  the old block's rows from ``keep`` (the other way round, from a copy,
  where a corrupt table names the fresh block as the split one), and
  shifts the four slot tables one slot down past l in one pass;
- an insert's successor comes from the pre-splice rows: the next row of
  its block, else the head row of the next slot's block.

The model follows those rules on Python lists, one document at a time; a
subclass of the plain version's state replays each op on it and compares
every row of the document, the slot tables (all NBT rows), the live
prefix over the slots in use, the origins and the error rows after every
op. Inputs: config-5 streams (a warm-start chain whose capacity grows),
random streams at K = 8 (many splits), a capacity overflow (err row 0), a
delete past the end (err row 1), fused W-row bursts (also replayed with a
WMAX narrower than the stream's W, which takes the whole-roll path), K =
4,096, a warm start with a stale row past ``rws`` and a corrupt table.
Tolerance: none, the state is integers.
"""
import random

import numpy as np
import pytest
import torch

from text_crdt_rust_tpu_torch import stream
from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch.ops import rle_lanes as RL
from text_crdt_rust_tpu_torch.ops.blocked import _roll_amount
from text_crdt_rust_tpu_torch.utils import randedit
from text_crdt_rust_tpu_torch.utils.testdata import TestPatch

ROOT = -1
_PLAIN = RL._PlainBlocked


def _split_pieces(o, ln, cs, ce):
    head, tail = cs > 0, ce < ln
    cov = ce - cs
    amt = int(head) + int(tail)
    if head:
        return amt, [(o, cs), (-(o + cs), cov), (o + ce, ln - ce)]
    return amt, [(-(o + cs), cov), (o + ce, ln - ce), (o + ce, ln - ce)]


class Doc:
    """One document of the kernel's state."""

    def __init__(self, O, L, nlog, blk, rws, liv, K, WMAX):
        self.O, self.L = list(O), list(L)
        self.K, self.NB, self.NBT, self.WMAX = K, len(O) // K, len(blk), WMAX
        self.nlog = max(nlog, 1)
        self.blk, self.rws, self.liv = list(blk), list(rws), list(liv)
        self.cliv = list(np.cumsum(liv, dtype=np.int64).astype(int))
        self.e0 = self.e1 = 0
        self.splits = self.copies = self.rounds_skipped = 0

    # -- rows and tables ---------------------------------------------------

    def trow(self, t, l):
        return t[l] if 0 <= l < self.NBT else 0

    def block(self, b):
        """(o, l, write_back): the block's rows where they live, or a copy
        of block 0 for an id outside [0, NB)."""
        K = self.K
        if 0 <= b < self.NB:
            return self.O[b * K:(b + 1) * K], self.L[b * K:(b + 1) * K], b
        self.copies += 1
        return self.O[:K], self.L[:K], None

    def store(self, o, ln, b):
        if b is not None:
            K = self.K
            self.O[b * K:(b + 1) * K], self.L[b * K:(b + 1) * K] = o, ln

    def head(self, b):
        return self.O[(b if 0 <= b < self.NB else 0) * self.K]

    def slot(self, rank1):
        n = min(self.nlog, self.NBT)
        c = sum(1 for t in range(n) if self.cliv[t] < rank1)
        return min(c, self.nlog - 1)

    def live_before(self, l):
        return self.trow(self.cliv, l) - self.trow(self.liv, l)

    def upkeep(self, l, drows, dlive):
        if 0 <= l < self.NBT:
            self.rws[l] += drows
            self.liv[l] += dlive
        for i in range(max(l, 0), min(self.nlog, self.NBT)):
            self.cliv[i] += dlive

    # -- row passes ----------------------------------------------------------

    @staticmethod
    def shift_tail(o, ln, q, a):
        """Rows [q, K) take row j - a, top down, in place."""
        if a > 0:
            for j in range(len(o) - 1, max(q, 0) - 1, -1):
                o[j], ln[j] = o[j - a], ln[j - a]

    def locate(self, o, ln, r0, x):
        """(i_r, cum at i_r, live count at i_r) of the in-block count,
        stopping at the first 32-row round that reaches x."""
        K, run, c = self.K, 0, self.K
        lv = [ln[j] if o[j] > 0 else 0 for j in range(K)]
        for j0 in range(0, K, 32):
            rnd = lv[j0:j0 + 32]
            if run + sum(rnd) >= x:
                inc = run
                for f, v in enumerate(rnd):
                    inc += v
                    if inc >= x:
                        c = j0 + f
                        break
                break
            run += sum(rnd)
        i_r = max(min(c, r0), 0)
        if i_r >= K:
            return i_r, 0, 0
        return i_r, sum(lv[:i_r + 1]), lv[i_r]

    def apply_partial(self, o, ln, i, run, cs, ce):
        amt, pieces = _split_pieces(run[0], run[1], cs, ce)
        self.shift_tail(o, ln, i + 1 + amt, amt)
        for k in range(amt + 1):
            if 0 <= i + k < self.K:
                o[i + k], ln[i + k] = pieces[k]
        return amt

    # -- ops -----------------------------------------------------------------

    def split(self, l):
        if self.nlog >= self.NB:
            self.e0 = 1
            return
        self.splits += 1
        K, NBT = self.K, self.NBT
        b, r = self.trow(self.blk, l), self.trow(self.rws, l)
        keep = r // 2
        mv, nbv = r - keep, self.nlog
        real = 0 <= b < self.NB
        bc = b if real else 0
        so = self.O[bc * K:(bc + 1) * K]  # the old rows: the split reads
        sl = self.L[bc * K:(bc + 1) * K]  # them before writing (or a copy)
        liv_hi = sum(sl[j] for j in range(max(keep, 0), min(r, K))
                     if so[j] > 0)
        up = _roll_amount(keep, K, K)
        new_o = [so[(j + up) % K] if j < mv else 0 for j in range(K)]
        new_l = [sl[(j + up) % K] if j < mv else 0 for j in range(K)]
        same = nbv == bc
        if not same:
            self.O[nbv * K:(nbv + 1) * K] = new_o
            self.L[nbv * K:(nbv + 1) * K] = new_l
        if real:
            for j in range(max(keep, 0), K):
                self.O[b * K + j] = self.L[b * K + j] = 0
        if same:
            self.copies += 1
            self.O[nbv * K:(nbv + 1) * K] = new_o
            self.L[nbv * K:(nbv + 1) * K] = new_l
        for t in (self.blk, self.rws, self.liv, self.cliv):
            for i in range(NBT - 1, l, -1):
                if i >= 1:
                    t[i] = t[i - 1]
        if 0 <= l < NBT:
            self.rws[l] = keep
            self.liv[l] -= liv_hi
            self.cliv[l] -= liv_hi
        if 0 <= l + 1 < NBT:
            self.rws[l + 1] = mv
            self.liv[l + 1] = liv_hi
            self.blk[l + 1] = nbv
        self.nlog += 1

    def delete(self, p, dl):
        K, rem, iters = self.K, dl, 0
        while rem > 0 and iters <= 2 * self.NBT:
            l = self.slot(p + 1)
            if self.trow(self.rws, l) + 2 > K:
                self.split(l)
                l = self.slot(p + 1)
            base = self.live_before(l)
            o, ln, wb = self.block(self.trow(self.blk, l))
            run, tot, parts = 0, 0, []
            for j0 in range(0, K, 32):
                lv = [ln[j] if o[j] > 0 else 0 for j in range(j0, min(j0 + 32,
                                                                     K))]
                s = sum(lv)
                if base + run + s > p and base + run < p + rem:
                    before = base + run
                    for u, v in enumerate(lv):
                        j = j0 + u
                        cs = min(max(p - before, 0), v)
                        ce = min(max(p + rem - before, 0), v)
                        cov = ce - cs
                        tot += cov
                        if cov > 0 and cov == ln[j]:
                            o[j] = -o[j]
                        elif cov > 0:
                            parts.append((j, (o[j], ln[j]), cs, ce))
                        before += v
                else:
                    self.rounds_skipped += 1
                run += s
            a1 = a2 = 0
            if parts:
                j, r, cs, ce = parts[-1]
                a2 = self.apply_partial(o, ln, j, r, cs, ce)
            if len(parts) == 2:
                j, r, cs, ce = parts[0]
                a1 = self.apply_partial(o, ln, j, r, cs, ce)
            self.store(o, ln, wb)
            self.upkeep(l, a1 + a2, -tot)
            rem -= tot
            iters += 1
        if rem > 0:
            self.e1 = 1

    def insert(self, p, il, st, w):
        K, NBT = self.K, self.NBT
        l = 0 if p == 0 else self.slot(p)
        if self.trow(self.rws, l) + w + 1 > K:
            self.split(l)
            l = 0 if p == 0 else self.slot(p)
        r0 = self.trow(self.rws, l)
        local = p - self.live_before(l)
        o, ln, wb = self.block(self.trow(self.blk, l))
        i_r, cum, v = self.locate(o, ln, r0, local)
        o_r = o[i_r] if i_r < K else 0
        l_r = ln[i_r] if i_r < K else 0
        off = local - (cum - v)
        left = ROOT if p == 0 else (o_r - 1) + (off - 1)
        nxt_in_blk = o[i_r + 1] if 0 <= i_r + 1 < K else 0
        nxt_slot_o = self.head(self.trow(self.blk, min(l + 1, NBT - 1)))
        succ_p0 = self.head(self.trow(self.blk, 0)) \
            if self.trow(self.rws, 0) > 0 else 0
        lrun = il // max(w, 1)
        mrg = w == 1 and p > 0 and off == l_r and st + 1 == o_r + l_r
        is_split = p > 0 and off < l_r
        ins_at = 0 if p == 0 else i_r + 1
        amt = 0 if mrg else w + int(is_split)
        ra = _roll_amount(amt, self.WMAX + 1, K)
        if ra == amt:
            self.shift_tail(o, ln, ins_at + amt, amt)
        else:  # the whole roll, from a copy
            self.copies += 1
            xo, xl = list(o), list(ln)
            for j in range(ins_at, K):
                o[j], ln[j] = xo[(j - ra) % K], xl[(j - ra) % K]
        if is_split and 0 <= i_r < K:
            ln[i_r] = off
        if not mrg:
            for j in range(ins_at, min(ins_at + w, K)):
                o[j] = st + il - (j - ins_at + 1) * lrun + 1
                ln[j] = lrun
        if is_split and ins_at + w < K:
            o[ins_at + w], ln[ins_at + w] = o_r + off, l_r - off
        if mrg and 0 <= i_r < K:
            ln[i_r] = l_r + il
        self.store(o, ln, wb)
        succ_after = nxt_in_blk if i_r + 1 < r0 else (
            nxt_slot_o if l + 1 < self.nlog else 0)
        succ = succ_p0 if p == 0 else (o_r + off if is_split else succ_after)
        self.upkeep(l, amt, il)
        return left, ROOT if succ == 0 else abs(succ) - 1


def _col(t, b):
    return [int(x) for x in t[:, b].tolist()]


def _check(docs, st):
    for b, d in enumerate(docs):
        assert d.nlog == int(st.nlogv[0, b])
        assert d.O == _col(st.ordp, b), f"ordp of document {b}"
        assert d.L == _col(st.lenp, b), f"lenp of document {b}"
        for name, tab in (("blkord", d.blk), ("rws", d.rws), ("liv", d.liv)):
            assert tab == _col(getattr(st, name), b), f"{name} of {b}"
        n = min(d.nlog, d.NBT)
        assert d.cliv[:n] == _col(st.cumliv, b)[:n], f"cumliv of {b}"
        assert (d.e0, d.e1) == (int(st.err[0, b]), int(st.err[1, b]))


def _replay(monkeypatch, run, state=None, wmax=None):
    """Replays one launch with the plain version while a model of each
    document follows every op; returns the plain outputs and the models."""
    docs = []

    class Modelled(_PLAIN):
        def __init__(self, st8, S, K, wm, dev):
            super().__init__(st8, S, K, wm, dev)
            for b in range(self.ordp.shape[1]):
                docs.append(Doc(*(_col(t, b) for t in st8[:2]),
                                int(st8[2][0, b]),
                                *(_col(t, b) for t in st8[3:]), K, wm))

        def do_delete(self, act, p, d):
            super().do_delete(act, p, d)
            for b, doc in enumerate(docs):
                if bool(act[0, b]):
                    doc.delete(int(p[0, b]), int(d[0, b]))
            _check(docs, self)

        def do_insert(self, k, act, p, il, st, w):
            super().do_insert(k, act, p, il, st, w)
            for b, doc in enumerate(docs):
                if bool(act[0, b]):
                    left, right = doc.insert(int(p[0, b]), int(il[0, b]),
                                             int(st[0, b]), int(w[0, b]))
                    assert (int(self.ol[k, b]), int(self.orr[k, b])) == (
                        left, right)
            _check(docs, self)

    monkeypatch.setattr(RL, "_PlainBlocked", Modelled)
    shape = dict(run.shape)
    if wmax is not None:
        shape["wmax"] = wmax
    ini = run.initial() if state is None else run.grow(state)
    return RL.lanes_blocked_replay_plain(*run.staged, *ini, **shape), docs


def _stack(streams, lmax=None, fuse_w=1):
    if lmax is None:
        lmax = max(len(p.ins_content) for ps in streams for p in ps)
    return TB.stack_ops([TB.compile_local_patches(
        ps, lmax=lmax, dmax=None, fuse_w=fuse_w)[0] for ps in streams])


def _divergent(seed, docs):
    rng = random.Random(seed)
    return _stack([randedit.random_patches(rng, 30 + rng.randint(0, 30))[0]
                   for _ in range(docs)])


def _bursts():
    opses = []
    for seed in (3, 4):
        ps, _ = randedit.prepend_bursts(np.random.default_rng(seed), 12)
        opses.append(TB.compile_local_patches(ps, lmax=16, fuse_w=5)[0])
    return TB.stack_ops(opses)


def _busy():
    busy = []
    for k in range(24):
        busy.append(TestPatch(0, 0, "ab"))
        if k % 2:
            busy.append(TestPatch(1, 1, ""))
    return _stack([[TestPatch(0, 0, "ab")], busy])


def _bad_delete():
    return _stack([[TestPatch(0, 0, "abc"), TestPatch(0, 10, "")],
                   [TestPatch(0, 0, "abcdefgh"), TestPatch(2, 3, "")]],
                  lmax=8)


# name -> (stacked streams, shape, WMAX override or None, expected flags)
CASES = {
    "divergent-k8": lambda: (_divergent(42, 6),
                             dict(capacity=256, block_k=8), None, [0, 0]),
    "divergent-k16": lambda: (_divergent(7, 6),
                              dict(capacity=256, block_k=16), None, [0, 0]),
    "bursts-w5-k16": lambda: (_bursts(), dict(capacity=256, block_k=16),
                              None, [0, 0]),
    "whole-roll-wmax-2": lambda: (_bursts(), dict(capacity=256, block_k=16),
                                  2, None),
    "capacity-overflow": lambda: (_busy(), dict(capacity=16, block_k=8),
                                  None, [1, 0]),
    "bad-delete": lambda: (_bad_delete(), dict(capacity=16, block_k=8), None,
                           [0, 1]),
    "wrap-16-rows": lambda: (_bursts(), dict(capacity=16, block_k=16), None,
                             [1, 1]),
    "random-k4096": lambda: (_divergent(9, 2),
                             dict(capacity=8192, block_k=4096), None,
                             [0, 0]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_inplace_model_matches_plain(monkeypatch, name):
    ops, shape, wmax, flags = CASES[name]()
    run = RL.make_replayer_lanes_blocked(ops, chunk=16, device="cpu",
                                         **shape)
    outs, docs = _replay(monkeypatch, run, wmax=wmax)
    if flags is not None:
        assert outs[-1][:2].amax(dim=1).tolist() == flags
    if name == "divergent-k8":
        assert sum(d.splits for d in docs) > 20
    if name == "whole-roll-wmax-2":
        assert sum(d.copies for d in docs) > 0


def test_inplace_model_matches_plain_on_a_config5_chain(monkeypatch):
    """Three chunks of config 5 at smoke size, the state carried and its
    capacity grown between launches; the deletes' passes skip rounds."""
    s5 = stream.make_stream_5(n_docs=4, chunks=3, steps_per_chunk=50,
                              seed_base=500)
    state, skipped = None, 0
    for run in stream.stream_replayers_5(s5, device="cpu"):
        outs, docs = _replay(monkeypatch, run, state)
        assert outs[-1][:2].amax().item() == 0
        state = outs[2:-1]
        skipped += sum(d.rounds_skipped for d in docs)
    assert skipped > 0


@pytest.mark.parametrize("corrupt", [False, True])
def test_inplace_model_matches_plain_from_odd_warm_states(monkeypatch,
                                                          corrupt):
    """A warm start with one stale row past ``rws`` in slot 0 of every
    document; with ``corrupt``, slot 0 of document 0 names a block outside
    [0, NB) (edited on a copy of block 0 that is never written back) and
    slot 0 of document 1 the fresh block its first split takes."""
    s5 = stream.make_stream_5(n_docs=3, chunks=2, steps_per_chunk=50,
                              seed_base=510)
    runs = stream.stream_replayers_5(s5, device="cpu")
    st = [t.clone() for t in RL.lanes_blocked_replay_plain(
        *runs[0].staged, *runs[0].initial(), **runs[0].shape)[2:-1]]
    st[4][0] = torch.where(st[4][0] >= 2, st[4][0] - 1, st[4][0])
    if corrupt:
        st[3][0, 0] = 999
        st[3][0, 1] = st[2][0, 1]
    outs, docs = _replay(monkeypatch, runs[1], tuple(st))
    if corrupt:
        assert sum(d.copies for d in docs) > 0


def test_wrapper_takes_k_past_2048_and_refuses_by_bytes(monkeypatch):
    """The wrapper takes K = 4,096 (the rows of a document on chip) and
    reaches the build; a document whose slot tables cannot fit a thread
    block's shared memory is refused before anything is built, naming the
    bytes. A7's wrapper likewise refuses a K whose block scratch cannot
    fit, naming the bytes."""
    from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as RLM

    class Reached(Exception):
        pass

    def reached(*args, **kw):
        raise Reached

    monkeypatch.setattr(RL._kernels, "function", reached)

    def z(*shape):
        return torch.zeros(*shape, dtype=torch.int32)

    def a5(cap, k):
        nbt = max(8, cap // k)
        return RL.lanes_blocked_replay_cuda(
            *[z(4, 1)] * 5, z(cap, 1), z(cap, 1), z(1, 1),
            *[z(nbt, 1)] * 3, block_k=k, wmax=1)

    assert RL.blocked_on_chip(8192, 8)
    with pytest.raises(Reached):
        a5(8192, 4096)
    with pytest.raises(ValueError, match=r"need \d+ B of shared memory"):
        a5(64 * 16384, 64)
    cap = k = 65536
    with pytest.raises(ValueError, match=r"need \d+ B of shared memory"):
        RLM.lanes_mixed_blocked_replay_cuda(
            *[z(4, 1)] * 10, z(cap, 1), z(cap, 1), z(1, 1),
            *[z(8, 1)] * 4, *[z(8, 1)] * 3, z(8, 1), *[z(8, 1)] * 3,
            block_k=k, wmax=1)
