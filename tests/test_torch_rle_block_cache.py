"""A plain-Python model of the redesigned run-block replay kernel
(``ops/csrc/rle_replay.cu``, A1) held equal to ``rle_replay_plain`` after
every op of seeded streams.

The kernel computes what the plain version computes; it changes where
the state lives and how a step finds its rows:

- the edited block is cached as a ring in shared memory across steps
  (logical row k at physical row (k + rot) mod K, every row at or past
  hw empty) and written back to the lane's working planes only when a
  step edits another block (recording that block's first row in a heads
  table, which answers an insert's successor peek), before a split moves
  its top half, and at the end;
- a slot is found by one pass over the inclusive live-prefix table,
  which each insert and delete updates from its slot to ``nlog``, and a
  split shifts the four slot tables over [l + 2, nlog] only (every entry
  past ``nlog`` is 0);
- only block 0 of the working planes is zeroed at the start, a split
  writes all K rows of its fresh block, and the public planes are the
  working planes transposed, 0 past the blocks in use.

The model follows those rules on Python lists; a subclass of the plain
version's group replays each op on it and compares the rows of every
block in use (the window for the cached one, the working planes for the
others), the slot tables and prefixes, the heads table, the origins and
the error rows after every op, and the transposed write-out against the plain planes at the end. Inputs: north-star
prefixes (fused W-row typing), random edit streams at K = 8 (many
splits), a capacity overflow (err row 0), a delete past the end (err row
1) and K = 2,048. Tolerance: none, the state is integers.
"""
import numpy as np
import pytest

from text_crdt_rust_tpu_torch import northstar
from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch.ops import rle as TR
from text_crdt_rust_tpu_torch.ops.blocked import _roll_amount
from text_crdt_rust_tpu_torch.utils import randedit
from text_crdt_rust_tpu_torch.utils.testdata import TestPatch

ROOT = 0xFFFFFFFF


class Model:
    """One lane of the kernel's state (every lane replays the same
    stream)."""

    def __init__(self, K, NB, NBL, CAP, WMAX):
        self.K, self.NB, self.NBL, self.CAP, self.WMAX = K, NB, NBL, CAP, WMAX
        # Working planes: None marks a row never written (block 0 is
        # zeroed at the start).
        self.O = [0] * K + [None] * (CAP - K)
        self.L = [0] * K + [None] * (CAP - K)
        self.wo, self.wl = [0] * K, [0] * K
        self.rot = self.hw = self.hwmax = self.cached = 0
        self.blkord, self.rws, self.liv, self.cum, self.hd = (
            [0] * NBL for _ in range(5))
        self.nlog = 1
        self.err0 = self.err1 = 0
        self.loads = self.splits = 0

    # -- the window ring ---------------------------------------------------

    def ph(self, k):
        return (k + self.rot) % self.K

    def row(self, k):
        if 0 <= k < self.K:
            return self.wo[self.ph(k)], self.wl[self.ph(k)]
        return 0, 0

    def put(self, k, o, ln):
        if 0 <= k < self.K:
            self.wo[self.ph(k)], self.wl[self.ph(k)] = o, ln

    def cover(self, k):
        self.hw = max(self.hw, min(k, self.K))
        self.hwmax = max(self.hwmax, self.hw)

    def logical(self):
        rows = [self.row(k) for k in range(self.K)]
        return [r[0] for r in rows], [r[1] for r in rows]

    def shift_up(self, q, a):
        K = self.K
        if a <= 0 or q >= K:
            return
        top = min(self.hw, K - a)
        if top - q <= q:
            for s in range(top - 1, q - 1, -1):
                self.put(s + a, *self.row(s))
        else:
            self.rot = (self.rot - a) % K
            for d in range(q):
                self.put(d, *self.row(d + a))
        self.hw = min(K, max(self.hw, q) + a)
        self.hwmax = max(self.hwmax, self.hw)

    def ensure(self, b):
        if b == self.cached:
            return
        K, old = self.K, self.cached
        o, ln = self.logical()
        for r in range(self.hwmax):
            self.O[old * K + r], self.L[old * K + r] = o[r], ln[r]
        self.hd[old] = o[0]
        new_o = self.O[b * K:(b + 1) * K]
        new_l = self.L[b * K:(b + 1) * K]
        assert None not in new_o and None not in new_l, "unwritten rows read"
        self.wo, self.wl, self.rot = list(new_o), list(new_l), 0
        nz = [k for k in range(K) if new_o[k] or new_l[k]]
        self.hw = self.hwmax = nz[-1] + 1 if nz else 0
        self.cached = b
        self.loads += 1

    # -- the slot tables -----------------------------------------------------

    def slot(self, rank1):
        cnt = sum(1 for j in range(self.nlog) if self.cum[j] < rank1)
        l = min(cnt, self.nlog - 1)
        return l, self.cum[l] - self.liv[l]

    def add_from(self, l, v):
        for j in range(l, self.nlog):
            self.cum[j] += v

    def split(self, l):
        if self.nlog >= self.NB:
            self.err0 = 1
            return
        K = self.K
        self.ensure(self.blkord[l])
        r = self.rws[l]
        keep, nb, nl = r // 2, self.nlog, self.nlog
        mv = r - keep
        up = _roll_amount(keep, K, K)
        o, ln = self.logical()
        liv_hi = sum(ln[k] for k in range(keep, min(r, K)) if o[k] > 0)
        for k in range(K):
            s = (k + up) % K
            self.O[nb * K + k] = o[s] if k < mv else 0
            self.L[nb * K + k] = ln[s] if k < mv else 0
        self.hd[nb] = self.O[nb * K]
        for k in range(keep, self.hw):
            self.put(k, 0, 0)
        for tab in (self.blkord, self.rws, self.liv, self.cum):
            for j in range(nl, l + 1, -1):
                tab[j] = tab[j - 1]
        c = self.cum[l]
        self.rws[l], self.liv[l], self.cum[l] = keep, self.liv[l] - liv_hi, \
            c - liv_hi
        self.blkord[l + 1], self.rws[l + 1], self.liv[l + 1], \
            self.cum[l + 1] = nb, mv, liv_hi, c
        self.nlog += 1
        self.hw = min(self.hw, r // 2)
        self.splits += 1

    # -- the ops ---------------------------------------------------------------

    def live_rows_before(self, n):
        o, ln = self.logical()
        return sum(ln[k] for k in range(min(n, self.hw)) if o[k] > 0)

    def locate_run(self, r0, local):
        o, ln = self.logical()
        lv = [ln[k] if o[k] > 0 else 0 for k in range(self.K)]
        run, c, at_c = 0, -1, 0
        for k in range(self.hw):
            if run + lv[k] >= local:
                c, at_c = k, run
                break
            run += lv[k]
        if c < 0:
            c, at_c = (self.hw if run >= local else self.K), run
        i_r = min(c, r0)
        if i_r >= self.K:
            return i_r, 0
        return i_r, at_c if i_r == c else self.live_rows_before(i_r)

    def insert(self, p, il, st, w):
        K = self.K
        before = 0
        l, before = (0, 0) if p == 0 else self.slot(p)
        r0 = self.rws[l]
        if r0 + w + 1 > K:
            self.split(l)
            l, before = (0, 0) if p == 0 else self.slot(p)
            r0 = self.rws[l]
        self.ensure(self.blkord[l])
        i_r = o_r = l_r = off = 0
        is_split = False
        if p > 0:
            local = p - before
            i_r, excl = self.locate_run(r0, local)
            o_r, l_r = self.row(i_r)
            off = local - excl
            is_split = off < l_r
        need_peek = p > 0 and not is_split and i_r + 1 >= r0 \
            and l + 1 < self.nlog
        succ_next = self.hd[self.blkord[min(l + 1, self.NBL - 1)]] \
            if need_peek else 0
        if p == 0:
            succ = self.row(0)[0] if r0 > 0 else 0
        elif is_split:
            succ = o_r + off
        else:
            succ = self.row(i_r + 1)[0] if i_r + 1 < r0 else succ_next
        left = ROOT if p == 0 else ((o_r - 1) + (off - 1)) & ROOT
        right = ROOT if succ == 0 else (abs(succ) - 1) & ROOT
        lrun = il // max(w, 1)
        mrg = w == 1 and p > 0 and off == l_r and st + 1 == o_r + l_r
        ins_at = 0 if p == 0 else i_r + 1
        amt = 0 if mrg else w + int(is_split)
        self.shift_up(ins_at, _roll_amount(amt, self.WMAX + 1, K))
        if not mrg:
            for j in range(w):
                self.put(ins_at + j, st + il - (j + 1) * lrun + 1, lrun)
        if is_split:
            self.put(i_r, o_r, off)
            self.put(ins_at + w, o_r + off, l_r - off)
        if mrg:
            self.put(i_r, o_r, l_r + il)
        self.rws[l] += amt
        self.liv[l] += il
        self.add_from(l, il)
        self.cover(ins_at + amt)
        if is_split or mrg:
            self.cover(i_r + 1)
        return left, right

    def apply_partial(self, i_p, cs_i, ce_i):
        o, ln = self.row(i_p)
        cov = ce_i - cs_i
        has_head, has_tail = cs_i > 0, ce_i < ln
        amt = int(has_head) + int(has_tail)
        self.shift_up(i_p + 1, _roll_amount(amt, 2, self.K))
        self.put(i_p, o if has_head else -(o + cs_i), cs_i if has_head else cov)
        if amt >= 1:
            self.put(i_p + 1, -(o + cs_i) if has_head else o + ce_i,
                     cov if has_head else ln - ce_i)
        if amt == 2:
            self.put(i_p + 2, o + ce_i, ln - ce_i)
        self.cover(i_p + 1 + amt)
        return amt

    def delete(self, p, d):
        K = self.K
        rem = d
        iters = 0
        while rem > 0 and iters <= 2 * self.NBL:
            l, base = self.slot(p + 1)
            if self.rws[l] + 2 > K:
                self.split(l)
                l, base = self.slot(p + 1)
            self.ensure(self.blkord[l])
            o, ln = self.logical()
            run = tot = 0
            part = []
            for k in range(self.hw):
                lv = ln[k] if o[k] > 0 else 0
                before = base + run
                cs = min(max(p - before, 0), lv)
                ce = min(max(p + rem - before, 0), lv)
                cov = ce - cs
                tot += cov
                if cov > 0 and cov == ln[k]:
                    self.put(k, -o[k], ln[k])
                elif cov > 0:
                    part.append((k, cs, ce))
                run += lv
            added = 0
            if part:
                added += self.apply_partial(*part[-1])
            if len(part) == 2:
                added += self.apply_partial(*part[0])
            self.rws[l] += added
            self.liv[l] -= tot
            self.add_from(l, -tot)
            rem -= tot
            iters += 1
        if rem > 0:
            self.err1 = 1

    def write_out(self):
        """The kernel's final flush and the transposed public planes."""
        K = self.K
        o, ln = self.logical()
        for r in range(self.hwmax):
            self.O[self.cached * K + r] = o[r]
            self.L[self.cached * K + r] = ln[r]
        used = self.nlog * K
        return ([self.O[r] if r < used else 0 for r in range(self.CAP)],
                [self.L[r] if r < used else 0 for r in range(self.CAP)])


def _lane0(t):
    return [int(v) for v in t[:, 0]]


def _check(model, grp):
    """The model's state against the plain group's (lane 0)."""
    K, nl = model.K, model.nlog
    assert nl == grp.nlog
    ordp, lenp = _lane0(grp.ordp), _lane0(grp.lenp)
    for tab, name in ((model.blkord, "blkord"), (model.rws, "rws"),
                      (model.liv, "liv")):
        assert tab == _lane0(getattr(grp, name)), name
    assert model.cum[:nl] == _lane0(grp.cumliv)[:nl]
    wo, wl = model.logical()
    for l in range(nl):
        b = model.blkord[l]
        if b == model.cached:
            got = (wo, wl)
            assert all(v == 0 for v in wo[model.hw:] + wl[model.hw:])
        else:
            got = (model.O[b * K:(b + 1) * K], model.L[b * K:(b + 1) * K])
            assert model.hd[b] == ordp[b * K]
        assert got == (ordp[b * K:(b + 1) * K], lenp[b * K:(b + 1) * K]), \
            f"block {b} of slot {l}"


def _replay_with_model(monkeypatch, streams, **shape):
    """Replays ``streams`` with the plain version while the model follows
    every op of every group; returns the outputs and the models."""
    models = []

    class ModelGroup(TR._PlainGroup):
        def __init__(self, *args):
            super().__init__(*args)
            self.model = Model(self.K, self.NB, self.NBL, self.ordp.shape[0],
                               self.WMAX)
            models.append(self.model)

        def do_insert(self, k, p, il, st, w):
            super().do_insert(k, p, il, st, w)
            left, right = self.model.insert(p, il, st, w)
            assert (int(self.ol[k, 0]) & ROOT, int(self.orr[k, 0]) & ROOT) \
                == (left, right)
            _check(self.model, self)
            assert self.model.err0 == int(self.err[0, 0])

        def do_delete(self, p, d):
            super().do_delete(p, d)
            self.model.delete(p, d)
            _check(self.model, self)
            assert (self.model.err0, self.model.err1) == (
                int(self.err[0, 0]), int(self.err[1, 0]))

    monkeypatch.setattr(TR, "_PlainGroup", ModelGroup)
    rep = TR.make_replayer_rle(streams, device="cpu", chunk=16, **shape)
    outs = TR.rle_replay_plain(*rep.staged, **rep.shape)
    ordp, lenp = outs[2], outs[3]
    cap = shape["capacity"]
    for g, m in enumerate(models):
        o, ln = m.write_out()
        assert o == _lane0(ordp[g * cap:(g + 1) * cap])
        assert ln == _lane0(lenp[g * cap:(g + 1) * cap])
    return outs, models


def _compile(patches, fuse_w=1):
    merged = TB.merge_patches(patches)
    lmax = max([len(p.ins_content) for p in merged] + [1])
    ops, _ = TB.compile_local_patches(merged, lmax=lmax, fuse_w=fuse_w)
    if fuse_w > 1:
        ops, _ = TB.fuse_steps(ops, fuse_w=fuse_w)
    return ops


def _random(seed, steps):
    return _compile(randedit.random_patches(np.random.default_rng(seed),
                                            steps)[0])


CASES = {
    # The north star's typing, fused at W = 8, at its K.
    "northstar-prefix-k128": lambda: (
        [northstar.compile_northstar(patches=6000).ops],
        dict(capacity=1024, block_k=128)),
    "northstar-prefix-k16": lambda: (
        [northstar.compile_northstar(patches=1500).ops],
        dict(capacity=512, block_k=16)),
    "random-k8-groups": lambda: ([_random(11, 200), _random(12, 120)],
                                 dict(capacity=512, block_k=8)),
    "capacity-overflow": lambda: (
        [_compile([TestPatch(0, 0, "ab")] * 40)], dict(capacity=16, block_k=8)),
    "bad-delete": lambda: (
        [_compile([TestPatch(0, 0, "abc"), TestPatch(0, 10, "")])],
        dict(capacity=32, block_k=8)),
    "random-k2048": lambda: ([_random(13, 300)],
                             dict(capacity=4096, block_k=2048)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_cache_model_matches_plain(monkeypatch, name):
    streams, shape = CASES[name]()
    outs, models = _replay_with_model(monkeypatch, streams, batch=1, **shape)
    err = outs[7][:2, 0].tolist()
    if name == "capacity-overflow":
        assert err[0] == 1
    elif name == "bad-delete":
        assert err[1] == 1
    else:
        assert err == [0, 0]
    if name == "northstar-prefix-k128":
        # The cache is exercised: most steps edit the block cached by the
        # step before.
        m = models[0]
        assert m.loads < int(streams[0].num_steps) // 4
    if name.startswith("random-k8"):
        assert sum(m.splits for m in models) > 10
