"""A plain-Python model of the CUDA kernel's window ring
(``ops/csrc/rle_hbm_replay.cu``) held equal to the circular-roll splices
of ``rle_hbm_replay_plain`` on every step of seeded streams.

The kernel keeps its cached block as a ring (logical row k at physical
row (k + rot) mod K) and a bound hw on the non-empty rows. A splice that
inserts ``a`` rows at row q moves the shorter side: rows [q, hw) up by
``a``, or, turning the ring back by ``a``, rows [0, q) down; then it
writes its new rows. A delete's boundary split is the same move at
q = i_p + 1. A split keeps rows [0, keep) and copies the top half out
un-rotated; a window load starts at rotation 0.

Each test replays a stream with the plain version, its group state and
its splice functions wrapped so that the ring model makes the same step
and is compared after it: the model's logical rows against the plain
window (lane 0; every lane replays the same stream), every row at or past
hw empty, the fresh block of a split against the model's un-rotated top
half, and the window written back at an eviction and at the end. The
plain version itself is unchanged and its outputs are returned as they
are. Tolerance: none, the state is integers.
"""
import numpy as np
import pytest

from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch.ops import rle_hbm as TH
from text_crdt_rust_tpu_torch.ops.blocked import _roll_amount
from text_crdt_rust_tpu_torch.utils import randedit
from text_crdt_rust_tpu_torch.utils.testdata import TestPatch


class Ring:
    """The kernel's window: K physical rows, a rotation and hw."""

    def __init__(self, K):
        self.K = K
        self.o = [0] * K
        self.l = [0] * K
        self.rot = 0
        self.hw = 0
        self.moved = 0  # rows moved by shifts, both planes counted once

    def ph(self, k):
        return (k + self.rot) % self.K

    def get(self, k):
        if 0 <= k < self.K:
            return self.o[self.ph(k)], self.l[self.ph(k)]
        return 0, 0

    def put(self, k, o, l):
        if 0 <= k < self.K:
            self.o[self.ph(k)] = o
            self.l[self.ph(k)] = l

    def cover(self, k):
        self.hw = max(self.hw, min(k, self.K))

    def logical(self):
        return ([self.get(k)[0] for k in range(self.K)],
                [self.get(k)[1] for k in range(self.K)])

    def load(self, o, l):
        self.o, self.l, self.rot = list(o), list(l), 0
        nz = [k for k in range(self.K) if o[k] or l[k]]
        self.hw = nz[-1] + 1 if nz else 0

    def shift_up(self, q, a):
        """Rows >= q + a take row k - a, the top a drop off; rows
        [q, q + a) are the caller's to write. The shorter side moves."""
        K = self.K
        if a <= 0 or q >= K:
            return
        top = min(self.hw, K - a)
        if top - q <= q:
            for s in range(top - 1, q - 1, -1):
                self.put(s + a, *self.get(s))
            self.moved += max(top - q, 0)
        else:
            self.rot = (self.rot - a) % K
            for d in range(q):
                self.put(d, *self.get(d + a))
            self.moved += q
        self.hw = min(K, max(self.hw, q) + a)

    def check_hw(self):
        o, l = self.logical()
        assert all(o[k] == 0 and l[k] == 0 for k in range(self.hw, self.K))


def _lane0(t):
    return [int(v) for v in t[:, 0]]


def ring_insert(ring, p, i_r, o_r, l_r, off, il, st, w, wmax):
    """The kernel's fused W-row splice on the ring."""
    K = ring.K
    lrun = il // max(w, 1)
    mrg = w == 1 and p > 0 and off == l_r and st + 1 == o_r + l_r
    is_split = p > 0 and off < l_r
    ins_at = 0 if p == 0 else i_r + 1
    amt = 0 if mrg else w + int(is_split)
    ring.shift_up(ins_at, _roll_amount(amt, wmax + 1, K))
    if not mrg:
        for j in range(w):
            ring.put(ins_at + j, st + il - (j + 1) * lrun + 1, lrun)
    if is_split:
        ring.put(i_r, o_r, off)
        ring.put(ins_at + w, o_r + off, l_r - off)
    if mrg:
        ring.put(i_r, o_r, l_r + il)
    ring.cover(ins_at + amt)
    if is_split or mrg:
        ring.cover(i_r + 1)


def ring_delete(ring, base, p, rem):
    """One delete iteration on the ring: flips, then the boundary splits
    (the higher first). Returns (rows added, chars covered)."""
    K = ring.K
    o, l = ring.logical()
    run, tot, part, cs_ce = 0, 0, [], {}
    for k in range(K):
        lv = l[k] if o[k] > 0 else 0
        before = base + run
        run += lv
        cs = min(max(p - before, 0), lv)
        ce = min(max(p + rem - before, 0), lv)
        cov = ce - cs
        tot += cov
        if cov > 0 and cov == l[k]:
            ring.put(k, -o[k], l[k])
        elif cov > 0:
            part.append(k)
            cs_ce[k] = (cs, ce)
    added = 0
    for active, i_p in ((len(part) >= 1, part[-1] if part else -1),
                        (len(part) == 2, part[0] if part else -1)):
        if not active:
            continue
        ob, ln = ring.get(i_p)
        cs, ce = cs_ce[i_p]
        cov = ce - cs
        has_head, has_tail = cs > 0, ce < ln
        amt = int(has_head) + int(has_tail)
        ring.shift_up(i_p + 1, _roll_amount(amt, 2, K))
        ring.put(i_p, ob if has_head else -(ob + cs), cs if has_head else cov)
        if amt >= 1:
            ring.put(i_p + 1, -(ob + cs) if has_head else ob + ce,
                     cov if has_head else ln - ce)
        if amt == 2:
            ring.put(i_p + 2, ob + ce, ln - ce)
        ring.cover(i_p + 1 + amt)
        added += amt
    return added, tot


def _replay_with_ring(monkeypatch, streams, capacity, block_k):
    """Replays ``streams`` with the plain version while the ring model
    follows every step of every group. Returns the outputs and the
    counts summed over the groups: steps checked, rows moved, splits and
    delete iterations that added two rows."""
    counts = dict(steps=0, moved=0, splits=0, two_rows=0)
    current = {}
    orig_insert, orig_delete = TH._insert_splice, TH._delete_block_math

    def insert_splice(bo, bl, idx_k, p, i_r, o_r, l_r, off, il, st, w=1,
                      wmax=1):
        out = orig_insert(bo, bl, idx_k, p, i_r, o_r, l_r, off, il, st, w,
                          wmax)
        ring = current["ring"]
        assert ring.logical() == (_lane0(bo), _lane0(bl))
        ring_insert(ring, p, i_r, o_r, l_r, off, il, st, w, wmax)
        assert ring.logical() == (_lane0(out[0]), _lane0(out[1]))
        ring.check_hw()
        counts["steps"] += 1
        return out

    def delete_block_math(bo, bl, idx_k, K, base, p, rem):
        out = orig_delete(bo, bl, idx_k, K, base, p, rem)
        ring = current["ring"]
        assert ring.logical() == (_lane0(bo), _lane0(bl))
        added, tot = ring_delete(ring, base, p, rem)
        assert (added, tot) == (out[2], out[3])
        counts["two_rows"] += added == 2
        assert ring.logical() == (_lane0(out[0]), _lane0(out[1]))
        ring.check_hw()
        counts["steps"] += 1
        return out

    class RingGroup(TH._HbmGroup):
        def __init__(self, *args):
            super().__init__(*args)
            self.ring = Ring(self.K)
            current["ring"] = self.ring

        def ensure(self, b):
            if self.cached != b:
                # The write-back is the ring un-rotated.
                assert self.ring.logical() == (_lane0(self.wo),
                                               _lane0(self.wl))
            super().ensure(b)
            if self.ring.logical() != (_lane0(self.wo), _lane0(self.wl)):
                self.ring.load(_lane0(self.wo), _lane0(self.wl))
                assert self.ring.rot == 0

        def split(self, l):
            nlog0, K = self.nlog, self.K
            r = self.slot_scalar(self.rws, l)
            super().split(l)
            if self.nlog == nlog0:  # table full: err row 0, no split
                return
            ring, keep = self.ring, r // 2
            up = _roll_amount(keep, K, K)
            fresh = [ring.get((k + up) % K) if k < r - keep else (0, 0)
                     for k in range(K)]
            rows = slice(nlog0 * K, (nlog0 + 1) * K)
            assert [x[0] for x in fresh] == _lane0(self.ordp[rows])
            assert [x[1] for x in fresh] == _lane0(self.lenp[rows])
            for k in range(keep, K):
                ring.put(k, 0, 0)
            ring.hw = min(ring.hw, keep)
            assert ring.logical() == (_lane0(self.wo), _lane0(self.wl))
            counts["splits"] += 1

        def flush(self):
            assert self.ring.logical() == (_lane0(self.wo), _lane0(self.wl))
            counts["moved"] += self.ring.moved
            super().flush()

    monkeypatch.setattr(TH, "_insert_splice", insert_splice)
    monkeypatch.setattr(TH, "_delete_block_math", delete_block_math)
    monkeypatch.setattr(TH, "_HbmGroup", RingGroup)
    rep = TH.make_replayer_rle_hbm(streams, capacity=capacity, batch=2,
                                   block_k=block_k, chunk=64, device="cpu")
    outs = TH.rle_hbm_replay_plain(*rep.staged, **rep.shape)
    return outs, counts


def _prepends(n, w):
    return TB.compile_local_patches([TestPatch(0, 0, " ")] * n, lmax=w,
                                    fuse_w=w)[0]


def _random(seed, steps):
    patches = randedit.random_patches(np.random.default_rng(seed), steps)[0]
    return TB.compile_local_patches(TB.merge_patches(patches), lmax=8)[0]


def _both_ends():
    """Long runs, then deletes inside them that split both ends."""
    ps = [TestPatch(0, 0, "abcdefghijklmnop"), TestPatch(16, 0, "qrstuvwx")]
    ps += [TestPatch(3, 4, ""), TestPatch(10, 2, ""), TestPatch(1, 1, "")]
    ps += [TestPatch(5, 0, "yz"), TestPatch(2, 6, "")]
    return TB.compile_local_patches(ps, lmax=8)[0]


# name -> (streams, capacity, block_k, expected err row 0)
RING_CASES = {
    "kevin-bursts-w64-k512": lambda: ([_prepends(6000, 64)], 512 * 32, 512,
                                      0),
    "mid-block-both-sides-k64": lambda: ([_random(21, 600)], 64 * 64, 64, 0),
    "random-groups-k16": lambda: ([_random(4, 300), _random(5, 300)],
                                  16 * 64, 16, 0),
    "deletes-split-both-ends-k8": lambda: ([_both_ends()], 8 * 16, 8, 0),
    "full-table-wrap-w3-k8": lambda: ([_prepends(300, 3)], 16, 8, 1),
}


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_window_equals_roll_splice(monkeypatch, name):
    streams, cap, k, err0 = RING_CASES[name]()
    outs, counts = _replay_with_ring(monkeypatch, streams, cap, k)
    active = sum(int(((s.ins_len > 0) | (s.del_len > 0)).sum())
                 for s in streams)
    assert counts["steps"] >= active > 0
    assert int(outs[7][0].max()) == err0
    if name.startswith("kevin"):
        # Prepends land at row 0: the ring turns and no row moves.
        assert counts["moved"] == 0 and counts["splits"] > 0
    if name.startswith("mid-block"):
        assert counts["moved"] > 0 and counts["splits"] > 0
    if name.startswith("deletes"):
        assert counts["two_rows"] > 0
