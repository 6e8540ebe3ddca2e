"""Plain-Python models of the redesigned un-blocked per-lane kernels
(``ops/csrc/lanes_column.cuh`` under ``rle_lanes.cu`` and
``rle_lanes_mixed.cu``) held equal to the plain versions
``lanes_replay_plain`` and ``lanes_mixed_replay_plain`` after every op of
seeded streams.

The kernels keep one document's column on chip and change how its rows
are visited, not what an op computes:

- every pass runs over [0, hi), the extent past which every row is 0,
  found from the input and grown with each splice;
- a locate sums 32 contiguous chunks of rows (an odd number of rows
  each), finds the chunk whose prefix crosses p and walks that chunk;
- a splice shifts only the rows between the edit and the extent, top
  down, in place, 128 rows a round (each round reads before it writes);
- the YATA walk moves forward from one probe's row to the next, starting
  at the left origin's row, and finds each origin-left row by a search
  that stops at the first hit.

The models below follow those rules on Python lists; a subclass of each
plain version's state class replays the same op on them and compares
everything (rows, extent invariant, planes, rows in use, error rows,
origins, by-order tables) after every op. Inputs: config-5-like local
streams (with fused W-row inserts) and 5r-like remote streams from the
case builders of ``test_torch_rle_lanes_mixed.py``, columns with nonzero
rows past ``rows``, a capacity overflow that wraps, a delete past the end,
an unknown order, a stuck walk and the remote delete that would overflow.
Tolerance: none, the state is integers.
"""
import numpy as np
import pytest
import torch

from test_torch_rle_lanes_mixed import CASES as A6_CASES
from test_torch_rle_lanes_mixed import _fused_bursts, to_port
from text_crdt_rust_tpu_torch import stream
from text_crdt_rust_tpu_torch.ops import batch as B
from text_crdt_rust_tpu_torch.ops import rle_lanes as TL
from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as TM
from text_crdt_rust_tpu_torch.utils import randedit
from text_crdt_rust_tpu_torch.utils.testdata import TestPatch

LANES = 32
ROOT, UNKNOWN = -1, -2


def _split_pieces(o, ln, cs, ce):
    """``lanes::split_pieces``: (amt, [(o, l) of rows i, i+1, i+2])."""
    head, tail, cov = cs > 0, ce < ln, ce - cs
    amt = int(head) + int(tail)
    p0 = (o, cs) if head else (-(o + cs), cov)
    p1 = (-(o + cs), cov) if head else (o + ce, ln - ce)
    return amt, [p0, p1, (o + ce, ln - ce)]


def _roll_amount(amount, max_amount, n):
    bits = max(max_amount, 1).bit_length()
    return (amount & ((1 << bits) - 1)) % n


class Column:
    """One document's column under the kernels' rules."""

    def __init__(self, o, l, rows, wmax, tables=None):
        self.O = [int(x) for x in o]
        self.L = [int(x) for x in l]
        self.CAP, self.WMAX, self.rows = len(self.O), wmax, int(rows)
        self.err = [0, 0, 0]
        nz = [i for i in range(self.CAP) if self.O[i] or self.L[i]]
        self.hi = nz[-1] + 1 if nz else 0
        # oll, orl, rkl as lists (the mixed kernel), else None
        self.tables = tables
        self.probes = []
        self.stuck = 0

    # -- rows -----------------------------------------------------------------

    def row(self, plane, r):
        """``row_or0``: row r, 0 outside [0, CAP)."""
        return plane[r] if 0 <= r < self.CAP else 0

    def val(self, i, live):
        return (self.L[i] if self.O[i] > 0 else 0) if live else self.L[i]

    def chunks(self):
        hi = self.hi
        cr = ((hi + 31) >> 5) | 1
        return [(min(k * cr, hi), min(min(k * cr, hi) + cr, hi))
                for k in range(LANES)]

    def extent_ok(self):
        return all(self.O[i] == 0 and self.L[i] == 0
                   for i in range(self.hi, self.CAP))

    # -- lanes_column.cuh -----------------------------------------------------

    def locate(self, p, live, strict):
        """(i_r, prefix at i_r, value at i_r)."""
        def cross(x):
            return x >= p if strict else x > p

        ch = self.chunks()
        sums = [sum(self.val(i, live) for i in range(a, b)) for a, b in ch]
        incl = list(np.cumsum(sums)) if sums else []
        total = int(incl[-1]) if incl else 0
        owners = [k for k in range(LANES)
                  if ch[k][0] < ch[k][1] and cross(int(incl[k]))]
        if owners:
            own = owners[0]
            run = int(incl[own]) - sums[own]
            k = None
            for i in range(*ch[own]):
                run += self.val(i, live)
                if cross(run):
                    k, cum_k, v_k = i, run, self.val(i, live)
                    break
            assert k is not None
        else:
            k = self.hi if cross(total) else self.CAP
            cum_k, v_k = (total if k < self.CAP else 0), 0
        rows_c = min(max(self.rows, 0), self.CAP)
        if k <= rows_c:
            return k, cum_k, v_k
        if rows_c >= self.hi:
            return rows_c, (total if rows_c < self.CAP else 0), 0
        return (rows_c, sum(self.val(i, live) for i in range(rows_c + 1)),
                self.val(rows_c, live))

    def shift_down(self, q, a, r):
        d0, d1 = q + a, min(self.CAP, self.hi + r)
        if r > 0:
            top = d1
            while top > d0:
                js = [j for j in range(top - 1, top - 129, -1) if j >= d0]
                got = [(self.O[j - r], self.L[j - r]) for j in js]
                for j, (o, ln) in zip(js, got):
                    self.O[j], self.L[j] = o, ln
                top -= 128
        self.hi = min(self.CAP, max(self.hi + r, d0))

    def apply_partial(self, i, cs, ce):
        amt, pieces = _split_pieces(self.row(self.O, i), self.row(self.L, i),
                                    cs, ce)
        self.shift_down(i + 1, amt, amt)
        for j, (o, ln) in enumerate(pieces[:amt + 1]):
            if i + j < self.CAP:
                self.O[i + j], self.L[i + j] = o, ln
        return amt

    def apply_parts(self, parts):
        """The TPU kernel's splits: the highest partial row, then the
        lowest when there are exactly two."""
        a = 0
        if len(parts) >= 1:
            a += self.apply_partial(*parts[-1])
        if len(parts) == 2:
            a += self.apply_partial(*parts[0])
        return a

    def local_delete(self, p, d):
        if self.rows + 2 > self.CAP:
            self.err[0] = 1
        tot, parts = 0, []
        # each lane's live prefix before its chunk, from one pass over the
        # rows before any flip
        ch = self.chunks()
        starts = [sum(self.val(i, True) for i in range(a)) for a, _ in ch]
        for (a, b), before in zip(ch, starts):
            for i in range(a, b):
                bo, bl = self.O[i], self.L[i]
                lv = bl if bo > 0 else 0
                cs = min(max(p - before, 0), lv)
                ce = min(max(p + d - before, 0), lv)
                cov = ce - cs
                tot += cov
                full = cov > 0 and cov == bl
                if cov > 0 and not full:
                    parts.append((i, cs, ce))
                if full:
                    self.O[i] = -bo
                before += lv
        if tot < d:
            self.err[1] = 1
        self.rows += self.apply_parts(parts)

    def local_insert(self, p, il, st, w):
        """Returns (left, right, lrun)."""
        CAP, rows = self.CAP, self.rows
        if rows + w + 1 > CAP:
            self.err[0] = 1
        i_r, cum, v = self.locate(p, True, True)
        o_r, l_r = self.row(self.O, i_r), self.row(self.L, i_r)
        off = p - (cum - v)
        left = ROOT if p == 0 else (o_r - 1) + (off - 1)
        lrun = il // max(w, 1)
        mrg = w == 1 and p > 0 and off == l_r and st + 1 == o_r + l_r
        is_split = p > 0 and off < l_r
        ins_at = 0 if p == 0 else i_r + 1
        amt = 0 if mrg else w + int(is_split)
        nxt, first_o = self.row(self.O, i_r + 1), self.O[0]
        self.shift_down(ins_at, amt, _roll_amount(amt, self.WMAX + 1, CAP))
        if not mrg:
            for j in range(ins_at, min(ins_at + w, CAP)):
                self.O[j] = st + il - (j - ins_at + 1) * lrun + 1
                self.L[j] = lrun
        if i_r < CAP and is_split:
            self.L[i_r] = off
        if i_r < CAP and mrg:
            self.L[i_r] = l_r + il
        if is_split and ins_at + w < CAP:
            self.O[ins_at + w], self.L[ins_at + w] = o_r + off, l_r - off
        if (is_split or mrg) and i_r < CAP:
            self.hi = max(self.hi, i_r + 1)
        succ_p0 = first_o if rows > 0 else 0
        succ_after = nxt if i_r + 1 < rows else 0
        succ = succ_p0 if p == 0 else (o_r + off if is_split else succ_after)
        right = ROOT if succ == 0 else abs(succ) - 1
        self.rows = rows + amt
        if self.tables is not None:
            oll, orl, _ = self.tables
            ls = max(lrun, 1)
            for q in range(il):
                o = st + q
                if 0 <= o < len(oll):
                    if q % ls == 0:
                        oll[o] = left
                    orl[o] = right if q < ls else st + (q // ls - 1) * ls
        return left, right, lrun

    # -- rle_lanes_mixed.cu ---------------------------------------------------

    def t_read(self, which, o):
        tab = self.tables[which]
        return tab[min(max(o, 0), len(tab) - 1)]

    def cursor_after(self, o):
        """(cursor, row, raw length before the row)."""
        if o == UNKNOWN:
            self.err[2] = 1
        if o == ROOT:
            return 0, 0, 0
        oo, pre = max(o, 0), 0
        for i in range(self.hi):
            bo, bl = self.O[i], self.L[i]
            so = abs(bo) - 1
            if bo != 0 and so <= oo < so + bl:
                row = i
                break
            pre += bl
        else:
            self.err[2] = 1
            row, pre = 0, 0
        return pre + (oo - (abs(self.row(self.O, row)) - 1)) + 1, row, pre

    def integrate(self, my_rank, o_left, o_right):
        CAP, rows_c = self.CAP, min(max(self.rows, 0), self.CAP)
        n = sum(self.L[:self.hi])
        cursor, k, pre = self.cursor_after(o_left)
        left_cursor, scanning, scan_start = cursor, False, cursor
        probes = 0
        while cursor < n:
            while k < self.hi and pre + self.L[k] <= cursor:
                pre += self.L[k]
                k += 1
            if k <= rows_c:
                i_r = k
                cum = (pre + (self.L[k] if k < self.hi else 0)
                       if k < CAP else 0)
            else:
                i_r = rows_c
                cum = ((n if rows_c < CAP else 0) if rows_c >= self.hi
                       else sum(self.L[:rows_c + 1]))
            o_r, l_r = self.row(self.O, i_r), self.row(self.L, i_r)
            off = cursor - (cum - l_r)
            so = abs(o_r) - 1
            other = so + off
            other_left = self.t_read(0, other)
            other_right = self.t_read(1, other)
            other_rank = self.t_read(2, other)
            olc = self.cursor_after(other_left)[0]
            probes += 1
            brk = other == o_right or olc < left_cursor
            eq = not brk and olc == left_cursor
            gt = my_rank > other_rank
            brk = brk or (eq and not gt and o_right == other_right)
            if eq and not gt and o_right != other_right and not scanning:
                scan_start = cursor
            if eq:
                scanning = False if gt else (
                    scanning if o_right == other_right else True)
            contains = o_right > other and o_right < so + l_r
            step = o_right - other if contains else l_r - off
            stuck = not brk and step <= 0
            if not brk:
                cursor += step
            if brk:
                break
            if stuck:
                self.err[2] = 1
                self.stuck += 1
                break
        self.probes.append(probes)
        return scan_start if scanning else cursor

    def remote_insert(self, my_rank, o_left, o_right, il, st):
        CAP = self.CAP
        if self.rows + 2 > CAP:
            self.err[0] = 1
        cc = self.integrate(my_rank, o_left, o_right)
        rows = self.rows
        i_r, cum, _ = self.locate(cc, False, True)
        o_r, l_r = self.row(self.O, i_r), self.row(self.L, i_r)
        off = cc - (cum - l_r)
        mrg = (cc > 0 and o_r > 0 and off == l_r and st + 1 == o_r + l_r
               and o_left == o_r + l_r - 2)
        is_split = cc > 0 and off < l_r
        ins_at = 0 if cc == 0 else i_r + 1
        amt = 0 if mrg else (2 if is_split else 1)
        self.shift_down(ins_at, amt, _roll_amount(amt, 2, CAP))
        if i_r < CAP and is_split:
            self.L[i_r] = off
        if i_r < CAP and mrg:
            self.L[i_r] = l_r + il
        if not mrg and ins_at < CAP:
            self.O[ins_at], self.L[ins_at] = st + 1, il
        if is_split and ins_at + 1 < CAP:
            self.O[ins_at + 1] = o_r + off if o_r > 0 else o_r - off
            self.L[ins_at + 1] = l_r - off
        if (is_split or mrg) and i_r < CAP:
            self.hi = max(self.hi, i_r + 1)
        self.rows = rows + amt

    def remote_delete(self, t, dlen):
        roomy = self.rows + 2 <= self.CAP
        tot, parts = 0, []
        for i in range(self.hi):
            bo, bl = self.O[i], self.L[i]
            so = abs(bo) - 1
            cs = min(max(t - so, 0), bl) if bo != 0 else 0
            ce = min(max(t + dlen - so, 0), bl) if bo != 0 else 0
            cov = ce - cs
            tot += cov
            if bo > 0 and cov > 0:
                if cov != bl:
                    parts.append((i, cs, ce))
                elif roomy:
                    self.O[i] = -bo
        if tot < dlen:
            self.err[1] = 1
        if not roomy:
            if parts:
                self.err[0] = 1
                return
            for i in range(self.hi):
                bo, bl = self.O[i], self.L[i]
                so = abs(bo) - 1
                cs = min(max(t - so, 0), bl)
                ce = min(max(t + dlen - so, 0), bl)
                if bo > 0 and ce - cs > 0 and ce - cs == bl:
                    self.O[i] = -bo
        self.rows += self.apply_parts(parts)


# -- the plain versions, checked after every op -------------------------------


def _lane(t, b):
    return [int(x) for x in t[:, b].tolist()]


class _Seen:
    """What the checked replays saw: ops compared, stale starts, stuck
    walks, probes and the largest extent."""

    def __init__(self):
        self.ops = self.stale = self.stuck = self.hi = 0
        self.probes = []
        self.err = [0, 0, 0]


def _compare(st8, models, nerr, seen):
    for b, m in enumerate(models):
        assert m.extent_ok(), b
        assert _lane(st8.ordp, b) == m.O, b
        assert _lane(st8.lenp, b) == m.L, b
        assert int(st8.rowsv[0, b]) == m.rows, b
        assert _lane(st8.err, b)[:nerr] == m.err[:nerr], b
        if m.tables is not None:
            assert _lane(st8.oll, b) == m.tables[0], b
            assert _lane(st8.orl, b) == m.tables[1], b
        seen.hi = max(seen.hi, m.hi)
        seen.err = [max(a, e) for a, e in zip(seen.err, m.err)]
    seen.ops += 1


def _lanes_checked(seen):
    """``rle_lanes._PlainLanes`` with a model per document."""

    class Checked(TL._PlainLanes):
        def __init__(self, ord0, len0, rows0, S, wmax, dev):
            super().__init__(ord0, len0, rows0, S, wmax, dev)
            self.models = [Column(ord0[:, b].tolist(), len0[:, b].tolist(),
                                  rows0[0, b], wmax)
                           for b in range(ord0.shape[1])]
            seen.stale += sum(m.hi > max(m.rows, 0) for m in self.models)
            _compare(self, self.models, 2, seen)

        def do_delete(self, p, d, lv=None, cum=None):
            super().do_delete(p, d, lv, cum)
            for b, m in enumerate(self.models):
                if d[0, b] > 0:
                    m.local_delete(int(p[0, b]), int(d[0, b]))
            _compare(self, self.models, 2, seen)

        def do_insert(self, k, p, il, st, w, lv=None, cum=None):
            super().do_insert(k, p, il, st, w, lv, cum)
            for b, m in enumerate(self.models):
                if il[0, b] > 0:
                    left, right, _ = m.local_insert(
                        int(p[0, b]), int(il[0, b]), int(st[0, b]),
                        int(w[0, b]))
                    assert (int(self.ol[k, b]), int(self.orr[k, b])) == \
                        (left, right)
            _compare(self, self.models, 2, seen)

    return Checked


def _guarded_integrate(self, act, my_rank, o_left, o_right):
    """``integrate_cursor`` with the kernels' stop for a walk that would
    not move (only a corrupt state gives one; the plain loop, as the TPU
    kernel's, would never end): the probe's step lands, err[2] is raised
    and the walk ends there."""
    cumraw = TM._vcumsum(self.lenp)
    n = TM._lsum(self.lenp)
    cursor0 = self.cursor_after(o_left, act)
    left_cursor = cursor0
    cursor, scanning, scan_start = cursor0, torch.zeros_like(cursor0), \
        cursor0
    done = (~act).to(torch.int32)
    while bool(((done == 0) & (cursor < n)).any()):
        i_r = TM._lsum(((cumraw <= cursor) & (self.idx < self.rowsv))
                       .to(torch.int32))
        o_r = TM._vrow(self.ordp, i_r)
        l_r = TM._vrow(self.lenp, i_r)
        off = cursor - (TM._vrow(cumraw, i_r) - l_r)
        so = o_r.abs() - 1
        other_order = so + off
        live = (done == 0) & (cursor < n)
        other_left = TM._t_read(self.oll, other_order)
        other_right = TM._t_read(self.orl, other_order)
        other_rank = TM._t_read(self.rkl, other_order)
        olc = self.cursor_after(other_left, live)
        brk = (other_order == o_right) | (olc < left_cursor)
        eq = ~brk & (olc == left_cursor)
        gt = my_rank > other_rank
        brk = brk | (eq & ~gt & (o_right == other_right))
        starts_scan = eq & ~gt & (o_right != other_right)
        scan_start = torch.where(live & starts_scan & (scanning == 0),
                                 cursor, scan_start)
        scanning = torch.where(
            live & eq,
            torch.where(gt, 0, torch.where(o_right == other_right,
                                           scanning, 1)),
            scanning)
        contains_right = (o_right > other_order) & (o_right < so + l_r)
        step = torch.where(contains_right, o_right - other_order, l_r - off)
        stuck = live & ~brk & (step <= 0)
        self.flag(2, stuck)
        new_cursor = torch.where(live & ~brk, cursor + step, cursor)
        done = torch.maximum(done, (brk | (cursor >= n) | stuck)
                             .to(torch.int32))
        cursor = new_cursor
    return torch.where(scanning != 0, scan_start, cursor), cumraw


def _mixed_checked(seen, guard=False):
    """``rle_lanes_mixed._PlainLanes`` with a model per document."""

    class Checked(TM._PlainLanes):
        def __init__(self, ord0, len0, rows0, oll, orl, rkl, S, wmax, dev):
            super().__init__(ord0, len0, rows0, oll, orl, rkl, S, wmax, dev)
            self.models = [
                Column(ord0[:, b].tolist(), len0[:, b].tolist(),
                       rows0[0, b], wmax,
                       (_lane(oll, b), _lane(orl, b), _lane(rkl, b)))
                for b in range(ord0.shape[1])]
            seen.stale += sum(m.hi > max(m.rows, 0) for m in self.models)
            _compare(self, self.models, 3, seen)

        if guard:
            integrate_cursor = _guarded_integrate

        def do_local_delete(self, act, p, d, lv=None, cum=None):
            super().do_local_delete(act, p, d, lv, cum)
            for b, m in enumerate(self.models):
                if act[0, b]:
                    m.local_delete(int(p[0, b]), int(d[0, b]))
            _compare(self, self.models, 3, seen)

        def do_local_insert(self, act, k, p, il, st, w, lv=None, cum=None):
            super().do_local_insert(act, k, p, il, st, w, lv, cum)
            for b, m in enumerate(self.models):
                if act[0, b]:
                    left, right, _ = m.local_insert(
                        int(p[0, b]), int(il[0, b]), int(st[0, b]),
                        int(w[0, b]))
                    assert (int(self.ol[k, b]), int(self.orr[k, b])) == \
                        (left, right)
            _compare(self, self.models, 3, seen)

        def do_remote_insert(self, act, k, my_rank, o_left, o_right, il, st):
            super().do_remote_insert(act, k, my_rank, o_left, o_right, il,
                                     st)
            for b, m in enumerate(self.models):
                if act[0, b]:
                    stuck = m.stuck
                    m.remote_insert(int(my_rank[0, b]), int(o_left[0, b]),
                                    int(o_right[0, b]), int(il[0, b]),
                                    int(st[0, b]))
                    seen.stuck += m.stuck - stuck
                    seen.probes.append(m.probes[-1])
            _compare(self, self.models, 3, seen)

        def do_remote_delete(self, act, t, dlen):
            super().do_remote_delete(act, t, dlen)
            for b, m in enumerate(self.models):
                if act[0, b]:
                    m.remote_delete(int(t[0, b]), int(dlen[0, b]))
            _compare(self, self.models, 3, seen)

    return Checked


def _chain(plain, runners, edit=None):
    """A stream's chunks through ``plain``, the state grown between them;
    ``edit`` changes the state each later chunk starts from."""
    state = None
    for run in runners:
        ini = run.initial() if state is None else run.grow(state)
        if edit is not None and state is not None:
            ini = edit(ini)
        state = plain(*run.staged, *ini, *getattr(run, "deltas", ()),
                      **run.shape)[2:-1]
    return state


def _stale(ini):
    """Each document's last two rows left past ``rows``."""
    ini = list(ini)
    ini[2] = torch.clamp(ini[2] - 2, min=0)
    return tuple(ini)


def _replay(monkeypatch, mixed, runners, edit=None, guard=False):
    seen = _Seen()
    if mixed:
        monkeypatch.setattr(TM, "_PlainLanes", _mixed_checked(seen, guard))
        _chain(TM.lanes_mixed_replay_plain, runners, edit)
    else:
        monkeypatch.setattr(TL, "_PlainLanes", _lanes_checked(seen))
        _chain(TL.lanes_replay_plain, runners, edit)
    return seen


# -- the cases ----------------------------------------------------------------


def _local(streams, lmax=None, fuse_w=1):
    if lmax is None:
        lmax = max(len(p.ins_content) for ps in streams for p in ps) or 1
    return B.stack_ops([B.compile_local_patches(ps, lmax=lmax, dmax=None,
                                                fuse_w=fuse_w)[0]
                        for ps in streams])


def _bursts():
    """Backwards insert bursts fused W = 5 rows a step."""
    ops = _local([randedit.prepend_bursts(np.random.default_rng(s), 12)[0]
                  for s in (3, 4)], lmax=16, fuse_w=5)
    assert B.fused_width(ops) == 5
    return ops


def _bad_delete():
    return _local([[TestPatch(0, 0, "abc"), TestPatch(0, 10, "")],
                   [TestPatch(0, 0, "abcdefgh"), TestPatch(2, 3, "")]],
                  lmax=8)


def _runners(stacked, caps, mixed):
    """One un-blocked replayer per chunk (order tables of 2,048 rows for
    local streams through the mixed engine)."""
    if mixed:
        return [TM.make_replayer_lanes_mixed(st, capacity=c, chunk=16,
                                             order_capacity=2048,
                                             device="cpu")
                for st, c in zip(stacked, caps)]
    return [TL.make_replayer_lanes(st, capacity=c, chunk=16, device="cpu")
            for st, c in zip(stacked, caps)]


def _config5(mixed, docs=4, chunks=3):
    s5 = stream.make_stream_5(n_docs=docs, chunks=chunks,
                              steps_per_chunk=50, seed_base=500)
    return _runners(s5.stacked, stream.stream_capacities_5(s5), mixed)


# name -> (runners given the engine, edit of the later chunks' starts);
# each case runs through both engines (local ops are the mixed engine's
# LOCAL kind)
LOCAL_CASES = {
    "config-5 chain": lambda m: (_config5(m), None),
    "config-5 chain, rows past rows": lambda m: (_config5(m, 3), _stale),
    "fused bursts W = 5": lambda m: (_runners([_bursts()], [256], m), None),
    "JAX-built fused bursts": lambda m: (
        _runners([to_port(_fused_bursts())], [256], m), None),
    "overflow wraps (W = 5, 16 rows)": lambda m: (
        _runners([_bursts()], [16], m), None),
    "delete past the end": lambda m: (_runners([_bad_delete()], [16], m),
                                      None),
}


@pytest.mark.parametrize("name", sorted(LOCAL_CASES))
@pytest.mark.parametrize("mixed", [False, True])
def test_local_model_matches_plain(monkeypatch, name, mixed):
    runners, edit = LOCAL_CASES[name](mixed)
    seen = _replay(monkeypatch, mixed, runners, edit)
    assert seen.ops > 2
    if edit is not None:
        assert seen.stale > 0
    if "overflow" in name:
        assert seen.err[0] == 1 and seen.hi == 16
    if "past the end" in name:
        assert seen.err[1] == 1


def _stream5r(docs=3, chunks=2):
    s5 = stream.make_stream_5r(n_docs=docs, chunks=chunks,
                               steps_per_chunk=40, seed_base=900)
    return stream.make_stream_replayers(s5, engine="unblocked",
                                        device="cpu")


@pytest.mark.parametrize("name", sorted(A6_CASES))
def test_remote_model_matches_plain(monkeypatch, name):
    """The 5r-like cases of ``test_torch_rle_lanes_mixed.py``: remote
    txns from the JAX package's compiler, error rows included."""
    stacked, capacity = A6_CASES[name]()[:2]
    runners = [TM.make_replayer_lanes_mixed(
        to_port(stacked), capacity=capacity, order_capacity=256, chunk=16,
        device="cpu")]
    seen = _replay(monkeypatch, True, runners)
    assert seen.ops > 1 and seen.stuck == 0


def test_5r_chain_model_matches_plain(monkeypatch):
    seen = _replay(monkeypatch, True, _stream5r())
    assert len(seen.probes) > 50 and seen.stuck == 0
    assert seen.err == [0, 0, 0]


def test_5r_chain_rows_past_rows(monkeypatch):
    """Stale rows past ``rows`` under remote ops: the walk reads them as
    the plain count does; where it would not move, the guarded plain and
    the model stop alike."""
    seen = _replay(monkeypatch, True, _stream5r(), _stale, guard=True)
    # No walk stalls here: the card tests replay this stream with the
    # plain version, which would not end on one.
    assert seen.stale > 0 and len(seen.probes) > 50 and seen.stuck == 0


def _stuck_walk():
    """Chunk 1 builds a document of four runs, [a] [zz] [cd] [gh], the
    last two concurrent children of the second; chunk 2 inserts a third
    child by the highest-ranked author. With ``rows`` cut to 2, the walk
    passes [cd] and reaches the rows past ``rows``, where the TPU
    kernel's count stops at ``rows`` and the cursor would not move."""
    from text_crdt_rust_tpu_torch.common import (RemoteId, RemoteIns,
                                                 RemoteTxn)

    top = RemoteId("ROOT", 0xFFFFFFFF)
    z1 = RemoteId("cat", 1)
    txns = [RemoteTxn(id=RemoteId(agent, 0), parents=[],
                      ops=[RemoteIns(left, right, text)])
            for agent, left, right, text in (
                ("cat", top, top, "zz"),
                ("amy", top, RemoteId("cat", 0), "a"),
                ("bob", z1, top, "cd"),
                ("eve", z1, top, "gh"),
                ("zed", z1, top, "ef"))]
    table = B.AgentTable(["amy", "bob", "cat", "eve", "zed"])
    ops = B.compile_remote_txns(txns, table, lmax=4)[0]
    return [B.stack_ops([B.OpTensors(**{k: v[cut] for k, v in
                                        vars(ops).items()})])
            for cut in (slice(0, 4), slice(4, None))]


def test_stuck_walk_stops_like_the_kernel(monkeypatch):
    runners = [TM.make_replayer_lanes_mixed(ops, capacity=64,
                                            order_capacity=64, chunk=16,
                                            device="cpu")
               for ops in _stuck_walk()]

    def forget(ini):
        ini = list(ini)
        ini[2] = torch.full_like(ini[2], 2)
        return tuple(ini)

    seen = _replay(monkeypatch, True, runners, forget, guard=True)
    assert seen.stale == 1 and seen.stuck == 1 and seen.err[2] == 1


def test_model_sees_unknown_orders(monkeypatch):
    """err[2] from an unknown origin, with the op still applied."""
    stacked = A6_CASES["missing-origin"]()[0]
    runners = [TM.make_replayer_lanes_mixed(
        to_port(stacked), capacity=16, order_capacity=256, chunk=16,
        device="cpu")]
    seen = _replay(monkeypatch, True, runners)
    assert seen.err[2] == 1 and seen.probes
