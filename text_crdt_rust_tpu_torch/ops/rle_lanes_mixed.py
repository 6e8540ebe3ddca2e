"""Per-lane divergent MIXED replay on PyTorch and CUDA: B distinct
documents, each applying its OWN local/remote op stream, one op per
document per step (counterpart of ``text_crdt_rust_tpu/ops/rle_lanes_mixed.py``).

This is the production sync shape: thousands of different documents,
each receiving its own peer's remote ops (`doc.rs:242-348` per lane).
Two engines, bit-identical in documents, YATA cursors and origins:

- the UN-BLOCKED engine (``_mixed_lanes_kernel`` in the JAX package):
  each document is one run column ``ordp/lenp`` ``[CAP, B]`` packed at the
  front with ``rows`` ``[1, B]``; every op works on the whole column;
- the BLOCKED engine (``_mixed_lanes_blocked_kernel``): runs live in
  K-row physical blocks ordered by per-lane logical tables
  (``blkord/rws/liv/raw`` ``[NBT, B]``) with an order -> block HINT table
  ``ordblk`` ``[OCAP, B]`` and split forward pointers ``fwd`` ``[NBT, B]``;
  a step touches the slot tables and one K-row block.

Both keep per-lane by-order tables ``oll/orl`` (mutable, carried across
chunks) and ``rkl`` (ranks, read-only), sentinel −2 = unknown; each
chunk's compile-known entries are merged in at step 0.

Each engine has two implementations, held against each other bit for bit:

- ``lanes_mixed_replay_plain`` / ``lanes_mixed_blocked_replay_plain``:
  plain PyTorch on ``[rows, B]`` tensors, a line-for-line translation of
  the Pallas bodies with every ``pl.when(jnp.any(..))`` a masked update;
- ``ops/csrc/rle_lanes_mixed.cu`` / ``ops/csrc/rle_lanes_mixed_blocked.cu``:
  hand-written CUDA kernels, one warp per document.

``lanes_mixed_replay`` / ``lanes_mixed_blocked_replay`` pick by the device
of their inputs: the plain version for CPU tensors, the kernel for CUDA
tensors (it launches or raises; it never falls back). u32 op columns and
origins ride in int32 tensors with the same bits.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import resolve_device
from . import _kernels
from .batch import (
    KIND_LOCAL,
    KIND_REMOTE_DEL,
    KIND_REMOTE_INS,
    OpTensors,
    _prefill_scatter,
    fused_width,
    fused_width_checked,
)
from .blocked import _require
from .lane_blocks import (
    gather_block,
    gather_head,
    lane_apply_partial,
    scatter_block,
    scatter_block2,
    vshift_up,
)
from .rle_lanes import (
    ROOT_I,
    LanesResult,
    _as_i32,
    _check_cols,
    _empty_blocked_state,
    _fdiv,
    _fused_splice_lanes,
    _grow_blocked_state,
    _grow_planes,
    _live_prefix,
    _lmax,
    _lmin,
    _lsum,
    _pad_rows,
    _shared_cum_gate,
    _stage,
    _vcumsum,
    _vrow,
    _vshift,
)

I32 = torch.int32
TAB_UNKNOWN = -2  # by-order table sentinel: entry not yet known

#: Names of the ten staged op columns, in kernel argument order.
OP_COLUMNS = ("kind", "pos", "del_len", "del_target", "origin_left",
              "origin_right", "rank", "ins_len", "ins_order_start",
              "rows_per_step")


def _fused_table_writes(oll, orl, oidx, act, st, il, lrun, left, right):
    """By-order table upkeep for a (possibly fused) local insert, in place:
    every sub-run head (orders st + k*L) logs the shared left neighbour;
    sub-run k's span logs origin_right = patch k-1's head (k = 0 keeps the
    raw successor)."""
    span = act & (oidx >= st) & (oidx < st + il)
    qoff = oidx - st
    ls = torch.clamp(lrun, min=1)
    oll.copy_(torch.where(span & (torch.remainder(qoff, ls) == 0), left, oll))
    orl.copy_(torch.where(
        span, torch.where(qoff < ls, right, st + (_fdiv(qoff, ls) - 1) * ls),
        orl))


def _t_read(tab, o):
    """``tab[clip(o), lane]`` as ``[1, B]`` (orders < 0 read row 0)."""
    oc = torch.clamp(o, 0, tab.shape[0] - 1)
    return torch.gather(tab, 0, oc.long())


# -- the un-blocked engine, plain version ---------------------------------------


class _PlainLanes:
    """The un-blocked Pallas body over ``[CAP, B]`` planes; each method
    mirrors the kernel function of the same name."""

    def __init__(self, ord0, len0, rows0, oll, orl, rkl, S, wmax, dev):
        CAP, B = ord0.shape
        OCAP = oll.shape[0]
        self.CAP, self.OCAP, self.B, self.WMAX = CAP, OCAP, B, wmax
        self.idx = torch.arange(CAP, dtype=I32, device=dev)[:, None]
        self.oidx = torch.arange(OCAP, dtype=I32, device=dev)[:, None]
        self.ordp, self.lenp = ord0.clone(), len0.clone()
        self.rowsv = rows0.clone()
        self.oll, self.orl, self.rkl = oll, orl, rkl
        self.err = torch.zeros(8, B, dtype=I32, device=dev)
        self.ol = torch.zeros(S, B, dtype=I32, device=dev)
        self.orr = torch.zeros(S, B, dtype=I32, device=dev)

    def flag(self, row, mask):
        self.err[row:row + 1] = torch.where(mask, 1, self.err[row:row + 1])

    def find_run_of_order(self, o, need):
        bo = self.ordp
        so = bo.abs() - 1
        hit = (bo != 0) & (so <= o) & (o < so + self.lenp)
        found = _lsum(hit.to(I32)) > 0
        row = _lmin(torch.where(hit, self.idx, self.CAP))
        self.flag(2, need & ~found)
        return torch.where(found, row, 0), found

    def raw_pos_of_order(self, o, need):
        row, _ = self.find_run_of_order(o, need)
        raw_before = _lsum(torch.where(self.idx < row, self.lenp, 0))
        so_hit = _vrow(self.ordp, row).abs() - 1
        return raw_before + (o - so_hit)

    def cursor_after(self, o, need):
        is_root = o == ROOT_I
        self.flag(2, need & (o == TAB_UNKNOWN))
        p = self.raw_pos_of_order(torch.clamp(o, min=0), need & ~is_root)
        return torch.where(is_root, 0, p + 1)

    def flag_capacity(self, act, need=2):
        self.flag(0, act & (self.rowsv + need > self.CAP))

    def apply_partial(self, a, i_p, bo, bl, cs, ce):
        return lane_apply_partial(a, i_p, bo, bl, cs, ce, self.idx)

    def do_local_delete(self, act, p, d, lv=None, cum=None):
        self.flag_capacity(act)
        bo, bl = self.ordp, self.lenp
        if cum is None:
            lv, cum = _live_prefix(bo, bl)
        before = cum - lv
        rem = torch.where(act, d, 0)
        cs = torch.minimum(torch.clamp(p - before, min=0), lv)
        ce = torch.minimum(torch.clamp(p + rem - before, min=0), lv)
        cov = ce - cs
        tot = _lsum(cov)
        self.flag(1, act & (tot < rem))
        full = (cov > 0) & (cov == bl)
        part = (cov > 0) & ~full
        npart = _lsum(part.to(I32))
        i1 = _lmin(torch.where(part, self.idx, self.CAP))
        i2 = _lmax(torch.where(part, self.idx, -1))
        bo = torch.where(act & full, -bo, bo)
        bo, bl, a2 = self.apply_partial(act & (npart >= 1), i2, bo, bl, cs, ce)
        bo, bl, a1 = self.apply_partial(act & (npart == 2), i1, bo, bl, cs, ce)
        self.ordp, self.lenp = bo, bl
        self.rowsv = self.rowsv + torch.where(act, a1 + a2, 0)

    def do_local_insert(self, act, k, p, il, st, w, lv=None, cum=None):
        rows = self.rowsv
        self.flag_capacity(act, w + 1)
        bo, bl = self.ordp, self.lenp
        if cum is None:
            lv, cum = _live_prefix(bo, bl)
        local = torch.where(act, p, 0)
        i_r = _lsum(((cum < local) & (self.idx < rows)).to(I32))
        o_r = _vrow(bo, i_r)
        l_r = _vrow(bl, i_r)
        off = local - (_vrow(cum, i_r) - _vrow(lv, i_r))
        left = torch.where(p == 0, ROOT_I, (o_r - 1) + (off - 1))
        no, nl, amt, mrg, is_split, lrun = _fused_splice_lanes(
            bo, bl, self.idx, p, i_r, o_r, l_r, off, il, st, w, self.WMAX,
            act)
        nxt = _vrow(bo, i_r + 1)
        first_o = _vrow(bo, torch.zeros_like(i_r))
        succ_p0 = torch.where(rows > 0, first_o, 0)
        succ_after = torch.where(i_r + 1 < rows, nxt, 0)
        succ = torch.where(p == 0, succ_p0,
                           torch.where(is_split, o_r + off, succ_after))
        right = torch.where(succ == 0, ROOT_I, succ.abs() - 1)
        self.ordp, self.lenp = no, nl
        self.rowsv = rows + amt
        _fused_table_writes(self.oll, self.orl, self.oidx, act, st, il, lrun,
                            left, right)
        self.ol[k:k + 1] = torch.where(act, left, self.ol[k:k + 1])
        self.orr[k:k + 1] = torch.where(act, right, self.orr[k:k + 1])

    def integrate_cursor(self, act, my_rank, o_left, o_right):
        cumraw = _vcumsum(self.lenp)
        n = _lsum(self.lenp)
        cursor0 = self.cursor_after(o_left, act)
        left_cursor = cursor0
        cursor, scanning, scan_start = cursor0, torch.zeros_like(cursor0), \
            cursor0
        done = (~act).to(I32)
        while bool(((done == 0) & (cursor < n)).any()):
            i_r = _lsum(((cumraw <= cursor) & (self.idx < self.rowsv))
                        .to(I32))
            o_r = _vrow(self.ordp, i_r)
            l_r = _vrow(self.lenp, i_r)
            off = cursor - (_vrow(cumraw, i_r) - l_r)
            so = o_r.abs() - 1
            other_order = so + off
            live = (done == 0) & (cursor < n)
            other_left = _t_read(self.oll, other_order)
            other_right = _t_read(self.orl, other_order)
            other_rank = _t_read(self.rkl, other_order)
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
            step = torch.where(contains_right, o_right - other_order,
                               l_r - off)
            new_cursor = torch.where(live & ~brk, cursor + step, cursor)
            done = torch.maximum(done, (brk | (cursor >= n)).to(I32))
            cursor = new_cursor
        return torch.where(scanning != 0, scan_start, cursor), cumraw

    def do_remote_insert(self, act, k, my_rank, o_left, o_right, il, st):
        self.flag_capacity(act)
        c, cumraw = self.integrate_cursor(act, my_rank, o_left, o_right)
        rows, bo, bl, idx = self.rowsv, self.ordp, self.lenp, self.idx
        local = torch.where(act, c, 0)
        i_r = _lsum(((cumraw < local) & (idx < rows)).to(I32))
        o_r = _vrow(bo, i_r)
        l_r = _vrow(bl, i_r)
        off = local - (_vrow(cumraw, i_r) - l_r)
        mrg = act & (c > 0) & (o_r > 0) & (off == l_r) & \
            ((st + 1) == (o_r + l_r)) & (o_left == o_r + l_r - 2)
        is_split = act & (c > 0) & (off < l_r)
        ins_at = torch.where(c == 0, 0, i_r + 1)
        amt = torch.where(~act | mrg, 0, 1 + is_split.to(I32))
        so = _vshift(bo, amt)
        sl = _vshift(bl, amt)
        no = torch.where(idx < ins_at, bo, so)
        nl = torch.where(idx < ins_at, bl, sl)
        nl = torch.where(is_split & (idx == i_r), off, nl)
        new_run = act & ~mrg & (idx == ins_at)
        no = torch.where(new_run, st + 1, no)
        nl = torch.where(new_run, il, nl)
        tail = is_split & (idx == ins_at + 1)
        tail_o = torch.where(o_r > 0, o_r + off, o_r - off)
        no = torch.where(tail, tail_o, no)
        nl = torch.where(tail, l_r - off, nl)
        nl = torch.where(mrg & (idx == i_r), l_r + il, nl)
        self.ordp, self.lenp = no, nl
        self.rowsv = rows + amt
        self.ol[k:k + 1] = torch.where(act, o_left, self.ol[k:k + 1])
        self.orr[k:k + 1] = torch.where(act, o_right, self.orr[k:k + 1])

    def do_remote_delete(self, act, t, dlen):
        bo, bl = self.ordp, self.lenp
        so = bo.abs() - 1
        occ = bo != 0
        cs = torch.minimum(torch.clamp(t - so, min=0), bl)
        ce = torch.minimum(torch.clamp(t + dlen - so, min=0), bl)
        cov = torch.where(act & occ, ce - cs, 0)
        tot = _lsum(cov)
        rem = torch.where(act, dlen, 0)
        self.flag(1, act & (tot < rem))
        live = bo > 0
        full = live & (cov > 0) & (cov == bl)
        part = live & (cov > 0) & ~(cov == bl)
        npart = _lsum(part.to(I32))
        tight = act & (npart > 0) & (self.rowsv + 2 > self.CAP)
        self.flag(0, tight)
        a = act & ~tight
        i1 = _lmin(torch.where(part, self.idx, self.CAP))
        i2 = _lmax(torch.where(part, self.idx, -1))
        bo = torch.where(a & full, -bo, bo)
        bo, bl, a2 = self.apply_partial(a & (npart >= 1), i2, bo, bl, cs, ce)
        bo, bl, a1 = self.apply_partial(a & (npart == 2), i1, bo, bl, cs, ce)
        self.ordp, self.lenp = bo, bl
        self.rowsv = self.rowsv + torch.where(a, a1 + a2, 0)


def lanes_mixed_replay_plain(kind, pos, dlen, dtgt, olop, orop, rank, ilen,
                             start, wcol, ord0, len0, rows0, oll0, orl0,
                             olld, orld, rkl, *, wmax: int,
                             shared_cum: bool):
    """The plain PyTorch version of ``_mixed_lanes_kernel``: replay ten
    int32 op columns ``[S, B]`` (one stream per lane) from the warm-start
    state ``(ord0, len0, rows0, oll0, orl0)``, merging the prefill delta
    ``olld/orld`` into the tables at step 0, with ranks ``rkl``. Returns
    ``(ol, orr, ordp, lenp, rows, oll, orl, err)`` in the JAX layout."""
    S = kind.shape[0]
    dev = kind.device
    oll = torch.where(olld != TAB_UNKNOWN, olld, oll0)
    orl = torch.where(orld != TAB_UNKNOWN, orld, orl0)
    st8 = _PlainLanes(ord0, len0, rows0, oll, orl, rkl, S, wmax, dev)
    for k in range(S):
        kd, p, d, il, sto = (kind[k:k + 1], pos[k:k + 1], dlen[k:k + 1],
                             ilen[k:k + 1], start[k:k + 1])
        w = torch.clamp(wcol[k:k + 1], min=1)
        act_ld = (kd == KIND_LOCAL) & (d > 0)
        act_li = (kd == KIND_LOCAL) & (il > 0)
        act_ri = (kd == KIND_REMOTE_INS) & (il > 0)
        act_rd = (kd == KIND_REMOTE_DEL) & (d > 0)
        lv = cum = None
        if shared_cum:
            lv, cum = _live_prefix(st8.ordp, st8.lenp)
        if bool(act_ld.any()):
            st8.do_local_delete(act_ld, p, d, lv, cum)
        if bool(act_li.any()):
            st8.do_local_insert(act_li, k, p, il, sto, w, lv, cum)
        if bool(act_ri.any()):
            st8.do_remote_insert(act_ri, k, rank[k:k + 1], olop[k:k + 1],
                                 orop[k:k + 1], il, sto)
        if bool(act_rd.any()):
            st8.do_remote_delete(act_rd, dtgt[k:k + 1], d)
    return (st8.ol, st8.orr, st8.ordp, st8.lenp, st8.rowsv, st8.oll,
            st8.orl, st8.err)


# -- the blocked engine, plain version -----------------------------------------


class _PlainBlocked:
    """The blocked Pallas body over ``[K, B]`` blocks and ``[NBT, B]``
    slot tables; each method mirrors the kernel function of the same
    name."""

    def __init__(self, state, oll, orl, rkl, S, K, wmax, dev):
        (ordp, lenp, nlog, blk, rws, liv, raw, _o, _r, ordblk, fwd) = state
        CAP, B = ordp.shape
        NB = CAP // K
        NBT = blk.shape[0]
        OCAP = oll.shape[0]
        self.K, self.NB, self.NBT, self.CAP, self.OCAP = K, NB, NBT, CAP, OCAP
        self.WMAX = wmax
        self.kdx = torch.arange(K, dtype=I32, device=dev)[:, None]
        self.tidx = torch.arange(NBT, dtype=I32, device=dev)[:, None]
        self.idx_cap = torch.arange(CAP, dtype=I32, device=dev)[:, None]
        self.oidx = torch.arange(OCAP, dtype=I32, device=dev)[:, None]
        self.ordp, self.lenp = ordp.clone(), lenp.clone()
        self.nlogv = torch.clamp(nlog, min=1)
        self.blkord, self.rws = blk.clone(), rws.clone()
        self.liv, self.raw = liv.clone(), raw.clone()
        self.cumliv, self.cumraw = _vcumsum(liv), _vcumsum(raw)
        self.oll, self.orl, self.rkl = oll, orl, rkl
        self.ordblk, self.fwd = ordblk.clone(), fwd.clone()
        self.err = torch.zeros(8, B, dtype=I32, device=dev)
        self.ol = torch.zeros(S, B, dtype=I32, device=dev)
        self.orr = torch.zeros(S, B, dtype=I32, device=dev)

    def flag(self, row, mask):
        self.err[row:row + 1] = torch.where(mask, 1, self.err[row:row + 1])

    def gather(self, plane, b):
        return gather_block(plane, b, self.K, self.NB)

    # -- logical block tables ---------------------------------------------

    def slot_of(self, cum, rank1, strict):
        nl = self.nlogv
        hit = ((cum < rank1) if strict else (cum <= rank1)) & (self.tidx < nl)
        return torch.minimum(_lsum(hit.to(I32)), nl - 1)

    def live_before(self, l):
        return _vrow(self.cumliv, l) - _vrow(self.liv, l)

    def raw_before(self, l):
        return _vrow(self.cumraw, l) - _vrow(self.raw, l)

    def split(self, act, l):
        K, NB, kdx, tidx = self.K, self.NB, self.kdx, self.tidx
        self.flag(0, act & (self.nlogv >= NB))
        do = act & (self.nlogv < NB)
        if not bool(do.any()):
            return
        b = _vrow(self.blkord, l)
        r = _vrow(self.rws, l)
        keep = _fdiv(r, 2)
        mv = r - keep
        nbv = self.nlogv
        ws_o = self.gather(self.ordp, b)
        ws_l = self.gather(self.lenp, b)
        hi = (kdx >= keep) & (kdx < r)
        liv_hi = _lsum(torch.where(hi & (ws_o > 0), ws_l, 0))
        raw_hi = _lsum(torch.where(hi, ws_l, 0))
        up_o = vshift_up(ws_o, keep, K)
        up_l = vshift_up(ws_l, keep, K)
        scatter_block2(self.ordp, b, torch.where(kdx < keep, ws_o, 0),
                       nbv, torch.where(kdx < mv, up_o, 0), do, K, NB)
        scatter_block2(self.lenp, b, torch.where(kdx < keep, ws_l, 0),
                       nbv, torch.where(kdx < mv, up_l, 0), do, K, NB)
        for name in ("blkord", "rws", "liv", "raw", "cumliv", "cumraw"):
            tbl = getattr(self, name)
            setattr(self, name, torch.where(do & (tidx > l),
                                            torch.roll(tbl, 1, 0), tbl))
        w_l = do & (tidx == l)
        w_l1 = do & (tidx == l + 1)
        self.rws = torch.where(w_l, keep, torch.where(w_l1, mv, self.rws))
        self.liv = torch.where(w_l, self.liv - liv_hi,
                               torch.where(w_l1, liv_hi, self.liv))
        self.raw = torch.where(w_l, self.raw - raw_hi,
                               torch.where(w_l1, raw_hi, self.raw))
        self.cumliv = torch.where(w_l, self.cumliv - liv_hi, self.cumliv)
        self.cumraw = torch.where(w_l, self.cumraw - raw_hi, self.cumraw)
        self.blkord = torch.where(w_l1, nbv, self.blkord)
        self.fwd = torch.where(do & (tidx == b), nbv, self.fwd)
        self.nlogv = self.nlogv + do.to(I32)

    # -- order -> run / position lookups ----------------------------------

    def verify_block(self, b_raw, o):
        ok = (b_raw >= 0) & (b_raw < self.NB)
        bc = torch.where(ok, b_raw, 0)
        ws_o = self.gather(self.ordp, bc)
        ws_l = self.gather(self.lenp, bc)
        so = ws_o.abs() - 1
        hit = (ws_o != 0) & (so <= o) & (o < so + ws_l)
        f = ok & (_lsum(hit.to(I32)) > 0)
        rowk = _lmin(torch.where(hit, self.kdx, self.K - 1))
        return f, bc, rowk

    def locate_order(self, o, want, flag):
        K = self.K
        bh = _t_read(self.ordblk, o)
        hfound, bhc, rowk_h = self.verify_block(bh, o)
        miss1 = want & ~hfound
        z = torch.zeros_like(bhc)
        f2, b2, r2, f3, b3, r3 = (z != 0), z, z, (z != 0), z, z
        if bool(miss1.any()):
            b2r = _vrow(self.fwd, bhc)
            f2, b2, r2 = self.verify_block(torch.where(hfound, -1, b2r), o)
            b3r = _vrow(self.fwd, b2)
            f3, b3, r3 = self.verify_block(torch.where(f2, -1, b3r), o)
        hop2 = miss1 & f2
        hop3 = miss1 & ~hop2 & f3
        miss2 = miss1 & ~hop2 & ~hop3
        gfound_raw, grow = (z != 0), z
        if bool(miss2.any()):
            bo = self.ordp
            sog = bo.abs() - 1
            ghit = (bo != 0) & (sog <= o) & (o < sog + self.lenp)
            gfound_raw = _lsum(ghit.to(I32)) > 0
            grow = _lmin(torch.where(ghit, self.idx_cap, self.CAP - 1))
        gfound = miss2 & gfound_raw
        found = hfound | hop2 | hop3 | gfound
        nb = torch.where(hfound, bhc, torch.where(
            hop2, b2, torch.where(hop3, b3, _fdiv(grow, K))))
        rowk = torch.where(hfound, rowk_h, torch.where(
            hop2, r2, torch.where(hop3, r3, torch.remainder(grow, K))))
        heal = want & ~hfound & found
        if bool(heal.any()):
            gr = nb * K + rowk
            h_o = _vrow(self.ordp, gr)
            h_l = _vrow(self.lenp, gr)
            h_so = h_o.abs() - 1
            self.ordblk = torch.where(
                heal & (self.oidx >= h_so) & (self.oidx < h_so + h_l), nb,
                self.ordblk)
        if flag is not None:
            self.flag(2, flag & ~found)
        return nb, rowk, found

    def slot_of_block(self, nb):
        lhit = (self.blkord == nb) & (self.tidx < self.nlogv)
        return _lmax(torch.where(lhit, self.tidx, 0))

    def locate_order_pure(self, o):
        K = self.K
        bh = _t_read(self.ordblk, o)
        bh_ok = (bh >= 0) & (bh < self.NB)
        bhc = torch.where(bh_ok, bh, 0)
        ws_o = self.gather(self.ordp, bhc)
        ws_l = self.gather(self.lenp, bhc)
        so = ws_o.abs() - 1
        hit = (ws_o != 0) & (so <= o) & (o < so + ws_l)
        hfound = bh_ok & (_lsum(hit.to(I32)) > 0)
        rowk_h = _lmin(torch.where(hit, self.kdx, K - 1))
        bo = self.ordp
        sog = bo.abs() - 1
        ghit = (bo != 0) & (sog <= o) & (o < sog + self.lenp)
        grow = _lmin(torch.where(ghit, self.idx_cap, self.CAP - 1))
        return (torch.where(hfound, bhc, _fdiv(grow, K)),
                torch.where(hfound, rowk_h, torch.remainder(grow, K)))

    def raw_pos_of_order(self, o, need):
        nb, rowk, _ = self.locate_order(o, need, need)
        l = self.slot_of_block(nb)
        ws_o = self.gather(self.ordp, nb)
        ws_l = self.gather(self.lenp, nb)
        inblk = _lsum(torch.where(self.kdx < rowk, ws_l, 0))
        so_hit = _vrow(ws_o, rowk).abs() - 1
        return self.raw_before(l) + inblk + (o - so_hit)

    def cursor_after(self, o, need):
        is_root = o == ROOT_I
        self.flag(2, need & (o == TAB_UNKNOWN))
        p = self.raw_pos_of_order(torch.clamp(o, min=0), need & ~is_root)
        return torch.where(is_root, 0, p + 1)

    def total_raw(self):
        return _vrow(self.cumraw, self.nlogv - 1)

    # -- local ops ------------------------------------------------------------

    def do_local_delete(self, act, p, d):
        K, NB, kdx, tidx = self.K, self.NB, self.kdx, self.tidx
        rem = torch.where(act, d, 0)
        iters = 0
        while bool((act & (rem > 0)).any()) and iters <= 2 * self.NBT:
            a = act & (rem > 0)
            l = self.slot_of(self.cumliv, p + 1, strict=True)
            need = a & (_vrow(self.rws, l) + 2 > K)
            if bool(need.any()):
                self.split(need, l)
                l = self.slot_of(self.cumliv, p + 1, strict=True)
            b = _vrow(self.blkord, l)
            base = self.live_before(l)
            ws_o = self.gather(self.ordp, b)
            ws_l = self.gather(self.lenp, b)
            lv = torch.where(ws_o > 0, ws_l, 0)
            cum = _vcumsum(lv)
            before = base + cum - lv
            remm = torch.where(a, rem, 0)
            cs = torch.minimum(torch.clamp(p - before, min=0), lv)
            ce = torch.minimum(torch.clamp(p + remm - before, min=0), lv)
            cov = ce - cs
            tot = _lsum(cov)
            full = (cov > 0) & (cov == ws_l)
            part = (cov > 0) & ~full
            npart = _lsum(part.to(I32))
            i1 = _lmin(torch.where(part, kdx, K))
            i2 = _lmax(torch.where(part, kdx, -1))
            ws_o = torch.where(a & full, -ws_o, ws_o)
            ws_o, ws_l, a2 = lane_apply_partial(
                a & (npart >= 1), i2, ws_o, ws_l, cs, ce, kdx)
            ws_o, ws_l, a1 = lane_apply_partial(
                a & (npart == 2), i1, ws_o, ws_l, cs, ce, kdx)
            scatter_block(self.ordp, b, ws_o, a, K, NB)
            scatter_block(self.lenp, b, ws_l, a, K, NB)
            w_l = a & (tidx == l)
            self.rws = torch.where(w_l, self.rws + a1 + a2, self.rws)
            self.liv = torch.where(w_l, self.liv - tot, self.liv)
            self.cumliv = torch.where(a & (tidx >= l), self.cumliv - tot,
                                      self.cumliv)
            rem = rem - torch.where(a, tot, 0)
            iters += 1
        self.flag(1, act & (rem > 0))

    def do_local_insert(self, act, k, p, il, st, w):
        K, NB, kdx, tidx = self.K, self.NB, self.kdx, self.tidx

        def slot():
            return torch.where(p == 0, 0,
                               self.slot_of(self.cumliv, p, strict=True))

        l = slot()
        need = act & (_vrow(self.rws, l) + w + 1 > K)
        if bool(need.any()):
            self.split(need, l)
            l = slot()
        r0 = _vrow(self.rws, l)
        b = _vrow(self.blkord, l)
        local = torch.where(act, p - self.live_before(l), 0)
        ws_o = self.gather(self.ordp, b)
        ws_l = self.gather(self.lenp, b)
        lv = torch.where(ws_o > 0, ws_l, 0)
        cum = _vcumsum(lv)
        i_r = _lsum(((cum < local) & (kdx < r0)).to(I32))
        o_r = _vrow(ws_o, i_r)
        l_r = _vrow(ws_l, i_r)
        off = local - (_vrow(cum, i_r) - _vrow(lv, i_r))
        left = torch.where(p == 0, ROOT_I, (o_r - 1) + (off - 1))
        no, nl, amt, mrg, is_split, lrun = _fused_splice_lanes(
            ws_o, ws_l, kdx, p, i_r, o_r, l_r, off, il, st, w, self.WMAX, act)
        nxt_in_blk = _vrow(ws_o, i_r + 1)
        b2 = _vrow(self.blkord, torch.clamp(l + 1, max=self.NBT - 1))
        nxt_slot_o = gather_head(self.ordp, b2, K, NB)
        first_o = gather_head(
            self.ordp, _vrow(self.blkord, torch.zeros_like(l)), K, NB)
        succ_p0 = torch.where(_vrow(self.rws, torch.zeros_like(l)) > 0,
                              first_o, 0)
        succ_after = torch.where(
            i_r + 1 < r0, nxt_in_blk,
            torch.where(l + 1 < self.nlogv, nxt_slot_o, 0))
        succ = torch.where(p == 0, succ_p0,
                           torch.where(is_split, o_r + off, succ_after))
        right = torch.where(succ == 0, ROOT_I, succ.abs() - 1)
        scatter_block(self.ordp, b, no, act, K, NB)
        scatter_block(self.lenp, b, nl, act, K, NB)
        w_l = act & (tidx == l)
        self.rws = torch.where(w_l, self.rws + amt, self.rws)
        self.liv = torch.where(w_l, self.liv + il, self.liv)
        self.raw = torch.where(w_l, self.raw + il, self.raw)
        self.cumliv = torch.where(act & (tidx >= l), self.cumliv + il,
                                  self.cumliv)
        self.cumraw = torch.where(act & (tidx >= l), self.cumraw + il,
                                  self.cumraw)
        _fused_table_writes(self.oll, self.orl, self.oidx, act, st, il, lrun,
                            left, right)
        self.ordblk = torch.where(
            act & (self.oidx >= st) & (self.oidx < st + il), b, self.ordblk)
        self.ol[k:k + 1] = torch.where(act, left, self.ol[k:k + 1])
        self.orr[k:k + 1] = torch.where(act, right, self.orr[k:k + 1])

    # -- remote insert ----------------------------------------------------------

    def run_at_raw(self, c):
        ls = self.slot_of(self.cumraw, c, strict=False)
        b = _vrow(self.blkord, ls)
        r0 = _vrow(self.rws, ls)
        local = c - self.raw_before(ls)
        ws_o = self.gather(self.ordp, b)
        ws_l = self.gather(self.lenp, b)
        cumb = _vcumsum(ws_l)
        i_r = _lsum(((cumb <= local) & (self.kdx < r0)).to(I32))
        o_r = _vrow(ws_o, i_r)
        l_r = _vrow(ws_l, i_r)
        off = local - (_vrow(cumb, i_r) - l_r)
        return o_r, l_r, off

    def integrate_cursor(self, act, my_rank, o_left, o_right):
        n = self.total_raw()
        cursor0 = self.cursor_after(o_left, act)
        left_cursor = cursor0
        cursor, scanning, scan_start = cursor0, torch.zeros_like(cursor0), \
            cursor0
        done = (~act).to(I32)
        while bool(((done == 0) & (cursor < n)).any()):
            o_r, l_r, off = self.run_at_raw(cursor)
            so = o_r.abs() - 1
            other_order = so + off
            live = (done == 0) & (cursor < n)
            other_left = _t_read(self.oll, other_order)
            other_right = _t_read(self.orl, other_order)
            other_rank = _t_read(self.rkl, other_order)
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
            step = torch.where(contains_right, o_right - other_order,
                               l_r - off)
            new_cursor = torch.where(live & ~brk, cursor + step, cursor)
            done = torch.maximum(done, (brk | (cursor >= n)).to(I32))
            cursor = new_cursor
        return torch.where(scanning != 0, scan_start, cursor)

    def do_remote_insert(self, act, k, my_rank, o_left, o_right, il, st):
        K, NB, kdx, tidx = self.K, self.NB, self.kdx, self.tidx
        c = self.integrate_cursor(act, my_rank, o_left, o_right)

        def slot():
            return torch.where(c == 0, 0,
                               self.slot_of(self.cumraw, c, strict=True))

        l = slot()
        need = act & (_vrow(self.rws, l) + 2 > K)
        if bool(need.any()):
            self.split(need, l)
            l = slot()
        r0 = _vrow(self.rws, l)
        b = _vrow(self.blkord, l)
        local = torch.where(act, c - self.raw_before(l), 0)
        ws_o = self.gather(self.ordp, b)
        ws_l = self.gather(self.lenp, b)
        cumb = _vcumsum(ws_l)
        i_r = _lsum(((cumb < local) & (kdx < r0)).to(I32))
        o_r = _vrow(ws_o, i_r)
        l_r = _vrow(ws_l, i_r)
        off = local - (_vrow(cumb, i_r) - l_r)
        mrg = act & (c > 0) & (o_r > 0) & (off == l_r) & \
            ((st + 1) == (o_r + l_r)) & (o_left == o_r + l_r - 2)
        is_split = act & (c > 0) & (off < l_r)
        ins_at = torch.where(c == 0, 0, i_r + 1)
        amt = torch.where(~act | mrg, 0, 1 + is_split.to(I32))
        so = _vshift(ws_o, amt)
        sl = _vshift(ws_l, amt)
        no = torch.where(kdx < ins_at, ws_o, so)
        nl = torch.where(kdx < ins_at, ws_l, sl)
        nl = torch.where(is_split & (kdx == i_r), off, nl)
        new_run = act & ~mrg & (kdx == ins_at)
        no = torch.where(new_run, st + 1, no)
        nl = torch.where(new_run, il, nl)
        tail = is_split & (kdx == ins_at + 1)
        tail_o = torch.where(o_r > 0, o_r + off, o_r - off)
        no = torch.where(tail, tail_o, no)
        nl = torch.where(tail, l_r - off, nl)
        nl = torch.where(mrg & (kdx == i_r), l_r + il, nl)
        scatter_block(self.ordp, b, no, act, K, NB)
        scatter_block(self.lenp, b, nl, act, K, NB)
        w_l = act & (tidx == l)
        self.rws = torch.where(w_l, self.rws + amt, self.rws)
        self.liv = torch.where(w_l, self.liv + il, self.liv)
        self.raw = torch.where(w_l, self.raw + il, self.raw)
        self.cumliv = torch.where(act & (tidx >= l), self.cumliv + il,
                                  self.cumliv)
        self.cumraw = torch.where(act & (tidx >= l), self.cumraw + il,
                                  self.cumraw)
        self.ordblk = torch.where(
            act & (self.oidx >= st) & (self.oidx < st + il), b, self.ordblk)
        self.ol[k:k + 1] = torch.where(act, o_left, self.ol[k:k + 1])
        self.orr[k:k + 1] = torch.where(act, o_right, self.orr[k:k + 1])

    # -- remote delete: the hint-guided covered-run walk -------------------------

    def do_remote_delete(self, act, t, dlen):
        K, NB, kdx, tidx = self.K, self.NB, self.kdx, self.tidx
        end = t + torch.where(act, dlen, 0)
        o_cur = torch.where(act, t, 0)
        rem = torch.where(act, dlen, 0)
        iters = 0
        while bool((rem > 0).any()) and iters <= self.CAP + self.NBT:
            a = act & (rem > 0)
            nb, rowk, found = self.locate_order(o_cur, a, None)
            miss = a & ~found
            self.flag(1, miss)
            a = a & found
            ws_o = self.gather(self.ordp, nb)
            ws_l = self.gather(self.lenp, nb)
            o_r = _vrow(ws_o, rowk)
            l_r = _vrow(ws_l, rowk)
            so = o_r.abs() - 1
            aa = o_cur - so
            ee = torch.minimum(l_r, end - so)
            live = o_r > 0
            ispartial = live & ((aa > 0) | (ee < l_r))
            l = self.slot_of_block(nb)
            need = a & ispartial & (_vrow(self.rws, l) + 2 > K)
            if bool(need.any()):
                self.split(need, l)
                nb, rowk = self.locate_order_pure(o_cur)
            l = self.slot_of_block(nb)
            housed = ~ispartial | (_vrow(self.rws, l) + 2 <= K)
            a = a & housed
            ws_o = self.gather(self.ordp, nb)
            ws_l = self.gather(self.lenp, nb)
            o_r = _vrow(ws_o, rowk)
            l_r = _vrow(ws_l, rowk)
            so = o_r.abs() - 1
            aa = o_cur - so
            ee = torch.minimum(l_r, end - so)
            cov = ee - aa
            live = o_r > 0
            ispartial = live & ((aa > 0) | (ee < l_r))
            flip = a & live & ~ispartial
            ws_o2 = torch.where(flip & (kdx == rowk), -ws_o, ws_o)
            part = a & ispartial
            has_head = part & (aa > 0)
            has_tail = part & (ee < l_r)
            amt = has_head.to(I32) + has_tail.to(I32)
            sh_o = _vshift(ws_o2, amt)
            sh_l = _vshift(ws_l, amt)
            no = torch.where(kdx <= rowk, ws_o2, sh_o)
            nl = torch.where(kdx <= rowk, ws_l, sh_l)
            p0o = torch.where(has_head, o_r, -(so + aa + 1))
            p0l = torch.where(has_head, aa, cov)
            p1o = torch.where(has_head, -(so + aa + 1), so + ee + 1)
            p1l = torch.where(has_head, cov, l_r - ee)
            w0 = part & (kdx == rowk)
            no = torch.where(w0, p0o, no)
            nl = torch.where(w0, p0l, nl)
            w1 = part & (kdx == rowk + 1) & (amt >= 1)
            no = torch.where(w1, p1o, no)
            nl = torch.where(w1, p1l, nl)
            w2 = part & (kdx == rowk + 2) & (amt == 2)
            no = torch.where(w2, so + ee + 1, no)
            nl = torch.where(w2, l_r - ee, nl)
            touch = flip | part
            scatter_block(self.ordp, nb, no, touch, K, NB)
            scatter_block(self.lenp, nb, nl, touch, K, NB)
            dec = torch.where(a & live, cov, 0)
            w_l = a & (tidx == l)
            self.rws = torch.where(w_l & part, self.rws + amt, self.rws)
            self.liv = torch.where(w_l, self.liv - dec, self.liv)
            self.cumliv = torch.where(a & (tidx >= l), self.cumliv - dec,
                                      self.cumliv)
            rem = torch.where(miss | ~housed, 0,
                              rem - torch.where(a, cov, 0))
            o_cur = so + ee
            iters += 1
        self.flag(1, rem > 0)


def lanes_mixed_blocked_replay_plain(
        kind, pos, dlen, dtgt, olop, orop, rank, ilen, start, wcol,
        ord0, len0, nlog0, blk0, rws0, liv0, raw0, oll0, orl0, ordblk0,
        fwd0, olld, orld, rkl, *, block_k: int, wmax: int):
    """The plain PyTorch version of ``_mixed_lanes_blocked_kernel``: replay
    ten int32 op columns ``[S, B]`` from the warm-start 11-tuple (``ord0
    .. fwd0``), merging the prefill delta ``olld/orld`` into the tables at
    step 0, with ranks ``rkl``. Returns ``(ol, orr, ordp, lenp, nlog,
    blkord, rws, liv, raw, oll, orl, ordblk, fwd, err)`` in the JAX
    layout."""
    S = kind.shape[0]
    dev = kind.device
    oll = torch.where(olld != TAB_UNKNOWN, olld, oll0)
    orl = torch.where(orld != TAB_UNKNOWN, orld, orl0)
    st8 = _PlainBlocked((ord0, len0, nlog0, blk0, rws0, liv0, raw0, None,
                         None, ordblk0, fwd0), oll, orl, rkl, S, block_k,
                        wmax, dev)
    for k in range(S):
        kd, p, d, il, sto = (kind[k:k + 1], pos[k:k + 1], dlen[k:k + 1],
                             ilen[k:k + 1], start[k:k + 1])
        w = torch.clamp(wcol[k:k + 1], min=1)
        act_ld = (kd == KIND_LOCAL) & (d > 0)
        act_li = (kd == KIND_LOCAL) & (il > 0)
        act_ri = (kd == KIND_REMOTE_INS) & (il > 0)
        act_rd = (kd == KIND_REMOTE_DEL) & (d > 0)
        if bool(act_ld.any()):
            st8.do_local_delete(act_ld, p, d)
        if bool(act_li.any()):
            st8.do_local_insert(act_li, k, p, il, sto, w)
        if bool(act_ri.any()):
            st8.do_remote_insert(act_ri, k, rank[k:k + 1], olop[k:k + 1],
                                 orop[k:k + 1], il, sto)
        if bool(act_rd.any()):
            st8.do_remote_delete(act_rd, dtgt[k:k + 1], d)
    return (st8.ol, st8.orr, st8.ordp, st8.lenp, st8.nlogv, st8.blkord,
            st8.rws, st8.liv, st8.raw, st8.oll, st8.orl, st8.ordblk, st8.fwd,
            st8.err)


# -- the CUDA kernels -------------------------------------------------------------

_KERNEL = "rle_lanes_mixed"
_LAUNCH = "rle_lanes_mixed_launch"
# 10 op columns, 8 inputs, 8 outputs, the scratch planes; S, B, CAP, OCAP,
# WMAX; the stream.
_ARGTYPES = [ctypes.c_void_p] * 27 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SCRATCH_PLANES = 8  # lane-major [B, CAP]: ordp, lenp, 2 shift copies, 4 temps

_BKERNEL = "rle_lanes_mixed_blocked"
_BLAUNCH = "rle_lanes_mixed_blocked_launch"
# 10 op columns, 14 inputs, 14 outputs, the scratch planes; S, B, CAP, K,
# NBT, OCAP, WMAX; the stream.
_BARGTYPES = [ctypes.c_void_p] * 39 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BSCRATCH_PLANES = 2  # lane-major [B, CAP]: ordp, lenp


def lanes_mixed_replay_cuda(kind, pos, dlen, dtgt, olop, orop, rank, ilen,
                            start, wcol, ord0, len0, rows0, oll0, orl0,
                            olld, orld, rkl, *, wmax: int,
                            shared_cum: bool):
    """Launch ``ops/csrc/rle_lanes_mixed.cu`` on PyTorch's current stream.
    Same arguments and results as ``lanes_mixed_replay_plain``
    (``shared_cum`` is the TPU's cost gate and changes no result)."""
    del shared_cum
    S, B = kind.shape
    CAP, OCAP = ord0.shape[0], oll0.shape[0]
    dev = kind.device
    cols = (kind, pos, dlen, dtgt, olop, orop, rank, ilen, start, wcol)
    _check_cols(cols, dev, S, B)
    _check_cols((ord0, len0), dev, CAP, B, "run planes")
    _check_cols((rows0,), dev, 1, B, "rows")
    _check_cols((oll0, orl0, olld, orld, rkl), dev, OCAP, B, "order tables")
    _require(S >= 1 and CAP >= 8 and wmax >= 1, "bad replay shape")

    def out(r):
        return torch.empty(r, B, dtype=I32, device=dev)

    outs = (out(S), out(S), out(CAP), out(CAP), out(1), out(OCAP),
            out(OCAP), out(8))
    scratch = torch.empty(_SCRATCH_PLANES, B, CAP, dtype=I32, device=dev)
    fn = _kernels.function(_KERNEL, _LAUNCH, _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tensors = (*cols, ord0, len0, rows0, oll0, orl0, olld, orld, rkl, *outs,
               scratch)
    code = fn(*(t.data_ptr() for t in tensors), S, B, CAP, OCAP, wmax, stream)
    _kernels.check(_KERNEL, code)
    _kernels.count_launch(_KERNEL)
    return outs


def lanes_mixed_blocked_replay_cuda(
        kind, pos, dlen, dtgt, olop, orop, rank, ilen, start, wcol,
        ord0, len0, nlog0, blk0, rws0, liv0, raw0, oll0, orl0, ordblk0,
        fwd0, olld, orld, rkl, *, block_k: int, wmax: int):
    """Launch ``ops/csrc/rle_lanes_mixed_blocked.cu`` on PyTorch's current
    stream. Same arguments and results as
    ``lanes_mixed_blocked_replay_plain``."""
    S, B = kind.shape
    CAP, NBT, OCAP = ord0.shape[0], blk0.shape[0], oll0.shape[0]
    K = block_k
    dev = kind.device
    cols = (kind, pos, dlen, dtgt, olop, orop, rank, ilen, start, wcol)
    _check_cols(cols, dev, S, B)
    _check_cols((ord0, len0), dev, CAP, B, "run planes")
    _check_cols((nlog0,), dev, 1, B, "nlog")
    _check_cols((blk0, rws0, liv0, raw0, fwd0), dev, NBT, B, "slot tables")
    _check_cols((oll0, orl0, ordblk0, olld, orld, rkl), dev, OCAP, B,
                "order tables")
    _require(S >= 1 and 8 <= K <= 1024 and CAP % K == 0 and wmax >= 1,
             "bad replay shape")
    _require(NBT == max(8, CAP // K), "slot tables must hold max(8, NB) rows")

    def out(r):
        return torch.empty(r, B, dtype=I32, device=dev)

    outs = (out(S), out(S), out(CAP), out(CAP), out(1), out(NBT), out(NBT),
            out(NBT), out(NBT), out(OCAP), out(OCAP), out(OCAP), out(NBT),
            out(8))
    scratch = torch.empty(_BSCRATCH_PLANES, B, CAP, dtype=I32, device=dev)
    fn = _kernels.function(_BKERNEL, _BLAUNCH, _BARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tensors = (*cols, ord0, len0, nlog0, blk0, rws0, liv0, raw0, oll0, orl0,
               ordblk0, fwd0, olld, orld, rkl, *outs, scratch)
    code = fn(*(t.data_ptr() for t in tensors), S, B, CAP, K, NBT, OCAP,
              wmax, stream)
    _kernels.check(_BKERNEL, code)
    _kernels.count_launch(_BKERNEL)
    return outs


def lanes_mixed_replay(*args, **shape):
    """The un-blocked replay on the device of its inputs: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    dev = args[0].device
    if dev.type == "cpu":
        return lanes_mixed_replay_plain(*args, **shape)
    if dev.type == "cuda":
        return lanes_mixed_replay_cuda(*args, **shape)
    raise ValueError(f"no replay for device {dev}")


def lanes_mixed_blocked_replay(*args, **shape):
    """The blocked replay on the device of its inputs: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    dev = args[0].device
    if dev.type == "cpu":
        return lanes_mixed_blocked_replay_plain(*args, **shape)
    if dev.type == "cuda":
        return lanes_mixed_blocked_replay_cuda(*args, **shape)
    raise ValueError(f"no replay for device {dev}")


# -- results, tables and replayers ------------------------------------------------


@dataclasses.dataclass
class LanesMixedResult(LanesResult):
    """``LanesResult`` plus the per-lane by-order tables (the warm-start
    carry) and the missing-order flag (err row 2)."""

    oll: torch.Tensor = None   # i32[OCAP, B]
    orl: torch.Tensor = None   # i32[OCAP, B]

    def check(self) -> None:
        super().check()
        err = self.err.cpu().numpy()
        if err[2].max() != 0:
            raise RuntimeError(
                f"order lookup missed on lanes "
                f"{np.nonzero(err[2])[0][:8].tolist()}: an op referenced "
                f"an order absent from device state")

    def state(self):
        """(ordp, lenp, rows, oll, orl): the next chunk's ``init``."""
        return self.ordp, self.lenp, self.rows, self.oll, self.orl


@dataclasses.dataclass
class BlockedLanesMixedResult:
    """Blocked per-lane mixed outputs: block state and by-order tables."""

    ordp: torch.Tensor     # i32[CAP, B]
    lenp: torch.Tensor     # i32[CAP, B]
    nlog: torch.Tensor     # i32[1, B]
    blkord: torch.Tensor   # i32[NBT, B]
    rws: torch.Tensor      # i32[NBT, B]
    liv: torch.Tensor      # i32[NBT, B]
    raw: torch.Tensor      # i32[NBT, B]
    oll: torch.Tensor      # i32[OCAP, B]
    orl: torch.Tensor      # i32[OCAP, B]
    ordblk: torch.Tensor   # i32[OCAP, B] order -> block hint (may be stale)
    fwd: torch.Tensor      # i32[NBT, B] split forward pointers
    ol: torch.Tensor       # i32[S, B] (u32 bits)
    orr: torch.Tensor      # i32[S, B] (u32 bits)
    err: torch.Tensor      # i32[8, B] 0: blocks; 1: bad delete; 2: order miss
    batch: int
    block_k: int

    #: ``state()``'s field names, in order (the checkpoint keys).
    STATE_KEYS = ("ordp", "lenp", "nlog", "blkord", "rws", "liv", "raw",
                  "oll", "orl", "ordblk", "fwd")

    def check(self) -> None:
        err = self.err.cpu().numpy()
        if err[0].max() != 0:
            raise RuntimeError(
                f"blocked rle_lanes_mixed out of blocks on lanes "
                f"{np.nonzero(err[0])[0][:8].tolist()}; raise capacity")
        if err[1].max() != 0:
            raise RuntimeError(
                f"delete ran past the end of the document on lanes "
                f"{np.nonzero(err[1])[0][:8].tolist()}")
        if err[2].max() != 0:
            raise RuntimeError(
                f"order lookup missed on lanes "
                f"{np.nonzero(err[2])[0][:8].tolist()}: an op referenced "
                f"an order absent from device state")

    def state(self):
        """The next chunk's ``init`` 11-tuple (the hint and forward tables
        ride along so warm-start chunks keep their locality)."""
        return tuple(getattr(self, k) for k in self.STATE_KEYS)

    @property
    def rows(self):
        return self.rws.sum(dim=0, keepdim=True, dtype=I32)


def lane_tables(stacked: OpTensors, ocap: int):
    """Per-lane by-order prefill: ``(oll, orl, rkl)`` as int32 ``[OCAP, B]``
    numpy, sentinel −2 for unknown entries (u32 ROOT maps to −1):
    remote head origins, within-run chains and author ranks, from
    ``batch._prefill_scatter`` per lane."""
    kinds = np.asarray(stacked.kind)
    assert kinds.ndim == 2, "lane_tables takes stacked [S, B] streams"
    B = kinds.shape[1]
    oll = np.full((B, ocap), TAB_UNKNOWN, np.int32)
    orl = np.full((B, ocap), TAB_UNKNOWN, np.int32)
    rkl = np.zeros((B, ocap), np.int32)
    for b in range(B):
        per = OpTensors(**{f.name: np.asarray(getattr(stacked, f.name))[:, b]
                           for f in dataclasses.fields(OpTensors)})
        sc = _prefill_scatter(per)
        if sc is None:
            continue
        oll[b, sc["ol"][0]] = sc["ol"][1].astype(np.uint32).view(np.int32)
        orl[b, sc["or"][0]] = sc["or"][1].astype(np.uint32).view(np.int32)
        rkl[b, sc["rank"][0]] = sc["rank"][1]
    return (np.ascontiguousarray(oll.T), np.ascontiguousarray(orl.T),
            np.ascontiguousarray(rkl.T))


def _order_capacity(ops: OpTensors, order_capacity: int, base: int) -> int:
    adv = np.asarray(ops.order_advance, dtype=np.int64).sum(axis=0)
    ocap = order_capacity or max(
        ((int(adv.max() + ops.lmax) + base + 7) // 8) * 8, 8)
    _require(ocap % 8 == 0, "order_capacity must be a multiple of 8")
    return ocap


def _rank_table(ops, ocap, rkl, B, dev):
    olld, orld, rkl0 = lane_tables(ops, ocap)
    if rkl is None:
        rkl = rkl0
    else:
        rkl = np.asarray(rkl.cpu() if isinstance(rkl, torch.Tensor) else rkl,
                         np.int32)
        _require(rkl.shape == (ocap, B),
                 f"rkl shape {rkl.shape} != ({ocap}, {B})")
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (olld, orld, rkl))


def _grow_table(t, ocap: int, B: int, dev, fill: int = TAB_UNKNOWN):
    """Pad a prior chunk's ``[ocap_old, B]`` table up to this chunk's
    ``ocap`` with ``fill`` (order spaces only grow)."""
    t = _as_i32(t, dev)
    _require(t.shape[0] <= ocap and t.shape[1] == B,
             f"table state shape {tuple(t.shape)} incompatible with "
             f"({ocap}, {B})")
    return _pad_rows(t, ocap, fill)


def _grow_state(state, capacity: int, ocap: int, B: int, dev):
    """Pad a prior chunk's un-blocked state 5-tuple up to this chunk's
    row and order capacities, on the device."""
    o0, l0, r0 = _grow_planes(state[:3], capacity, B, dev)
    return (o0, l0, r0, _grow_table(state[3], ocap, B, dev),
            _grow_table(state[4], ocap, B, dev))


def make_replayer_lanes_mixed(ops: OpTensors, capacity: int,
                              order_capacity: int = 0, chunk: int = 128,
                              init=None, rkl=None, device=None):
    """Stage a stacked per-doc MIXED stream (``stack_ops`` output: every
    column ``[S, B]``) for the un-blocked engine and return a function
    ``run(state=None) -> LanesMixedResult``.

    ``capacity`` counts run rows per document, ``order_capacity`` rows of
    by-order table (0 = fit this stream). ``init`` is a prior result's
    ``state()`` (the streaming warm start); None = empty documents.
    ``rkl`` overrides the rank table (``[OCAP, B]``). ``chunk`` pads the
    step count to a multiple of itself, as the JAX package's grid does."""
    dev = resolve_device(device)
    kinds = np.asarray(ops.kind)
    _require(kinds.ndim == 2, "rle_lanes_mixed takes stacked per-doc "
             "streams ([S, B] columns; see batch.stack_ops)")
    S, B = kinds.shape
    _require(capacity >= 8, "capacity must hold a few runs")
    wmax = fused_width(ops)
    _require(wmax + 1 < capacity,
             f"fused rows_per_step {wmax} cannot fit capacity {capacity}")
    s_pad = max(((S + chunk - 1) // chunk) * chunk, chunk)
    base = 0
    if init is not None and init[3] is not None:
        base = init[3].shape[0]
    ocap = _order_capacity(ops, order_capacity, base)
    staged = _stage(ops, s_pad, dev, OP_COLUMNS)
    deltas = _rank_table(ops, ocap, rkl, B, dev)
    start = [None if init is None
             else _grow_state(init, capacity, ocap, B, dev)]

    def initial():
        """The state a run without one starts from: ``init`` grown, or
        empty documents, allocated at first use (a stream's later chunks
        start from the prior chunk's state and never need one)."""
        if start[0] is None:
            start[0] = (
                torch.zeros(capacity, B, dtype=I32, device=dev),
                torch.zeros(capacity, B, dtype=I32, device=dev),
                torch.zeros(1, B, dtype=I32, device=dev),
                torch.full((ocap, B), TAB_UNKNOWN, dtype=I32, device=dev),
                torch.full((ocap, B), TAB_UNKNOWN, dtype=I32, device=dev))
        return start[0]

    ld = (kinds == KIND_LOCAL) & (np.asarray(ops.del_len) > 0)
    li = (kinds == KIND_LOCAL) & (np.asarray(ops.ins_len) > 0)
    shared_cum = (not bool(np.any(ld & li))
                  and _shared_cum_gate(ld.any(axis=1), li.any(axis=1),
                                       s_pad))
    shape = dict(wmax=wmax, shared_cum=shared_cum)

    def run(state=None) -> LanesMixedResult:
        ini = initial() if state is None else _grow_state(
            state, capacity, ocap, B, dev)
        ol, orr, ordp, lenp, rows, oll, orl, err = lanes_mixed_replay(
            *staged, *ini, *deltas, **shape)
        return LanesMixedResult(
            ordp=ordp, lenp=lenp, rows=rows, ol=ol[:S], orr=orr[:S],
            err=err, batch=B, oll=oll, orl=orl)

    run.staged = staged
    run.deltas = deltas
    run.initial = initial
    run.shape = shape
    run.capacity, run.order_capacity = capacity, ocap
    run.grow = lambda state: _grow_state(state, capacity, ocap, B, dev)
    return run


def replay_lanes_mixed(ops: OpTensors, capacity: int,
                       **kw) -> LanesMixedResult:
    """One-shot convenience wrapper over ``make_replayer_lanes_mixed``."""
    return make_replayer_lanes_mixed(ops, capacity, **kw)()


def _empty_mixed_blocked_state(capacity: int, NBT: int, ocap: int, B: int,
                               dev):
    def full(r, v):
        return torch.full((r, B), v, dtype=I32, device=dev)

    return (*_empty_blocked_state(capacity, NBT, B, dev), full(NBT, 0),
            full(ocap, TAB_UNKNOWN), full(ocap, TAB_UNKNOWN), full(ocap, -1),
            full(NBT, -1))


def _grow_mixed_blocked_state(state, capacity: int, block_k: int, ocap: int,
                              B: int, dev):
    """Pad a prior chunk's blocked 11-tuple up to this chunk's row and
    order capacities on the device (fixed K; NB and OCAP only grow):
    planes and slot tables with 0, ``oll/orl`` with −2, ``ordblk`` and
    ``fwd`` with −1."""
    o0, l0, nlog, blk, rws, liv = _grow_blocked_state(
        state[:6], capacity, block_k, B, dev)
    NBT = max(8, capacity // block_k)
    return (o0, l0, nlog, blk, rws, liv,
            _pad_rows(_as_i32(state[6], dev), NBT, 0),
            _grow_table(state[7], ocap, B, dev),
            _grow_table(state[8], ocap, B, dev),
            _grow_table(state[9], ocap, B, dev, -1),
            _pad_rows(_as_i32(state[10], dev), NBT, -1))


def make_replayer_lanes_mixed_blocked(
    ops: OpTensors,
    capacity: int,
    block_k: int = 64,
    order_capacity: int = 0,
    chunk: int = 128,
    init=None,
    rkl=None,
    device=None,
):
    """Stage a stacked per-doc MIXED stream for the BLOCKED engine and
    return ``run(state=None) -> BlockedLanesMixedResult``: bit-identical
    documents, YATA cursors and origins to ``make_replayer_lanes_mixed``.
    ``capacity`` must be a ``block_k`` multiple, ``init`` a prior blocked
    ``state()`` 11-tuple; otherwise the same contract."""
    dev = resolve_device(device)
    kinds = np.asarray(ops.kind)
    _require(kinds.ndim == 2, "rle_lanes_mixed takes stacked per-doc "
             "streams ([S, B] columns; see batch.stack_ops)")
    S, B = kinds.shape
    _require(block_k >= 8, "block_k must hold a few runs")
    _require(capacity % block_k == 0,
             f"capacity ({capacity}) must be a multiple of block_k "
             f"({block_k})")
    wmax = fused_width_checked([ops], block_k)
    s_pad = max(((S + chunk - 1) // chunk) * chunk, chunk)
    base = 0
    if init is not None and init[7] is not None:
        base = init[7].shape[0]
    ocap = _order_capacity(ops, order_capacity, base)
    staged = _stage(ops, s_pad, dev, OP_COLUMNS)
    deltas = _rank_table(ops, ocap, rkl, B, dev)
    NBT = max(8, capacity // block_k)
    start = [None if init is None else _grow_mixed_blocked_state(
        init, capacity, block_k, ocap, B, dev)]

    def initial():
        """The state a run without one starts from, allocated at first
        use (as for the un-blocked engine)."""
        if start[0] is None:
            start[0] = _empty_mixed_blocked_state(capacity, NBT, ocap, B, dev)
        return start[0]

    shape = dict(block_k=block_k, wmax=wmax)

    def run(state=None) -> BlockedLanesMixedResult:
        ini = initial() if state is None else _grow_mixed_blocked_state(
            state, capacity, block_k, ocap, B, dev)
        (ol, orr, ordp, lenp, nlog, blk, rws, liv, raw, oll, orl, ordblk,
         fwd, err) = lanes_mixed_blocked_replay(*staged, *ini, *deltas,
                                                **shape)
        return BlockedLanesMixedResult(
            ordp=ordp, lenp=lenp, nlog=nlog, blkord=blk, rws=rws, liv=liv,
            raw=raw, oll=oll, orl=orl, ordblk=ordblk, fwd=fwd, ol=ol[:S],
            orr=orr[:S], err=err, batch=B, block_k=block_k)

    run.staged = staged
    run.deltas = deltas
    run.initial = initial
    run.shape = shape
    run.capacity, run.order_capacity, run.nbt = capacity, ocap, NBT
    run.grow = lambda state: _grow_mixed_blocked_state(
        state, capacity, block_k, ocap, B, dev)
    return run


def replay_lanes_mixed_blocked(ops: OpTensors, capacity: int,
                               **kw) -> BlockedLanesMixedResult:
    """One-shot wrapper over ``make_replayer_lanes_mixed_blocked``."""
    return make_replayer_lanes_mixed_blocked(ops, capacity, **kw)()
