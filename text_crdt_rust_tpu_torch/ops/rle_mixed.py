"""Mixed-stream RLE run replay on PyTorch and CUDA: remote ops on RUN rows
(counterpart of ``text_crdt_rust_tpu/ops/rle_mixed.py``).

``ops.rle`` replays local edits on RLE run blocks. This engine applies
the full op surface of one shared stream to the same run representation:
``KIND_LOCAL`` edits, ``KIND_REMOTE_INS`` (YATA integrate with the
name-rank tiebreak, `doc.rs:167-234`) and ``KIND_REMOTE_DEL`` (interval
tombstones, concurrent double deletes included, `doc.rs:295-340`).

What the remote paths add on top of ``ops.rle``'s block grid:

- a RAW per-slot count (``raw``/``cumraw``) next to the live one: remote
  cursors count tombstones (`doc.rs:452`);
- an order -> physical-block HINT table (``ordblk``, 128 orders per
  row): splits leave it stale, lookups verify the hinted block and fall
  back to one full-plane search, then heal the entry;
- by-order origin/rank tables (``oll``/``orl`` mutable, ``rkl``
  read-only), prefilled on the host by ``batch.prefill_logs``;
- four per-run aux planes: ``olp``/``orp``/``rkp`` hold each run head's
  origin-left, origin-right and rank, ``lpp`` each physical row's
  logical slot (the doc-order key of the vectorised YATA scan);
- run-level YATA integrate: ``integrate_fast`` classifies every run of
  the scan window in one pass; when a window shape defeats it (``flag``)
  the exact serial run-walk ``integrate_cursor`` decides;
- one-pass remote delete: runs are disjoint order intervals, so a target
  range fully covers every run it touches but the (at most) two holding
  its endpoints: flip the full covers plane-wide, split the endpoints.

Two implementations, held against each other bit for bit:

- ``rle_mixed_replay_plain``: plain PyTorch, vectorised over lanes on
  ``[CAP, B]`` planes with lane-max control scalars, as the Pallas body
  ``_mixed_rle_kernel`` is;
- ``ops/csrc/rle_mixed_replay.cu``: the hand-written CUDA kernel, one
  thread block per lane, one warp running the step chain.

``rle_mixed_replay`` picks between them by the device of its inputs (the
plain version for CPU tensors, the kernel for CUDA tensors; it never
falls back). Results keep the JAX layout: ``ol``/``orr`` ``[S_pad, B]``
u32 bits, ``ordp``/``lenp`` ``[CAP, B]``, ``blkord``/``rows``
``[1, NBLp, B]``, ``meta`` ``[1, 8, B]`` (row 0: blocks in use) and
``err`` ``[8, B]`` (0: block capacity, 1: bad delete, 2: order-index
miss), all int32.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from . import _kernels
from .batch import (
    KIND_LOCAL,
    KIND_REMOTE_DEL,
    KIND_REMOTE_INS,
    OpTensors,
    prefill_logs,
    require_unfused,
)
from .blocked import _cumsum_rows, _lane_scalar, _require, _shift_rows
from .rle import (
    RleResult,
    _delete_block_math,
    _insert_splice,
    _locate_run,
    _row_scalar,
    _shift_rows_up,
    _split_piece_aux,
)
from .span_arrays import make_flat_doc

I32 = torch.int32
LANES = 128  # orders per by-order table row
ROOT_I = -1  # ROOT_ORDER as int32


def _locate_run_raw(bo, bl, idx_k, r0: int, local: int):
    """Raw-position twin of ``rle._locate_run``: the run containing RAW
    char #``local`` (1-based, tombstones counted). Returns ``(i_r, o_r,
    l_r, off)`` with ``off`` the 1-based char offset."""
    cum = _cumsum_rows(bl)
    i_r = _lane_scalar(((cum < local) & (idx_k < r0)).to(I32))
    o_r = _row_scalar(bo, i_r)
    l_r = _row_scalar(bl, i_r)
    off = local - (_row_scalar(cum, i_r) - l_r)
    return i_r, o_r, l_r, off


def _insert_splice_raw(bo, bl, idx_k, c: int, i_r: int, o_r: int, l_r: int,
                       off: int, il: int, st: int, o_left: int):
    """Raw-position twin of ``rle._insert_splice``: splice a new LIVE run
    (orders ``st..st+il``) at raw position ``c`` of a block. The split
    run may be a tombstone (its tail keeps the sign: ``o_r - off``), and
    the merge path also needs the previous run live and the op's
    ``origin_left`` chained to that run's last char (`span.rs:47-53`):
    merging an unchained run would hide a char from the YATA scan, which
    evaluates run heads only. Returns ``(no, nl, amt, mrg, is_split)``."""
    mrg = (c > 0 and o_r > 0 and off == l_r and st + 1 == o_r + l_r
           and o_left == o_r + l_r - 2)
    is_split = c > 0 and off < l_r
    ins_at = 0 if c == 0 else i_r + 1
    amt = 0 if mrg else (2 if is_split else 1)
    so = _shift_rows(bo, amt, 2)
    sl = _shift_rows(bl, amt, 2)
    keep = idx_k < ins_at
    no = torch.where(keep, bo, so)
    nl = torch.where(keep, bl, sl)
    if is_split:
        nl = torch.where(idx_k == i_r, off, nl)
        tail = idx_k == ins_at + 1
        no = torch.where(tail, o_r + off if o_r > 0 else o_r - off, no)
        nl = torch.where(tail, l_r - off, nl)
    if mrg:
        nl = torch.where(idx_k == i_r, l_r + il, nl)
    else:
        new_run = idx_k == ins_at
        no = torch.where(new_run, st + 1, no)
        nl = torch.where(new_run, il, nl)
    return no, nl, amt, mrg, is_split


class RleMixedResult(RleResult):
    """``RleResult`` plus the order-index error flag (err row 2)."""

    def check(self) -> None:
        super().check()
        if self.err[2].max() != 0:
            raise RuntimeError(
                "order index lookup missed: an op referenced an order "
                "absent from device state (corrupt stream or engine bug)")


# -- the plain replay -----------------------------------------------------------


class _PlainMixed:
    """The Pallas body's scratch and helpers over ``[CAP, B]`` planes. Each
    method mirrors the kernel function of the same name; control scalars
    are Python ints (lane-max of lane-replicated values)."""

    def __init__(self, B, K, NB, NBL, OT, oll, orl, rkl, fast, dev):
        CAP = K * NB
        self.K, self.NB, self.NBL, self.CAP, self.OT = K, NB, NBL, CAP, OT
        self.fast = fast
        self.idx_k = torch.arange(K, dtype=I32, device=dev)[:, None]
        self.idx_l = torch.arange(NBL, dtype=I32, device=dev)[:, None]
        self.rib = (torch.arange(CAP, dtype=I32, device=dev) % K)[:, None]
        self.blk_of_row = (torch.arange(CAP, dtype=I32, device=dev)
                           // K)[:, None]
        self.idx_cap = torch.arange(CAP, dtype=I32, device=dev)[:, None]

        def z(n):
            return torch.zeros(n, B, dtype=I32, device=dev)

        self.ordp, self.lenp = z(CAP), z(CAP)
        self.olp, self.orp, self.rkp, self.lpp = z(CAP), z(CAP), z(CAP), z(CAP)
        self.blkord, self.rws = z(NBL), z(NBL)
        self.liv, self.raw, self.cumliv, self.cumraw = (z(NBL), z(NBL),
                                                        z(NBL), z(NBL))
        self.err = z(8)
        self.ordblk = torch.zeros(OT * LANES, dtype=I32, device=dev)
        self.oll, self.orl, self.rkl = oll.clone(), orl.clone(), rkl
        self.nlog = 1  # logical blocks in use

    # -- blocks and slots ------------------------------------------------

    def block(self, plane, b):
        return plane[b * self.K:(b + 1) * self.K]

    def store(self, plane, b, value):
        plane[b * self.K:(b + 1) * self.K] = value

    def slot_scalar(self, tbl, l):
        return int(tbl[l].max()) if 0 <= l < self.NBL else 0

    def sum_before_slot(self, tbl, l):
        return _lane_scalar(torch.where(self.idx_l < l, tbl, 0))

    def total_of(self, cum):
        return self.slot_scalar(cum, self.nlog - 1)

    def slot_of_cum(self, cum, rank1):
        """Smallest logical slot whose inclusive prefix reaches ``rank1``;
        slots >= nlog may hold stale prefixes and are masked."""
        hit = (cum < rank1) & (self.idx_l < self.nlog)
        return min(_lane_scalar(hit.to(I32)), self.nlog - 1)

    def logical_of_physical(self, b):
        hit = (self.blkord == b) & (self.idx_l < self.nlog)
        return int(torch.where(hit, self.idx_l, 0).max())

    def split(self, l):
        """Leaf split: the top half of slot ``l``'s rows moves to a fresh
        physical block at logical slot ``l+1``. At table capacity it is a
        no-op that raises ``err[0]``. ``ordblk`` entries of moved rows go
        stale; lookups heal them."""
        if self.nlog >= self.NB:
            self.err[0] = 1
            return
        K, idx_k, idx_l = self.K, self.idx_k, self.idx_l
        b = self.slot_scalar(self.blkord, l)
        r = self.slot_scalar(self.rws, l)
        keep = r // 2
        mv = r - keep
        nb = self.nlog  # fresh physical block id
        bo = self.block(self.ordp, b).clone()
        bl = self.block(self.lenp, b).clone()
        hi_mask = (idx_k >= keep) & (idx_k < r)
        liv_hi = _lane_scalar(torch.where(hi_mask & (bo > 0), bl, 0))
        raw_hi = _lane_scalar(torch.where(hi_mask, bl, 0))
        liv_lo = self.slot_scalar(self.liv, l) - liv_hi
        raw_lo = self.slot_scalar(self.raw, l) - raw_hi
        new_mask = idx_k < mv
        keep_mask = idx_k < keep
        # Aux planes move with their rows (a block split never changes a
        # run's head char).
        for plane in (self.ordp, self.lenp, self.olp, self.orp, self.rkp):
            x = self.block(plane, b).clone()
            self.store(plane, nb,
                       torch.where(new_mask, _shift_rows_up(x, keep, K), 0))
            self.store(plane, b, torch.where(keep_mask, x, 0))
        # Logical positions: slots after l shift one down, block nb lands
        # at l + 1. LOAD-BEARING: lpp rows past a block's row count are
        # deliberately NOT zeroed. lpp is per physical row, whole-block:
        # when a later insert validates such a row, it must already hold
        # its block's slot, since the fast scan's window keys read lpp
        # for every valid row.
        lpp = torch.where(self.lpp > l, self.lpp + 1, self.lpp)
        self.lpp = torch.where(self.blk_of_row == nb, l + 1, lpp)
        for name in ("blkord", "rws", "liv", "raw", "cumliv", "cumraw"):
            tbl = getattr(self, name)
            setattr(self, name,
                    torch.where(idx_l <= l, tbl, _shift_rows(tbl, 1, 1)))
        self.rws[l] = keep
        self.liv[l] = liv_lo
        self.raw[l] = raw_lo
        self.cumliv[l] -= liv_hi
        self.cumraw[l] -= raw_hi
        self.blkord[l + 1] = nb
        self.rws[l + 1] = mv
        self.liv[l + 1] = liv_hi
        self.raw[l + 1] = raw_hi
        self.nlog += 1

    # -- order -> run lookup ---------------------------------------------

    def find_in_block(self, b, o):
        """(found, row) of the run CONTAINING order ``o`` in block ``b``."""
        bo = self.block(self.ordp, b)
        bl = self.block(self.lenp, b)
        so = bo.abs() - 1
        hit = (bo != 0) & (so <= o) & (o < so + bl)
        found = _lane_scalar(hit.to(I32)) > 0
        row = int(torch.where(hit, self.idx_k, self.K).min(dim=0)
                  .values.max())
        return found, row

    def locate_order(self, o):
        """(physical block, row) of the run containing order ``o``: the
        ``ordblk`` hint, verified; else one full-plane search; then the
        hint is healed. A negative ``o`` looks up order 0 and neither
        raises the miss flag nor heals."""
        oc = max(o, 0)
        bh = min(max(int(self.ordblk[oc]), 0), self.NB - 1)
        found, row = self.find_in_block(bh, oc)
        if found:
            b = bh
        else:
            so = self.ordp.abs() - 1
            hit = (self.ordp != 0) & (so <= oc) & (oc < so + self.lenp)
            g = int(torch.where(hit, self.idx_cap, self.CAP - 1)
                    .min(dim=0).values.max())
            if _lane_scalar(hit.to(I32)) == 0 and o >= 0:
                self.err[2] = 1
            b, row = g // self.K, g % self.K
        if o >= 0:
            self.ordblk[oc] = b
        return b, row

    def pos_of_order(self, o):
        """RAW document position of the char with order ``o``."""
        b, row = self.locate_order(o)
        l = self.logical_of_physical(b)
        bl = self.block(self.lenp, b)
        raw_before = _lane_scalar(torch.where(self.idx_k < row, bl, 0))
        so_row = abs(_row_scalar(self.block(self.ordp, b), row)) - 1
        return self.sum_before_slot(self.raw, l) + raw_before + (o - so_row)

    def cursor_after(self, o):
        # The Pallas body evaluates the ROOT arm too; its lookup has no
        # side effect for o < 0, so skipping it changes nothing.
        return 0 if o == ROOT_I else self.pos_of_order(o) + 1

    # -- shared insert upkeep --------------------------------------------

    def record_insert(self, k, b, st, il, left, right, ol, orr):
        """Index and origin-table upkeep plus the op's origin outputs."""
        self.ordblk[st:st + il] = b
        self.oll[st] = left
        self.orl[st:st + il] = right
        ol[k] = left
        orr[k] = right

    def aux_splice(self, b, i_r, ins_at, amt, mrg, is_split, tail_ol,
                   new_ol, new_or, new_rk):
        """Mirror an insert splice's row motion onto block ``b`` of the aux
        planes: rows >= ``ins_at`` shift down by ``amt``, the new run takes
        the op's (origin-left, origin-right, rank), and a split tail
        chains to its predecessor char. The tail's origin-right is read
        from ``orl`` (exact once written), not poisoned."""
        idx_k = self.idx_k
        t_rk = _row_scalar(self.block(self.rkp, b), i_r)
        t_or = int(self.orl[min(max(tail_ol + 1, 0), self.OT * LANES - 1)])
        new_run = (idx_k == ins_at) & (not mrg)
        tail = (idx_k == ins_at + 1) & is_split
        for plane, nv, tv in ((self.olp, new_ol, tail_ol),
                              (self.orp, new_or, t_or),
                              (self.rkp, new_rk, t_rk)):
            a = self.block(plane, b)
            na = torch.where(idx_k < ins_at, a, _shift_rows(a, amt, 2))
            na = torch.where(new_run, nv, na)
            na = torch.where(tail, tv, na)
            self.store(plane, b, na)

    def grow_slot(self, l, amt, il):
        self.rws[l] += amt
        self.liv[l] += il
        self.raw[l] += il
        self.cumliv[l:] += il
        self.cumraw[l:] += il

    # -- local ops (the ops.rle paths + raw/index/table upkeep) -----------

    def find_insert_slot(self, p):
        l = 0 if p == 0 else self.slot_of_cum(self.cumliv, p)
        return l, self.slot_scalar(self.rws, l)

    def do_local_insert(self, k, p, il, st, ol, orr):
        K, idx_k = self.K, self.idx_k
        l, r0 = self.find_insert_slot(p)
        if r0 + 2 > K:
            self.split(l)
        l, r0 = self.find_insert_slot(p)
        b = self.slot_scalar(self.blkord, l)
        local = p - self.sum_before_slot(self.liv, l)
        bo = self.block(self.ordp, b).clone()
        bl = self.block(self.lenp, b).clone()
        i_r, o_r, l_r, off = _locate_run(bo, bl, idx_k, r0, local)
        no, nl, amt, mrg, is_split = _insert_splice(
            bo, bl, idx_k, p, i_r, o_r, l_r, off, il, st)
        left = ROOT_I if p == 0 else (o_r - 1) + (off - 1)
        # Raw successor (`doc.rs:452`: tombstones not skipped), read from
        # the PRE-splice block.
        if p == 0:
            succ = _row_scalar(bo, 0) if r0 > 0 else 0
        elif is_split:
            succ = o_r + off
        elif i_r + 1 < r0:
            succ = _row_scalar(bo, i_r + 1)
        elif l + 1 < self.nlog:
            b2 = self.slot_scalar(self.blkord, min(l + 1, self.NBL - 1))
            succ = int(self.ordp[b2 * K].max())
        else:
            succ = 0
        right = ROOT_I if succ == 0 else abs(succ) - 1
        self.aux_splice(b, i_r, 0 if p == 0 else i_r + 1, amt, mrg, is_split,
                        (abs(o_r) - 1) + off - 1, left, right,
                        int(self.rkl[st]))
        self.store(self.ordp, b, no)
        self.store(self.lenp, b, nl)
        self.grow_slot(l, amt, il)
        self.record_insert(k, b, st, il, left, right, ol, orr)

    def do_local_delete(self, p, d):
        """Tombstone ``d`` live chars after live rank ``p`` (raw counts
        are unchanged); stops after ``2*NBL`` block iterations."""
        K = self.K
        rem, iters = d, 0
        while rem > 0 and iters <= 2 * self.NBL:
            l = self.slot_of_cum(self.cumliv, p + 1)
            if self.slot_scalar(self.rws, l) + 2 > K:
                self.split(l)
            l = self.slot_of_cum(self.cumliv, p + 1)
            b = self.slot_scalar(self.blkord, l)
            base = self.sum_before_slot(self.liv, l)
            aux_in = tuple(self.block(pl, b).clone()
                           for pl in (self.olp, self.orp, self.rkp))
            no, nl, added, tot, aux_out = _delete_block_math(
                self.block(self.ordp, b).clone(),
                self.block(self.lenp, b).clone(), self.idx_k, K, base, p,
                rem, aux=aux_in)
            for plane, na in zip((self.olp, self.orp, self.rkp), aux_out):
                self.store(plane, b, na)
            self.store(self.ordp, b, no)
            self.store(self.lenp, b, nl)
            self.rws[l] += added
            self.liv[l] -= tot
            self.cumliv[l:] -= tot
            rem -= tot
            iters += 1
        if rem > 0:
            self.err[1] = 1

    # -- remote insert (`doc.rs:274-293` -> integrate) --------------------

    def run_at2(self, c):
        """(logical slot, physical block, row, signed start order, length,
        0-based char offset) of the run holding RAW position ``c``."""
        l = self.slot_of_cum(self.cumraw, c + 1)
        b = self.slot_scalar(self.blkord, l)
        r0 = self.slot_scalar(self.rws, l)
        local = c - self.sum_before_slot(self.raw, l)
        bo = self.block(self.ordp, b)
        bl = self.block(self.lenp, b)
        cum = _cumsum_rows(bl)
        i_r = _lane_scalar(((cum <= local) & (self.idx_k < r0)).to(I32))
        o_r = _row_scalar(bo, i_r)
        l_r = _row_scalar(bl, i_r)
        off = local - (_row_scalar(cum, i_r) - l_r)
        return l, b, i_r, o_r, l_r, off

    def integrate_fast(self, cursor0, my_rank, o_left, o_right):
        """Vectorised YATA conflict scan: one classification pass over all
        run rows and three masked reductions. Sound when every run of the
        window is a direct SIBLING (head origin-left == the op's) or a
        PHYSICALLY-CHAINED piece (head chains to the previous row's last
        char); anything else raises ``flag`` for the serial walk.

          kfb = first sibling that breaks (rank > mine, same o_right)
          kll = last lower-ranked sibling before kfb
          kss = first higher-ranked different-o_right sibling after kll
          cursor = kss if it exists else kfb (else the o_right bound)
        """
        K = self.K
        BIGK = self.NBL * K + K  # past any valid doc-order key
        n = self.total_of(self.cumraw)
        tpos = n if o_right == ROOT_I else self.pos_of_order(o_right)
        l0, _b0, i0, o_r0, _l_r0, off0 = self.run_at2(cursor0)
        key_lo = l0 * K + i0 - (1 if off0 == 0 else 0)
        if tpos >= n:
            key_hi = BIGK
        else:
            lT, _bT, iT, _o, _l, offT = self.run_at2(tpos)
            key_hi = lT * K + iT + (0 if offT == 0 else 1)
        ordp, lenp, olp, orp, rkp = (self.ordp, self.lenp, self.olp,
                                     self.orp, self.rkp)
        key = self.lpp * K + self.rib
        W = (ordp != 0) & (key > key_lo) & (key < key_hi)
        h = ordp.abs() - 1
        S = W & (olp == o_left)
        # Row 0 of a block cannot verify adjacency (its predecessor row
        # lives in another block); the roll is circular, as on the TPU.
        e_prev = torch.roll(h + lenp - 1, 1, 0)
        chain = (W & ~S & (h > 0) & (olp == h - 1) & (self.rib > 0)
                 & (e_prev == h - 1))
        bad = (W & ~S & ~chain) | (S & ((rkp == my_rank) | (orp == -2)))
        gt_r = rkp > my_rank
        sgo = S & gt_r & (orp == o_right)
        sgn = S & gt_r & (orp != o_right)
        slt = S & ~gt_r
        kfb = int(torch.where(sgo, key, BIGK).min())
        kll = int(torch.where(slt & (key < kfb), key, -1).max())
        kss = int(torch.where(sgn & (key > kll) & (key < kfb), key,
                              BIGK).min())
        flag = bool(bad.any())

        # Mid-run window start: the char AT cursor0 chains to the op's
        # origin-left char, so it is a direct sibling; its origin-right
        # and rank come from the by-order tables (merge-appended chars
        # keep their own origin-right).
        pseudo = off0 > 0 and cursor0 < tpos
        kP = key_lo  # strictly below every window key
        if pseudo:
            order0 = min(max(abs(o_r0) - 1 + off0, 0), self.OT * LANES - 1)
            p_or = int(self.orl[order0])
            p_rk = int(self.rkl[order0])
            p_gt = p_rk > my_rank
            flag = flag or p_rk == my_rank
            if p_gt and p_or == o_right:
                kfb = kP
            if not p_gt and kP < kfb and kll < 0:
                kll = kP
            if p_gt and p_or != o_right and kll < kP < kfb:
                kss = kP
        # kss was reduced against the pre-pseudo kfb: compare with kfb.
        kwin = kss if kss < kfb else kfb
        if kwin >= BIGK:
            c = tpos
        elif kwin == kP:
            c = cursor0
        else:
            l_w = min(max(kwin // K, 0), self.NBL - 1)
            b_w = self.slot_scalar(self.blkord, l_w)
            c = self.sum_before_slot(self.raw, l_w) + _lane_scalar(
                torch.where(self.idx_k < kwin % K,
                            self.block(self.lenp, b_w), 0))
        return c, flag

    def integrate_cursor(self, cursor0, my_rank, o_left, o_right):
        """The exact YATA conflict scan (`doc.rs:183-222`) over RUNS, with
        the pinned-scan_start rule: each iteration consumes a whole run or
        jumps straight to ``o_right`` inside it."""
        left_cursor = cursor0
        n = self.total_of(self.cumraw)
        cursor, scanning, scan_start = cursor0, False, cursor0
        while cursor < n:
            _l, _b, _i, o_r, l_r, off = self.run_at2(cursor)
            so = abs(o_r) - 1
            other_order = so + off
            other_left = int(self.oll[other_order])
            other_right = int(self.orl[other_order])
            other_rank = int(self.rkl[other_order])
            olc = self.cursor_after(other_left)
            brk = other_order == o_right or olc < left_cursor
            eq = not brk and olc == left_cursor
            gt = my_rank > other_rank
            if eq and not gt:
                if o_right == other_right:
                    brk = True
                else:
                    if not scanning:
                        scan_start = cursor
                    scanning = True
            elif eq:
                scanning = False
            if brk:
                break
            if other_order < o_right < so + l_r:
                step = o_right - other_order
            else:
                step = l_r - off
            if step <= 0:  # corrupt state: stop instead of spinning
                self.err[2] = 1
                break
            cursor += step
        return scan_start if scanning else cursor

    def integrate_entry(self, my_rank, o_left, o_right):
        cursor0 = self.cursor_after(o_left)
        if not self.fast:
            return self.integrate_cursor(cursor0, my_rank, o_left, o_right)
        c, flag = self.integrate_fast(cursor0, my_rank, o_left, o_right)
        if flag:
            c = self.integrate_cursor(cursor0, my_rank, o_left, o_right)
        return c

    def do_remote_insert(self, k, my_rank, o_left, o_right, il, st, ol, orr):
        K = self.K
        c = self.integrate_entry(my_rank, o_left, o_right)
        l = 0 if c == 0 else self.slot_of_cum(self.cumraw, c)
        if self.slot_scalar(self.rws, l) + 2 > K:
            self.split(l)
        l = 0 if c == 0 else self.slot_of_cum(self.cumraw, c)
        b = self.slot_scalar(self.blkord, l)
        r0 = self.slot_scalar(self.rws, l)
        local = c - self.sum_before_slot(self.raw, l)
        bo = self.block(self.ordp, b).clone()
        bl = self.block(self.lenp, b).clone()
        i_r, o_r, l_r, off = _locate_run_raw(bo, bl, self.idx_k, r0, local)
        no, nl, amt, mrg, is_split = _insert_splice_raw(
            bo, bl, self.idx_k, c, i_r, o_r, l_r, off, il, st, o_left)
        self.aux_splice(b, i_r, 0 if c == 0 else i_r + 1, amt, mrg, is_split,
                        (abs(o_r) - 1) + off - 1, o_left, o_right, my_rank)
        self.store(self.ordp, b, no)
        self.store(self.lenp, b, nl)
        self.grow_slot(l, amt, il)
        self.record_insert(k, b, st, il, o_left, o_right, ol, orr)

    # -- remote delete (`doc.rs:295-340`) ---------------------------------

    def retire_endpoint(self, t, dlen, o):
        """Split the covered sub-range out of the run containing order
        ``o``: a no-op unless that run is LIVE and PARTIALLY covered."""
        K, idx_k = self.K, self.idx_k

        def facts(b, row):
            o_r = _row_scalar(self.block(self.ordp, b), row)
            l_r = _row_scalar(self.block(self.lenp, b), row)
            so = abs(o_r) - 1
            return o_r, l_r, so, max(t - so, 0), min(l_r, t + dlen - so)

        b, row = self.locate_order(o)
        l = self.logical_of_physical(b)
        o_r, l_r, so, a, e = facts(b, row)
        if not (o_r > 0 and (a > 0 or e < l_r) and e > a):
            return
        if self.slot_scalar(self.rws, l) + 2 > K:
            self.split(l)
        b2, row2 = self.locate_order(o)  # the split may have moved the run
        l2 = self.logical_of_physical(b2)
        o_r, l_r, so, a, e = facts(b2, row2)
        cov = e - a
        has_head = a > 0
        amt = int(has_head) + int(e < l_r)
        bo = self.block(self.ordp, b2).clone()
        bl = self.block(self.lenp, b2).clone()
        no = torch.where(idx_k <= row2, bo, _shift_rows(bo, amt, 2))
        nl = torch.where(idx_k <= row2, bl, _shift_rows(bl, amt, 2))
        # Part layout: [head?] [tombstone mid] [tail?].
        w0 = idx_k == row2
        no = torch.where(w0, o_r if has_head else -(so + a + 1), no)
        nl = torch.where(w0, a if has_head else cov, nl)
        w1 = (idx_k == row2 + 1) & (amt >= 1)
        no = torch.where(w1, -(so + a + 1) if has_head else so + e + 1, no)
        nl = torch.where(w1, cov if has_head else l_r - e, nl)
        w2 = (idx_k == row2 + 2) & (amt == 2)
        no = torch.where(w2, so + e + 1, no)
        nl = torch.where(w2, l_r - e, nl)
        self.store(self.ordp, b2, no)
        self.store(self.lenp, b2, nl)
        aux_out = _split_piece_aux(
            tuple(self.block(pl, b2).clone()
                  for pl in (self.olp, self.orp, self.rkp)),
            idx_k, row2, amt, w1, w2, so, a, e, has_head)
        for plane, na in zip((self.olp, self.orp, self.rkp), aux_out):
            self.store(plane, b2, na)
        self.rws[l2] += amt
        self.liv[l2] -= cov
        self.cumliv[l2:] -= cov

    def do_remote_delete(self, t, dlen):
        """One-pass order-interval tombstone: flip the full covers
        plane-wide, count already-dead covered runs toward the total
        (idempotent double deletes, `double_delete.rs:6-9`), then split
        the <= 2 live partial runs holding the endpoints."""
        K, NB = self.K, self.NB
        bo, bl = self.ordp, self.lenp
        so = bo.abs() - 1
        cs = torch.minimum(torch.clamp(t - so, min=0), bl)
        ce = torch.minimum(torch.clamp(t + dlen - so, min=0), bl)
        cov = torch.where(bo != 0, ce - cs, 0)
        if _lane_scalar(cov) < dlen:
            self.err[1] = 1
        full = (bo > 0) & (cov > 0) & (cov == bl)
        self.ordp = torch.where(full, -bo, bo)
        # Per-slot live counts drop by each physical block's flipped
        # chars, gathered to slots through blkord (stale slots included,
        # as on the TPU).
        flipped = torch.where(full, bl, 0).reshape(NB, K, -1).sum(
            dim=1, dtype=I32)
        g = torch.gather(flipped, 0, self.blkord.long())
        self.liv = self.liv - g
        self.cumliv = self.cumliv - _cumsum_rows(g)
        self.retire_endpoint(t, dlen, t + dlen - 1)
        self.retire_endpoint(t, dlen, t)


def rle_mixed_replay_plain(kind, pos, dlen, dtgt, olop, orop, rank, ilen,
                           start, oll, orl, rkl, *, steps: int, batch: int,
                           capacity: int, block_k: int, order_rows: int,
                           fast: bool):
    """The plain PyTorch version of ``_mixed_rle_kernel``: replay one
    shared op stream (nine int32 columns ``[steps]``) on ``batch``
    identical documents, with the by-order tables ``oll``/``orl``/``rkl``
    (int32 ``[order_rows*128]``). Returns ``(ol, orr, ordp, lenp, blkord,
    rows, meta, err)`` in the JAX layout, on the device of the inputs."""
    S, B, K = steps, batch, block_k
    NB = capacity // K
    NBL = max(8, NB)
    dev = kind.device
    state = _PlainMixed(B, K, NB, NBL, order_rows, oll, orl, rkl, fast, dev)
    ol = torch.zeros(S, B, dtype=I32, device=dev)
    orr = torch.zeros_like(ol)
    cols = [c.cpu().tolist() for c in (kind, pos, dlen, dtgt, olop, orop,
                                       rank, ilen, start)]
    for k in range(S):
        kd, p, d, tg, o_l, o_rt, rk, il, st = (c[k] for c in cols)
        if kd == KIND_LOCAL and d > 0:
            state.do_local_delete(p, d)
        if kd == KIND_LOCAL and il > 0:
            state.do_local_insert(k, p, il, st, ol, orr)
        if kd == KIND_REMOTE_INS and il > 0:
            state.do_remote_insert(k, rk, o_l, o_rt, il, st, ol, orr)
        if kd == KIND_REMOTE_DEL:
            state.do_remote_delete(tg, d)
    meta = torch.zeros(1, 8, B, dtype=I32, device=dev)
    meta[0, 0] = state.nlog
    return (ol, orr, state.ordp, state.lenp, state.blkord[None], state.rws[None],
            meta, state.err)


# -- the CUDA kernel ------------------------------------------------------------

_KERNEL = "rle_mixed_replay"
_LAUNCH = "rle_mixed_replay_launch"
_ARGTYPES = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 11
             + [ctypes.c_void_p])
#: Shared memory one thread block may use on an H100 (232,448 bytes).
SMEM_LIMIT = 232448
#: Per-lane counters of ``stats``: order lookups, hint misses, fast scans,
#: window blocks summed over the scans, the most blocks of one window,
#: serial walks, and the cycles (``clock64``) in the fast scans' window
#: passes, in order lookups, in splices and in the whole chain.
STATS = 10


def pick_warps(lanes: int, dev) -> int:
    """Warps of a thread block: warp 0 runs the step chain, the others help
    with the passes over a whole plane (a hint miss's search, the remote
    delete's flip). 16 while the lanes fit one to an SM, where the helpers
    cost no residency; else 4 (``chip_smoke.py`` times 4, 8 and 16 warps
    on both config-4 storms, 128 lanes: 16 is fastest)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return 16 if lanes <= sms else 4


def kernel_smem_bytes(block_k: int, nb: int, nbl: int, capacity: int):
    """``(bytes, planes)`` of one thread block: the six slot tables, two
    K-row delete scratch rows, the per-block flip counts and 40 ints of
    job arguments and results, plus as many of the five planes a splice
    moves as fit beside them: all five, else the run planes (``ordp``,
    ``lenp``), else none (the layout of ``rle_mixed_replay_kernel``'s
    ``smem``)."""
    tables = 4 * (6 * nbl + 2 * block_k + nb + 40)
    for planes in (5, 2, 0):
        if tables + 4 * planes * capacity <= SMEM_LIMIT:
            return tables + 4 * planes * capacity, planes
    return tables, 0


def rle_mixed_replay_cuda(kind, pos, dlen, dtgt, olop, orop, rank, ilen,
                          start, oll, orl, rkl, *, steps: int, batch: int,
                          capacity: int, block_k: int, order_rows: int,
                          fast: bool, warps: Optional[int] = None,
                          stats=None):
    """Launch ``ops/csrc/rle_mixed_replay.cu`` on PyTorch's current
    stream. Same arguments and results as ``rle_mixed_replay_plain``.
    ``warps`` sizes the thread block (1-16; by default ``pick_warps``);
    ``stats``, an int64 ``[batch, STATS]`` tensor on the card, receives
    each lane's counters."""
    S, B, CAP, K = steps, batch, capacity, block_k
    NB = CAP // K
    NBL = max(8, NB)
    OTL = order_rows * LANES
    dev = kind.device
    cols = (kind, pos, dlen, dtgt, olop, orop, rank, ilen, start)
    for c in cols:
        _require(c.device == dev and c.dtype == I32 and c.is_contiguous()
                 and c.shape == (S,),
                 "op columns must be contiguous int32 [S] on one device")
    for t in (oll, orl, rkl):
        _require(t.device == dev and t.dtype == I32 and t.is_contiguous()
                 and t.shape == (OTL,),
                 "order tables must be contiguous int32 [OT*128]")
    _require(K >= 8, "block_k must be at least 8")
    if warps is None:
        warps = pick_warps(B, dev)
    _require(1 <= warps <= 16, "warps must lie in [1, 16]")
    _require(stats is None or (stats.device == dev
                               and stats.dtype == torch.int64
                               and stats.is_contiguous()
                               and stats.shape == (B, STATS)),
             f"stats must be a contiguous int64 [{B}, {STATS}] on the card")
    smem, nsm = kernel_smem_bytes(K, NB, NBL, CAP)
    _require(smem <= SMEM_LIMIT,
             f"the slot tables of {NB} blocks and {K}-row delete scratch "
             f"need {smem} B of shared memory (limit {SMEM_LIMIT})")
    ol = torch.zeros(S, B, dtype=I32, device=dev)
    orr = torch.zeros_like(ol)
    ordp = torch.empty(CAP, B, dtype=I32, device=dev)
    lenp = torch.empty_like(ordp)
    blk_out = torch.empty(1, NBL, B, dtype=I32, device=dev)
    rows_out = torch.empty_like(blk_out)
    meta_out = torch.empty(1, 8, B, dtype=I32, device=dev)
    err = torch.zeros(8, B, dtype=I32, device=dev)
    # Lane-major working planes in device memory (those of ordp, lenp,
    # olp, orp, rkp that do not fit in shared memory; at least one, so
    # that the pointer is valid) and the lane-private mutable order tables
    # (ordblk, oll, orl).
    planes = torch.empty(max(5 - nsm, 1), B, CAP, dtype=I32, device=dev)
    tables = torch.empty(3, B, OTL, dtype=I32, device=dev)
    fn = _kernels.function(_KERNEL, _LAUNCH, _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tensors = (*cols, oll, orl, rkl, ol, orr, ordp, lenp, blk_out, rows_out,
               meta_out, err, planes, tables)
    code = fn(*(t.data_ptr() for t in tensors),
              None if stats is None else stats.data_ptr(), S, B, CAP, K, NB,
              NBL, OTL, int(fast), nsm, warps, smem, stream)
    _kernels.check(_KERNEL, code)
    _kernels.count_launch(_KERNEL)
    return ol, orr, ordp, lenp, blk_out, rows_out, meta_out, err


def rle_mixed_replay(*cols, **shape):
    """The replay on the device of its inputs: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    dev = cols[0].device
    if dev.type == "cpu":
        return rle_mixed_replay_plain(*cols, **shape)
    if dev.type == "cuda":
        return rle_mixed_replay_cuda(*cols, **shape)
    raise ValueError(f"no replay for device {dev}")


# -- the replayer -----------------------------------------------------------------


def make_replayer_rle_mixed(
    ops: OpTensors,
    capacity: int,
    batch: int = 128,
    block_k: int = 256,
    chunk: int = 1024,
    fast_integrate: bool = True,
    device=None,
):
    """Stage a mixed local/remote op stream on the RUN representation and
    return a function of no arguments that replays it into ``batch``
    identical documents and returns an ``RleMixedResult``.

    ``capacity`` counts RUN rows. Remote deletes of any length apply in
    one step; insert chunks must be <= 128 chars (the order-table write
    window). ``chunk`` pads the step count to a multiple of itself, as
    the JAX package's grid does. ``fast_integrate=False`` runs the exact
    serial YATA walk alone."""
    dev = resolve_device(device)
    kinds = np.asarray(ops.kind)
    _require(kinds.ndim == 1, "rle-mixed engine takes one shared stream")
    require_unfused(ops, "the rle-mixed engine")
    _require(capacity % block_k == 0,
             f"capacity ({capacity}) must be a multiple of block_k "
             f"({block_k})")
    _require(chunk >= 1, "chunk must be positive")
    NB = capacity // block_k
    _require(NB >= 1, "need at least one block")
    _require(block_k >= 8, "block_k must hold a few runs")
    _require(ops.lmax <= LANES, (
        f"insert chunks must be <= {LANES} chars for the order-table "
        f"window (compile with lmax<={LANES})"))

    # By-order tables: every order of the stream plus one insert's slack,
    # 128 orders a row, one spare tail row for the 2-row run writes,
    # rounded up to 8 rows (the JAX package's rule).
    total_orders = int(np.asarray(ops.order_advance, dtype=np.int64).sum())
    ocap = max(total_orders + ops.lmax, LANES)
    OT = (ocap + LANES - 1) // LANES + 1
    OT = ((OT + 7) // 8) * 8
    doc0 = prefill_logs(make_flat_doc(8, OT * LANES, device=dev), ops)
    tables = (doc0.ol_log, doc0.or_log, doc0.rank_log)

    s = ops.num_steps
    s_pad = max(((s + chunk - 1) // chunk) * chunk, chunk)

    def padded(a):
        a = np.asarray(a, dtype=np.uint32).view(np.int32)
        return torch.from_numpy(np.pad(a, (0, s_pad - s))).to(dev)

    staged = tuple(padded(c) for c in (
        ops.kind, ops.pos, ops.del_len, ops.del_target, ops.origin_left,
        ops.origin_right, ops.rank, ops.ins_len, ops.ins_order_start))
    staged = staged + tables
    shape = dict(steps=s_pad, batch=batch, capacity=capacity,
                 block_k=block_k, order_rows=OT, fast=fast_integrate)

    def run() -> RleMixedResult:
        ol, orr, ordp, lenp, blk, rows, meta, err = rle_mixed_replay(
            *staged, **shape)
        return RleMixedResult(
            ordp=ordp, lenp=lenp, blkord=blk[0], rows=rows[0], meta=meta[0],
            ol=ol[:s], orr=orr[:s], err=err,
            block_k=block_k, num_blocks=NB, batch=batch)

    run.staged = staged
    run.shape = shape
    return run


def replay_mixed_rle(ops: OpTensors, capacity: int, **kw) -> RleMixedResult:
    """One-shot convenience wrapper over ``make_replayer_rle_mixed``."""
    return make_replayer_rle_mixed(ops, capacity, **kw)()
