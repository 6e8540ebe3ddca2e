"""Per-lane divergent RLE replay on PyTorch and CUDA: B distinct documents,
each applying its OWN local edit stream, one op per document per step
(counterpart of ``text_crdt_rust_tpu/ops/rle_lanes.py``).

This is the config-5 streaming shape: thousands of different documents,
each replaying its own fresh local edits, with the device state carried
from one chunk of the stream to the next (the warm start). Two engines,
bit-identical in documents and origins:

- the UN-BLOCKED engine (``_rle_lanes_kernel`` in the JAX package): each
  document is one run column ``ordp/lenp`` ``[CAP, B]`` packed at the
  front, with ``rows`` ``[1, B]``. A delete is one flip + boundary-split
  pass over the whole column; an insert is a <= W+1-row splice;
- the BLOCKED engine (``_lanes_blocked_kernel``): runs live in K-row
  physical blocks ordered by per-lane logical tables (``blkord/rws/liv``
  ``[NBT, B]``, ``nlog`` ``[1, B]``); a step descends over the slot sums
  and splices one K-row block, splitting a full block into the logical
  order, and a delete walks block to block.

Each engine has two implementations, held against each other bit for bit:

- ``lanes_replay_plain`` / ``lanes_blocked_replay_plain``: plain PyTorch on
  ``[rows, B]`` tensors, a line-for-line translation of the Pallas bodies
  with every ``pl.when(jnp.any(..))`` a masked update;
- ``ops/csrc/rle_lanes.cu`` / ``ops/csrc/rle_lanes_blocked.cu``:
  hand-written CUDA kernels, one warp per document.

``lanes_replay`` / ``lanes_blocked_replay`` pick by the device of their
inputs: the plain version for CPU tensors, the kernel for CUDA tensors (it
launches or raises; it never falls back). Origins ride in int32 tensors
with the u32 bits.

The module also holds what the per-lane MIXED engines
(``ops/rle_lanes_mixed.py``) share with these: the lane-vector primitives
(``_vcumsum``, ``_vrow``, ``_vshift``, ``_live_prefix``, the W-row fused
splice), the SHARED_CUM gate, the state padding of growing streaming
chunks and the lane expansion to per-char state.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from . import _kernels
from .batch import (
    KIND_LOCAL,
    OpTensors,
    fused_width,
    fused_width_checked,
    merge_fused_origins,
    prefill_logs,
)
from .blocked import _require
from .span_arrays import FlatDoc, make_flat_doc

I32 = torch.int32
ROOT_I = -1  # ROOT_ORDER as int32

#: Names of the five staged op columns, in kernel argument order.
OP_COLUMNS = ("pos", "del_len", "ins_len", "ins_order_start",
              "rows_per_step")


# -- lane-vector primitives on [rows, B] tensors (plain versions) -------------


def _vcumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along rows, kept in int32 (wraps as the JAX
    roll-add scan does)."""
    return torch.cumsum(x, dim=0, dtype=x.dtype)


def _vrow(arr: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-lane row extraction: ``arr[r[0, b], b]`` as a ``[1, B]`` vector;
    a row outside ``[0, rows)`` reads 0 (the masked sum of the Pallas
    body)."""
    n = arr.shape[0]
    ok = (r >= 0) & (r < n)
    v = torch.gather(arr, 0, torch.where(ok, r, 0).long())
    return torch.where(ok, v, 0)


def _vshift(x: torch.Tensor, amt: torch.Tensor, max_amt: int = 2):
    """Rows shifted down by per-lane ``amt`` in ``[0, max_amt]``: one
    circular roll per bit, selected per lane, as the Pallas body's
    ``pltpu.roll`` blend is (the top rows wrap to the bottom)."""
    n = x.shape[0]
    out = x
    for bit in range(max(max_amt, 1).bit_length()):
        s = (1 << bit) % n
        if s:
            out = torch.where(((amt >> bit) & 1) != 0,
                              torch.roll(out, s, 0), out)
    return out


def _live_prefix(bo: torch.Tensor, bl: torch.Tensor):
    """(lv, cum): live char counts per run row and their inclusive prefix."""
    lv = torch.where(bo > 0, bl, 0)
    return lv, _vcumsum(lv)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _lsum(x):
    """Per-lane sum over rows as ``[1, B]`` int32."""
    return x.sum(dim=0, keepdim=True, dtype=I32)


def _lmin(x):
    return x.min(dim=0, keepdim=True).values


def _lmax(x):
    return x.max(dim=0, keepdim=True).values


def _fused_splice_lanes(bo, bl, idx, p, i_r, o_r, l_r, off, il, st, w,
                        wmax: int, act):
    """The W-row fused-splice arithmetic with a per-lane ``act`` mask
    (``rle.fused_splice_rows`` with ``active``): ``w`` run rows of stride
    ``L = il // w`` land in one circular shift. Returns ``(no, nl, amt,
    mrg, is_split, lrun)``."""
    lrun = _fdiv(il, torch.clamp(w, min=1))
    mrg = act & (w == 1) & (p > 0) & (off == l_r) & ((st + 1) == (o_r + l_r))
    is_split = act & (p > 0) & (off < l_r)
    dead = ~act | mrg
    ins_at = torch.where(p == 0, 0, i_r + 1)
    amt = torch.where(dead, 0, w + is_split.to(I32))
    so = _vshift(bo, amt, wmax + 1)
    sl = _vshift(bl, amt, wmax + 1)
    no = torch.where(idx < ins_at, bo, so)
    nl = torch.where(idx < ins_at, bl, sl)
    nl = torch.where(is_split & (idx == i_r), off, nl)
    new_run = act & (idx >= ins_at) & (idx < ins_at + w) & ~mrg
    no = torch.where(new_run, st + il - (idx - ins_at + 1) * lrun + 1, no)
    nl = torch.where(new_run, lrun, nl)
    tail = is_split & (idx == ins_at + w)
    no = torch.where(tail, o_r + off, no)
    nl = torch.where(tail, l_r - off, nl)
    nl = torch.where(mrg & (idx == i_r), l_r + il, nl)
    return no, nl, amt, mrg, is_split, lrun


def _shared_cum_gate(step_has_del, step_has_ins, s_pad: int) -> bool:
    """Hoist one live prefix per step iff it pays: sound only when no lane
    deletes AND inserts in the same step (callers check that separately),
    and worth it only when steps running BOTH local branches outnumber
    steps running NEITHER (padded no-op steps included)."""
    both = int((step_has_del & step_has_ins).sum())
    neither = int((~(step_has_del | step_has_ins)).sum())
    neither += s_pad - len(step_has_del)
    return both > neither


# -- the un-blocked engine, plain version ---------------------------------------


class _PlainLanes:
    """The un-blocked Pallas body over ``[CAP, B]`` planes; each method
    mirrors the kernel function of the same name."""

    def __init__(self, ord0, len0, rows0, S, wmax, dev):
        from . import lane_blocks  # it imports this module

        self.LB = lane_blocks
        CAP, B = ord0.shape
        self.CAP, self.WMAX = CAP, wmax
        self.idx = torch.arange(CAP, dtype=I32, device=dev)[:, None]
        self.ordp, self.lenp = ord0.clone(), len0.clone()
        self.rowsv = rows0.clone()
        self.err = torch.zeros(8, B, dtype=I32, device=dev)
        self.ol = torch.zeros(S, B, dtype=I32, device=dev)
        self.orr = torch.zeros(S, B, dtype=I32, device=dev)

    def flag(self, row, mask):
        self.err[row:row + 1] = torch.where(mask, 1, self.err[row:row + 1])

    def do_delete(self, p, d, lv=None, cum=None):
        """Whole-doc single-pass delete, per lane (active where d > 0)."""
        active = d > 0
        self.flag(0, active & (self.rowsv + 2 > self.CAP))
        bo, bl, idx = self.ordp, self.lenp, self.idx
        if cum is None:
            lv, cum = _live_prefix(bo, bl)
        before = cum - lv
        rem = torch.where(active, d, 0)
        cs = torch.minimum(torch.clamp(p - before, min=0), lv)
        ce = torch.minimum(torch.clamp(p + rem - before, min=0), lv)
        cov = ce - cs
        tot = _lsum(cov)
        self.flag(1, active & (tot < rem))
        full = (cov > 0) & (cov == bl)
        part = (cov > 0) & ~full
        npart = _lsum(part.to(I32))
        i1 = _lmin(torch.where(part, idx, self.CAP))
        i2 = _lmax(torch.where(part, idx, -1))
        bo = torch.where(full, -bo, bo)
        bo, bl, a2 = self.LB.lane_apply_partial(
            active & (npart >= 1), i2, bo, bl, cs, ce, idx)
        bo, bl, a1 = self.LB.lane_apply_partial(
            active & (npart == 2), i1, bo, bl, cs, ce, idx)
        self.ordp, self.lenp = bo, bl
        self.rowsv = self.rowsv + torch.where(active, a1 + a2, 0)

    def do_insert(self, k, p, il, st, w, lv=None, cum=None):
        """Per-lane W-row insert splice (active where il > 0). ``lv/cum``
        may be the step-hoisted pre-delete prefix (valid for this branch's
        lanes: no lane deletes and inserts in one step then)."""
        active = il > 0
        rows = self.rowsv
        self.flag(0, active & (rows + w + 1 > self.CAP))
        bo, bl, idx = self.ordp, self.lenp, self.idx
        if cum is None:
            lv, cum = _live_prefix(bo, bl)
        local = torch.where(active, p, 0)
        i_r = _lsum(((cum < local) & (idx < rows)).to(I32))
        o_r = _vrow(bo, i_r)
        l_r = _vrow(bl, i_r)
        off = local - (_vrow(cum, i_r) - _vrow(lv, i_r))
        left = torch.where(p == 0, ROOT_I, (o_r - 1) + (off - 1))
        no, nl, amt, _mrg, is_split, _lrun = _fused_splice_lanes(
            bo, bl, idx, p, i_r, o_r, l_r, off, il, st, w, self.WMAX, active)
        nxt_in_blk = _vrow(bo, i_r + 1)
        first_o = _vrow(bo, torch.zeros_like(i_r))
        succ_p0 = torch.where(rows > 0, first_o, 0)
        succ_after = torch.where(i_r + 1 < rows, nxt_in_blk, 0)
        succ = torch.where(p == 0, succ_p0,
                           torch.where(is_split, o_r + off, succ_after))
        right = torch.where(succ == 0, ROOT_I, succ.abs() - 1)
        self.ordp, self.lenp = no, nl
        self.rowsv = rows + amt
        self.ol[k:k + 1] = torch.where(active, left, 0)
        self.orr[k:k + 1] = torch.where(active, right, 0)


def lanes_replay_plain(pos, dlen, ilen, start, wcol, ord0, len0, rows0, *,
                       wmax: int, shared_cum: bool):
    """The plain PyTorch version of ``_rle_lanes_kernel``: replay five int32
    op columns ``[S, B]`` (one local stream per lane) from the warm-start
    state ``(ord0, len0, rows0)``. Returns ``(ol, orr, ordp, lenp, rows,
    err)`` in the JAX layout. ``shared_cum`` hoists one live prefix per
    step (the replayer allows it only when no lane deletes and inserts in
    one step, so it changes no result)."""
    S = pos.shape[0]
    st8 = _PlainLanes(ord0, len0, rows0, S, wmax, pos.device)
    for k in range(S):
        p, d, il, sto = pos[k:k + 1], dlen[k:k + 1], ilen[k:k + 1], \
            start[k:k + 1]
        w = torch.clamp(wcol[k:k + 1], min=1)  # pad rows carry 0
        lv = cum = None
        if shared_cum:
            lv, cum = _live_prefix(st8.ordp, st8.lenp)
        if bool((d > 0).any()):
            st8.do_delete(p, d, lv, cum)
        if bool((il > 0).any()):
            st8.do_insert(k, p, il, sto, w, lv, cum)
    return st8.ol, st8.orr, st8.ordp, st8.lenp, st8.rowsv, st8.err


# -- the blocked engine, plain version -------------------------------------------


class _PlainBlocked:
    """The blocked Pallas body over ``[K, B]`` blocks and ``[NBT, B]`` slot
    tables; each method mirrors the kernel function of the same name."""

    def __init__(self, state, S, K, wmax, dev):
        from . import lane_blocks  # it imports this module

        self.LB = lane_blocks
        ordp, lenp, nlog, blk, rws, liv = state
        CAP, B = ordp.shape
        self.K, self.NB, self.NBT, self.WMAX = K, CAP // K, blk.shape[0], wmax
        self.kdx = torch.arange(K, dtype=I32, device=dev)[:, None]
        self.tidx = torch.arange(self.NBT, dtype=I32, device=dev)[:, None]
        self.ordp, self.lenp = ordp.clone(), lenp.clone()
        # Fresh lanes hold one empty block in logical slot 0.
        self.nlogv = torch.clamp(nlog, min=1)
        self.blkord, self.rws, self.liv = blk.clone(), rws.clone(), liv.clone()
        self.cumliv = _vcumsum(liv)  # scratch, recomputed every launch
        self.err = torch.zeros(8, B, dtype=I32, device=dev)
        self.ol = torch.zeros(S, B, dtype=I32, device=dev)
        self.orr = torch.zeros(S, B, dtype=I32, device=dev)

    def flag(self, row, mask):
        self.err[row:row + 1] = torch.where(mask, 1, self.err[row:row + 1])

    def gather(self, plane, b):
        return self.LB.gather_block(plane, b, self.K, self.NB)

    def slot_of_live_rank(self, rank1):
        """Smallest logical slot whose cumulative live count reaches
        ``rank1``; slots at or past ``nlog`` are masked, and the result is
        capped at ``nlog - 1``."""
        nl = self.nlogv
        hit = (self.cumliv < rank1) & (self.tidx < nl)
        return torch.minimum(_lsum(hit.to(I32)), nl - 1)

    def live_before(self, l):
        return _vrow(self.cumliv, l) - _vrow(self.liv, l)

    def split(self, act, l):
        """Move the top half of slot ``l``'s rows to a fresh physical block
        at logical slot ``l + 1``; lanes at table capacity (``nlog >= NB``)
        raise err[0] and skip."""
        K, NB, kdx, tidx, LB = self.K, self.NB, self.kdx, self.tidx, self.LB
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
        liv_hi = _lsum(torch.where((kdx >= keep) & (kdx < r) & (ws_o > 0),
                                   ws_l, 0))
        up_o = LB.vshift_up(ws_o, keep, K)
        up_l = LB.vshift_up(ws_l, keep, K)
        LB.scatter_block2(self.ordp, b, torch.where(kdx < keep, ws_o, 0),
                          nbv, torch.where(kdx < mv, up_o, 0), do, K, NB)
        LB.scatter_block2(self.lenp, b, torch.where(kdx < keep, ws_l, 0),
                          nbv, torch.where(kdx < mv, up_l, 0), do, K, NB)
        for name in ("blkord", "rws", "liv", "cumliv"):
            tbl = getattr(self, name)
            setattr(self, name, torch.where(do & (tidx > l),
                                            torch.roll(tbl, 1, 0), tbl))
        w_l = do & (tidx == l)
        w_l1 = do & (tidx == l + 1)
        self.rws = torch.where(w_l, keep, torch.where(w_l1, mv, self.rws))
        self.liv = torch.where(w_l, self.liv - liv_hi,
                               torch.where(w_l1, liv_hi, self.liv))
        self.cumliv = torch.where(w_l, self.cumliv - liv_hi, self.cumliv)
        self.blkord = torch.where(w_l1, nbv, self.blkord)
        self.nlogv = self.nlogv + do.to(I32)

    def find_insert_slot(self, p):
        l = torch.where(p == 0, 0, self.slot_of_live_rank(p))
        return l, _vrow(self.rws, l)

    def do_insert(self, k, act, p, il, st, w):
        """Descend, split a full block, gather one block, splice <= w+1
        rows, scatter back."""
        K, NB, kdx, tidx, LB = self.K, self.NB, self.kdx, self.tidx, self.LB
        l, r0 = self.find_insert_slot(p)
        need = act & (r0 + w + 1 > K)
        if bool(need.any()):
            self.split(need, l)
            l, r0 = self.find_insert_slot(p)
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
        no, nl, amt, _mrg, is_split, _lrun = _fused_splice_lanes(
            ws_o, ws_l, kdx, p, i_r, o_r, l_r, off, il, st, w, self.WMAX, act)
        # Raw successor: next row of this block, else the head row of the
        # next logical slot's block.
        nxt_in_blk = _vrow(ws_o, i_r + 1)
        b2 = _vrow(self.blkord, torch.clamp(l + 1, max=self.NBT - 1))
        nxt_slot_o = LB.gather_head(self.ordp, b2, K, NB)
        zero = torch.zeros_like(l)
        first_o = LB.gather_head(self.ordp, _vrow(self.blkord, zero), K, NB)
        succ_p0 = torch.where(_vrow(self.rws, zero) > 0, first_o, 0)
        succ_after = torch.where(
            i_r + 1 < r0, nxt_in_blk,
            torch.where(l + 1 < self.nlogv, nxt_slot_o, 0))
        succ = torch.where(p == 0, succ_p0,
                           torch.where(is_split, o_r + off, succ_after))
        right = torch.where(succ == 0, ROOT_I, succ.abs() - 1)
        LB.scatter_block(self.ordp, b, no, act, K, NB)
        LB.scatter_block(self.lenp, b, nl, act, K, NB)
        w_l = act & (tidx == l)
        self.rws = torch.where(w_l, self.rws + amt, self.rws)
        self.liv = torch.where(w_l, self.liv + il, self.liv)
        self.cumliv = torch.where(act & (tidx >= l), self.cumliv + il,
                                  self.cumliv)
        self.ol[k:k + 1] = torch.where(act, left, 0)
        self.orr[k:k + 1] = torch.where(act, right, 0)

    def do_delete(self, act, p, d):
        """Per iteration each active lane clears its target block's covered
        span; lanes advance block to block. More than 2*NBT iterations
        without draining means the delete ran off its document."""
        K, NB, kdx, tidx, LB = self.K, self.NB, self.kdx, self.tidx, self.LB
        rem = torch.where(act, d, 0)
        iters = 0
        while bool((act & (rem > 0)).any()) and iters <= 2 * self.NBT:
            a = act & (rem > 0)
            l = self.slot_of_live_rank(p + 1)
            need = a & (_vrow(self.rws, l) + 2 > K)
            if bool(need.any()):
                self.split(need, l)
                l = self.slot_of_live_rank(p + 1)
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
            ws_o, ws_l, a2 = LB.lane_apply_partial(
                a & (npart >= 1), i2, ws_o, ws_l, cs, ce, kdx)
            ws_o, ws_l, a1 = LB.lane_apply_partial(
                a & (npart == 2), i1, ws_o, ws_l, cs, ce, kdx)
            LB.scatter_block(self.ordp, b, ws_o, a, K, NB)
            LB.scatter_block(self.lenp, b, ws_l, a, K, NB)
            w_l = a & (tidx == l)
            self.rws = torch.where(w_l, self.rws + a1 + a2, self.rws)
            self.liv = torch.where(w_l, self.liv - tot, self.liv)
            self.cumliv = torch.where(a & (tidx >= l), self.cumliv - tot,
                                      self.cumliv)
            rem = rem - torch.where(a, tot, 0)
            iters += 1
        self.flag(1, act & (rem > 0))


def lanes_blocked_replay_plain(pos, dlen, ilen, start, wcol, ord0, len0,
                               nlog0, blk0, rws0, liv0, *, block_k: int,
                               wmax: int):
    """The plain PyTorch version of ``_lanes_blocked_kernel``: replay five
    int32 op columns ``[S, B]`` from the warm-start 6-tuple ``(ord0, len0,
    nlog0, blk0, rws0, liv0)``. Returns ``(ol, orr, ordp, lenp, nlog,
    blkord, rws, liv, err)`` in the JAX layout."""
    S = pos.shape[0]
    st8 = _PlainBlocked((ord0, len0, nlog0, blk0, rws0, liv0), S, block_k,
                        wmax, pos.device)
    for k in range(S):
        p, d, il, sto = pos[k:k + 1], dlen[k:k + 1], ilen[k:k + 1], \
            start[k:k + 1]
        w = torch.clamp(wcol[k:k + 1], min=1)  # pad rows carry 0
        if bool((d > 0).any()):
            st8.do_delete(d > 0, p, d)
        if bool((il > 0).any()):
            st8.do_insert(k, il > 0, p, il, sto, w)
    return (st8.ol, st8.orr, st8.ordp, st8.lenp, st8.nlogv, st8.blkord,
            st8.rws, st8.liv, st8.err)


# -- the CUDA kernels -------------------------------------------------------------

_KERNEL = "rle_lanes"
_LAUNCH = "rle_lanes_launch"
# 5 op columns, 3 inputs, 6 outputs, the lane-major planes, stats; S, B,
# CAP, WMAX, warps, shared memory; the stream.
_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SCRATCH_PLANES = 2  # lane-major [B, CAP]: ordp, lenp
#: Per-document counters of ``stats``: the column's extent (1 + its last
#: nonzero row) at the start and at the end of the launch, and 1 if the
#: column ended the launch in shared memory.
STATS = 3
#: Shared memory one thread block may use on an H100 (232,448 bytes), one
#: SM's (233,472 bytes) and what the card keeps of an SM's for each
#: resident thread block (1,024 bytes).
SMEM_LIMIT = 232448
SMEM_PER_SM = 233472
SMEM_PER_BLOCK_RESERVED = 1024
#: Most documents (one warp each) in a thread block of the un-blocked
#: kernels (``rle_lanes.cu``, ``rle_lanes_mixed.cu``), and their default:
#: residency per SM is set by the columns' shared memory whatever their
#: grouping, and ``chip_smoke.py``'s sweep of 1, 2, 4 and 8 at config 5
#: and 5r finds no grouping faster by more than the runs' spread.
MAX_WARPS = 8
WARPS = 1
#: Fewest rows of a column the un-blocked kernels keep in shared memory
#: when a launch has too many documents for the card to hold at once.
MIN_ROWS_ON_CHIP = 512

_BKERNEL = "rle_lanes_blocked"
_BLAUNCH = "rle_lanes_blocked_launch"
# 5 op columns, 6 inputs, 9 outputs, the scratch, stats; S, B, CAP, K,
# NBT, WMAX, warps, on_chip; the stream.
_BARGTYPES = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
#: Per-document counters of the blocked kernel's ``stats``: steps with
#: work, deletes, delete iterations, inserts, splits, block copies, head
#: reads from device memory; ``clock64`` cycles in slot locates, in block
#: copies, in delete passes, in inserts' locates and splices, in
#: slot-table upkeep, in splits and in all steps; the blocks in use at the
#: end, and 1 if the document's rows were in shared memory.
BLOCKED_STATS = 16
#: Most documents (one warp each) in a thread block of the blocked kernel,
#: and the default where they fit.
BLOCKED_MAX_WARPS = 4
BLOCKED_WARPS = 4


def blocked_doc_bytes(capacity: int, nbt: int, on_chip: bool) -> int:
    """Shared memory of one document (warp) of the blocked kernel: its
    counters and its four slot tables, and with ``on_chip`` its
    ``capacity`` rows of both planes (``doc_ints`` in the kernel). No
    K-row scratch sits there: a block is edited where it lives."""
    return 4 * (2 * BLOCKED_STATS + 4 * nbt + (2 * capacity if on_chip
                                                else 0))


def blocked_on_chip(capacity: int, nbt: int) -> bool:
    """Where the blocked kernel keeps a document's rows by default: in
    shared memory where a document fits a thread block."""
    return blocked_doc_bytes(capacity, nbt, True) <= SMEM_LIMIT


def describe_blocked_stats(v) -> str:
    """The blocked kernel's counters ``v`` (summed over documents and
    launches) as a line of text."""
    steps, tot = max(int(v[0]), 1), max(int(v[13]), 1)
    names = ("slot locates", "block copies", "delete passes",
             "inserts' locates and splices", "slot-table upkeep", "splits")
    shares = ", ".join(f"{n} {int(v[7 + i]) / tot:.4f}"
                       for i, n in enumerate(names))
    return (f"{int(v[0])} steps with work, {int(v[1])} deletes "
            f"({int(v[2]) / max(int(v[1]), 1):.3f} iterations a delete), "
            f"{int(v[3])} inserts, {int(v[4])} splits; a step: "
            f"{int(v[5]) / steps:.3f} block copies, {int(v[6]) / steps:.3f} "
            f"head reads from device memory, {tot / steps:.0f} cycles; "
            f"cycle shares: {shares}; blocks in use at the ends of the "
            f"launches {int(v[14])}, documents with their rows in shared "
            f"memory {int(v[15])}")


def blocked_geometry(batch: int, capacity: int, nbt: int, warps: int,
                     on_chip: bool, dev) -> dict:
    """How the blocked kernel lays out ``batch`` documents at ``warps`` a
    thread block: a thread block's shared memory, the blocks an SM holds
    at once (the CUDA occupancy calculator) and the waves of blocks."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = _kernels.library(_BKERNEL).rle_lanes_blocked_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    per_sm = fn(warps, capacity, nbt, int(on_chip))
    n = -(-batch // warps)
    return dict(warps=warps, on_chip=on_chip,
                smem=warps * blocked_doc_bytes(capacity, nbt, on_chip),
                blocks_per_sm=per_sm,
                waves=-(-n // (per_sm * sms)) if per_sm > 0 else None)


def _check_cols(cols, dev, S, B, what="op columns"):
    for c in cols:
        _require(c.device == dev and c.dtype == I32 and c.is_contiguous()
                 and tuple(c.shape) == (S, B),
                 f"{what} must be contiguous int32 [{S}, {B}] on {dev}")


def pick_rows_on_chip(capacity: int, batch: int, warps: int,
                      sms: int) -> int:
    """Rows of each document's column that the un-blocked kernels keep in
    shared memory (8 bytes a row): all ``capacity`` rows where every
    document of the launch then fits the card's ``sms`` SMs at once;
    else, in whole 32-row groups, the largest count that does (at least
    ``MIN_ROWS_ON_CHIP``); never more than a thread block may hold. A
    column whose extent (1 + its last nonzero row) passes them, at the
    start or after a splice, works in the lane-major planes in device
    memory for the rest of the launch, with the same passes. A capacity
    is the stream's bound on rows; the extents at config 5 and 5r stay
    under a third of it (``chip_smoke.py`` prints them), so a bound sized
    for the worst case need not halve the documents an SM holds."""
    fit = SMEM_LIMIT // (8 * warps)
    blocks = -(-batch // warps)
    per_sm = -(-blocks // sms)
    share = (SMEM_PER_SM // per_sm - SMEM_PER_BLOCK_RESERVED) // (8 * warps)
    return min(capacity, fit, max(share // 32 * 32, MIN_ROWS_ON_CHIP))


def launch_geometry(kernel: str, batch: int, capacity: int, warps: int,
                    dev, rows_on_chip: Optional[int] = None) -> dict:
    """How un-blocked kernel ``kernel`` (``"rle_lanes"`` or
    ``"rle_lanes_mixed"``) lays out ``batch`` documents of ``capacity``
    rows at ``warps`` documents a thread block: the rows of each column
    in shared memory (by default ``pick_rows_on_chip``), a block's shared
    memory, the blocks an SM holds at once (the CUDA occupancy
    calculator) and the waves of blocks the launch takes."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if rows_on_chip is None:
        rows_on_chip = pick_rows_on_chip(capacity, batch, warps, sms)
    fn = getattr(_kernels.library(kernel), f"{kernel}_blocks_per_sm")
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    per_sm = fn(warps, rows_on_chip)
    blocks = (batch + warps - 1) // warps
    waves = -(-blocks // (per_sm * sms)) if per_sm > 0 else None
    return dict(rows_on_chip=rows_on_chip, warps=warps,
                smem=8 * rows_on_chip * warps, blocks_per_sm=per_sm,
                waves=waves)


def _launch_shape(warps, rows_on_chip, stats, B, CAP, n_stats, dev):
    """``(warps, rows_on_chip)`` of an un-blocked launch, checked, with
    the defaults filled in."""
    if warps is None:
        warps = WARPS
    _require(1 <= warps <= MAX_WARPS, f"warps must lie in [1, {MAX_WARPS}]")
    if rows_on_chip is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rows_on_chip = pick_rows_on_chip(CAP, B, warps, sms)
    _require(0 <= rows_on_chip <= CAP
             and 8 * rows_on_chip * warps <= SMEM_LIMIT,
             f"rows_on_chip must lie in [0, {CAP}] and fit "
             f"{SMEM_LIMIT} B of shared memory at {warps} warps")
    _require(stats is None or (stats.device == dev
                               and stats.dtype == torch.int64
                               and stats.is_contiguous()
                               and tuple(stats.shape) == (B, n_stats)),
             f"stats must be a contiguous int64 [{B}, {n_stats}] on the "
             f"card")
    return warps, rows_on_chip


def lanes_replay_cuda(pos, dlen, ilen, start, wcol, ord0, len0, rows0, *,
                      wmax: int, shared_cum: bool,
                      warps: Optional[int] = None,
                      rows_on_chip: Optional[int] = None, stats=None):
    """Launch ``ops/csrc/rle_lanes.cu`` on PyTorch's current stream. Same
    arguments and results as ``lanes_replay_plain`` (``shared_cum`` is the
    TPU's cost gate and changes no result). ``warps`` sets the documents
    of a thread block (1-8; by default ``WARPS``), ``rows_on_chip``
    the rows of each column kept in shared memory (0: none; by default
    ``pick_rows_on_chip``); ``stats``, an int64 ``[B, STATS]`` tensor on
    the card, receives each document's counters."""
    del shared_cum
    S, B = pos.shape
    CAP = ord0.shape[0]
    dev = pos.device
    cols = (pos, dlen, ilen, start, wcol)
    _check_cols(cols, dev, S, B)
    _check_cols((ord0, len0), dev, CAP, B, "run planes")
    _check_cols((rows0,), dev, 1, B, "rows")
    _require(S >= 1 and CAP >= 8 and wmax >= 1, "bad replay shape")
    warps, rows_on_chip = _launch_shape(warps, rows_on_chip, stats, B, CAP,
                                        STATS, dev)

    def out(r):
        return torch.empty(r, B, dtype=I32, device=dev)

    outs = (out(S), out(S), out(CAP), out(CAP), out(1), out(8))
    planes = torch.empty(_SCRATCH_PLANES, B, CAP, dtype=I32, device=dev)
    fn = _kernels.function(_KERNEL, _LAUNCH, _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tensors = (*cols, ord0, len0, rows0, *outs, planes)
    code = fn(*(t.data_ptr() for t in tensors),
              None if stats is None else stats.data_ptr(), S, B, CAP, wmax,
              warps, rows_on_chip, stream)
    _kernels.check(_KERNEL, code)
    _kernels.count_launch(_KERNEL)
    return outs


def lanes_blocked_replay_cuda(pos, dlen, ilen, start, wcol, ord0, len0,
                              nlog0, blk0, rws0, liv0, *, block_k: int,
                              wmax: int, warps: Optional[int] = None,
                              on_chip: Optional[bool] = None, stats=None):
    """Launch ``ops/csrc/rle_lanes_blocked.cu`` on PyTorch's current
    stream. Same arguments and results as ``lanes_blocked_replay_plain``.
    ``on_chip`` keeps each document's rows in shared memory for the
    launch (by default where a document fits a thread block), else in
    device memory; ``warps`` sets the documents of a thread block (1-4;
    by default ``BLOCKED_WARPS``, fewer where they would not fit);
    ``stats``, an int64 ``[B, BLOCKED_STATS]`` tensor on the card,
    receives each document's counters."""
    S, B = pos.shape
    CAP, NBT = ord0.shape[0], blk0.shape[0]
    K = block_k
    dev = pos.device
    cols = (pos, dlen, ilen, start, wcol)
    _check_cols(cols, dev, S, B)
    _check_cols((ord0, len0), dev, CAP, B, "run planes")
    _check_cols((nlog0,), dev, 1, B, "nlog")
    _check_cols((blk0, rws0, liv0), dev, NBT, B, "slot tables")
    _require(S >= 1 and K >= 8 and CAP % K == 0 and wmax >= 1,
             "bad replay shape")
    _require(NBT == max(8, CAP // K), "slot tables must hold max(8, NB) rows")
    if on_chip is None:
        on_chip = blocked_on_chip(CAP, NBT)
    per_doc = blocked_doc_bytes(CAP, NBT, on_chip)
    _require(per_doc <= SMEM_LIMIT,
             f"a document's slot tables ({NBT} rows)"
             f"{f' and {CAP} rows' if on_chip else ''} need {per_doc} B "
             f"of shared memory (limit {SMEM_LIMIT})")
    if warps is None:
        warps = max(1, min(BLOCKED_WARPS, SMEM_LIMIT // per_doc))
    _require(1 <= warps <= BLOCKED_MAX_WARPS
             and warps * per_doc <= SMEM_LIMIT,
             f"warps must lie in [1, {BLOCKED_MAX_WARPS}] and their "
             f"documents ({per_doc} B each) fit {SMEM_LIMIT} B of shared "
             f"memory")
    _require(stats is None or (stats.device == dev
                               and stats.dtype == torch.int64
                               and stats.is_contiguous()
                               and tuple(stats.shape) == (B, BLOCKED_STATS)),
             f"stats must be a contiguous int64 [{B}, {BLOCKED_STATS}] on "
             f"the card")

    def out(r):
        return torch.empty(r, B, dtype=I32, device=dev)

    outs = (out(S), out(S), out(CAP), out(CAP), out(1), out(NBT), out(NBT),
            out(NBT), out(8))
    # Four K-row block copies a document, after the lane-major planes
    # [B, CAP] of ordp and lenp where the rows live in device memory.
    scratch = torch.empty((0 if on_chip else 2 * CAP) + 4 * K, B,
                          dtype=I32, device=dev)
    fn = _kernels.function(_BKERNEL, _BLAUNCH, _BARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tensors = (*cols, ord0, len0, nlog0, blk0, rws0, liv0, *outs, scratch)
    code = fn(*(t.data_ptr() for t in tensors),
              None if stats is None else stats.data_ptr(), S, B, CAP, K, NBT,
              wmax, warps, int(on_chip), stream)
    _kernels.check(_BKERNEL, code)
    _kernels.count_launch(_BKERNEL)
    return outs


def lanes_replay(*args, **shape):
    """The un-blocked replay on the device of its inputs: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    dev = args[0].device
    if dev.type == "cpu":
        return lanes_replay_plain(*args, **shape)
    if dev.type == "cuda":
        return lanes_replay_cuda(*args, **shape)
    raise ValueError(f"no replay for device {dev}")


def lanes_blocked_replay(*args, **shape):
    """The blocked replay on the device of its inputs: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    dev = args[0].device
    if dev.type == "cpu":
        return lanes_blocked_replay_plain(*args, **shape)
    if dev.type == "cuda":
        return lanes_blocked_replay_cuda(*args, **shape)
    raise ValueError(f"no replay for device {dev}")


# -- results and streaming state ---------------------------------------------


@dataclasses.dataclass
class LanesResult:
    """Per-lane divergent documents, on the device of the replay."""

    ordp: torch.Tensor     # i32[CAP, B]
    lenp: torch.Tensor     # i32[CAP, B]
    rows: torch.Tensor     # i32[1, B] occupied run rows per lane
    ol: torch.Tensor       # i32[S, B] (u32 bits)
    orr: torch.Tensor      # i32[S, B] (u32 bits)
    err: torch.Tensor      # i32[8, B]  0: capacity; 1: bad delete
    batch: int

    #: ``state()``'s field names, in order (the checkpoint keys).
    STATE_KEYS = ("ordp", "lenp", "rows")

    def check(self) -> None:
        err = self.err.cpu().numpy()
        if err[0].max() != 0:
            raise RuntimeError(
                f"rle_lanes capacity exhausted on lanes "
                f"{np.nonzero(err[0])[0][:8].tolist()}; raise capacity")
        if err[1].max() != 0:
            raise RuntimeError(
                f"delete ran past the end of the document on lanes "
                f"{np.nonzero(err[1])[0][:8].tolist()}")

    def state(self):
        """(ordp, lenp, rows): the next chunk's ``init`` (stays on the
        device)."""
        return self.ordp, self.lenp, self.rows


@dataclasses.dataclass
class BlockedLanesResult:
    """Blocked per-lane outputs: K-row physical blocks and logical block
    tables."""

    ordp: torch.Tensor     # i32[CAP, B]  physical K-row blocks
    lenp: torch.Tensor     # i32[CAP, B]
    nlog: torch.Tensor     # i32[1, B]    logical blocks in use per lane
    blkord: torch.Tensor   # i32[NBT, B]  logical slot -> physical block
    rws: torch.Tensor      # i32[NBT, B]  occupied rows per logical slot
    liv: torch.Tensor      # i32[NBT, B]  live chars per logical slot
    ol: torch.Tensor       # i32[S, B] (u32 bits)
    orr: torch.Tensor      # i32[S, B] (u32 bits)
    err: torch.Tensor      # i32[8, B]  0: out of blocks; 1: bad delete
    batch: int
    block_k: int

    #: ``state()``'s field names, in order (the checkpoint keys).
    STATE_KEYS = ("ordp", "lenp", "nlog", "blkord", "rws", "liv")

    def check(self) -> None:
        err = self.err.cpu().numpy()
        if err[0].max() != 0:
            raise RuntimeError(
                f"blocked rle_lanes out of blocks on lanes "
                f"{np.nonzero(err[0])[0][:8].tolist()}; raise capacity")
        if err[1].max() != 0:
            raise RuntimeError(
                f"delete ran past the end of the document on lanes "
                f"{np.nonzero(err[1])[0][:8].tolist()}")

    def state(self):
        """(ordp, lenp, nlog, blkord, rws, liv): the next chunk's ``init``
        (stays on the device)."""
        return tuple(getattr(self, k) for k in self.STATE_KEYS)

    @property
    def rows(self):
        """Total occupied rows per lane (as ``LanesResult.rows``)."""
        return self.rws.sum(dim=0, keepdim=True, dtype=I32)


def _as_i32(a, dev) -> torch.Tensor:
    """A state array (tensor or numpy, e.g. from a checkpoint) as an int32
    tensor on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=I32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def _pad_rows(a: torch.Tensor, rows: int, fill: int) -> torch.Tensor:
    """``a`` [r, B] padded to ``rows`` rows with ``fill``, on its device."""
    if a.shape[0] >= rows:
        return a
    pad = torch.full((rows - a.shape[0], a.shape[1]), fill, dtype=I32,
                     device=a.device)
    return torch.cat([a, pad], dim=0)


def _grow_planes(state, capacity: int, B: int, dev):
    """Zero-pad a prior chunk's (ordp, lenp, rows) up to this chunk's row
    capacity (run rows pack at the front, so padding is free)."""
    o0, l0, r0 = (_as_i32(a, dev) for a in state)
    _require(o0.shape[0] <= capacity and o0.shape[1] == B,
             f"init state shape {tuple(o0.shape)} incompatible with "
             f"({capacity}, {B})")
    return (_pad_rows(o0, capacity, 0), _pad_rows(l0, capacity, 0),
            r0.reshape(1, B))


def _empty_blocked_state(capacity: int, NBT: int, B: int, dev):
    def z(r):
        return torch.zeros(r, B, dtype=I32, device=dev)

    return (z(capacity), z(capacity), z(1), z(NBT), z(NBT), z(NBT))


def _grow_blocked_state(state, capacity: int, block_k: int, B: int, dev):
    """Pad a prior chunk's blocked 6-tuple up to this chunk's capacity:
    fresh physical blocks append at the end, logical tables zero-pad past
    nlog."""
    o0, l0, nlog, blk, rws, liv = (_as_i32(a, dev) for a in state)
    _require(o0.shape[0] <= capacity and o0.shape[1] == B,
             f"init state shape {tuple(o0.shape)} incompatible with "
             f"({capacity}, {B})")
    _require(o0.shape[0] % block_k == 0,
             f"prior capacity {o0.shape[0]} is not a block_k "
             f"({block_k}) multiple: K must not change between chunks")
    NBT = max(8, capacity // block_k)
    for t in (blk, rws, liv):
        _require(t.shape[0] <= NBT, f"table rows {t.shape[0]} exceed {NBT}")
    return (_pad_rows(o0, capacity, 0), _pad_rows(l0, capacity, 0),
            nlog.reshape(1, B), _pad_rows(blk, NBT, 0),
            _pad_rows(rws, NBT, 0), _pad_rows(liv, NBT, 0))


# -- replayers ----------------------------------------------------------------------


def _local_stream(ops: OpTensors, chunk: int):
    """(S, B, s_pad) of a stacked local stream, refused otherwise."""
    kinds = np.asarray(ops.kind)
    _require(kinds.ndim == 2, "rle_lanes takes stacked per-doc streams "
             "([S, B] columns; see batch.stack_ops)")
    _require(bool((kinds == KIND_LOCAL).all()),
             "rle_lanes replays local streams; per-lane remote streams -> "
             "ops.rle_lanes_mixed")
    S, B = kinds.shape
    return S, B, max(((S + chunk - 1) // chunk) * chunk, chunk)


def upload(a: np.ndarray, dev) -> torch.Tensor:
    """A host array as a tensor on ``dev``. To the card it goes through
    pinned memory without blocking the host: a copy from pageable memory
    would first wait for every launch queued before it, which serializes
    the host with the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _stage(ops: OpTensors, s_pad: int, dev, names=OP_COLUMNS):
    """The op columns ``names`` as int32 ``[s_pad, B]`` tensors (u32
    bits), padded with no-op steps."""
    S = ops.num_steps

    def col(name):
        a = np.asarray(getattr(ops, name), dtype=np.uint32).view(np.int32)
        return upload(np.pad(a, ((0, s_pad - S), (0, 0))), dev)

    return tuple(col(n) for n in names)


def make_replayer_lanes(ops: OpTensors, capacity: int, chunk: int = 128,
                        init=None, device=None):
    """Stage a stacked per-doc LOCAL stream (``stack_ops`` output: every
    column ``[S, B]``) for the un-blocked engine and return a function
    ``run(state=None) -> LanesResult``.

    ``capacity`` counts run rows per document. ``init`` is a prior
    result's ``state()`` (the streaming warm start); None = empty
    documents. ``chunk`` pads the step count to a multiple of itself, as
    the JAX package's grid does."""
    dev = resolve_device(device)
    S, B, s_pad = _local_stream(ops, chunk)
    _require(capacity >= 8, "capacity must hold a few runs")
    wmax = fused_width(ops)
    _require(wmax + 1 < capacity,
             f"fused rows_per_step {wmax} cannot fit capacity {capacity}")
    staged = _stage(ops, s_pad, dev)
    start = [None if init is None else _grow_planes(init, capacity, B, dev)]

    def initial():
        """The state a run without one starts from: ``init`` grown, or
        empty documents, allocated at first use (a stream's later chunks
        start from the prior chunk's state and never need one)."""
        if start[0] is None:
            start[0] = (torch.zeros(capacity, B, dtype=I32, device=dev),
                        torch.zeros(capacity, B, dtype=I32, device=dev),
                        torch.zeros(1, B, dtype=I32, device=dev))
        return start[0]

    # One live prefix can serve both branches of a step iff no lane
    # deletes AND inserts in the same step (see _shared_cum_gate).
    dn = np.asarray(ops.del_len) > 0
    iln = np.asarray(ops.ins_len) > 0
    shared_cum = (not bool(np.any(dn & iln))
                  and _shared_cum_gate(dn.any(axis=1), iln.any(axis=1),
                                       s_pad))
    shape = dict(wmax=wmax, shared_cum=shared_cum)

    def run(state=None) -> LanesResult:
        ini = initial() if state is None else _grow_planes(
            state, capacity, B, dev)
        ol, orr, ordp, lenp, rows, err = lanes_replay(*staged, *ini, **shape)
        return LanesResult(ordp=ordp, lenp=lenp, rows=rows, ol=ol[:S],
                           orr=orr[:S], err=err, batch=B)

    run.staged = staged
    run.initial = initial
    run.shape = shape
    run.capacity = capacity
    run.grow = lambda state: _grow_planes(state, capacity, B, dev)
    return run


def replay_lanes(ops: OpTensors, capacity: int, **kw) -> LanesResult:
    """One-shot convenience wrapper over ``make_replayer_lanes``."""
    return make_replayer_lanes(ops, capacity, **kw)()


def make_replayer_lanes_blocked(ops: OpTensors, capacity: int,
                                block_k: int = 64, chunk: int = 128,
                                init=None, device=None):
    """Stage a stacked per-doc LOCAL stream for the BLOCKED engine and
    return ``run(state=None) -> BlockedLanesResult``: bit-identical
    documents and origins to ``make_replayer_lanes``. ``capacity`` counts
    run rows per lane and must be a ``block_k`` multiple (growing
    per-chunk capacities grow NB at fixed K); ``init`` is a prior blocked
    ``state()`` 6-tuple."""
    dev = resolve_device(device)
    S, B, s_pad = _local_stream(ops, chunk)
    _require(block_k >= 8, "block_k must hold a few runs")
    _require(capacity % block_k == 0,
             f"capacity ({capacity}) must be a multiple of block_k "
             f"({block_k})")
    wmax = fused_width_checked([ops], block_k)
    staged = _stage(ops, s_pad, dev)
    NBT = max(8, capacity // block_k)
    start = [None if init is None
             else _grow_blocked_state(init, capacity, block_k, B, dev)]

    def initial():
        """The state a run without one starts from, allocated at first
        use (as for the un-blocked engine)."""
        if start[0] is None:
            start[0] = _empty_blocked_state(capacity, NBT, B, dev)
        return start[0]

    shape = dict(block_k=block_k, wmax=wmax)

    def run(state=None) -> BlockedLanesResult:
        ini = initial() if state is None else _grow_blocked_state(
            state, capacity, block_k, B, dev)
        ol, orr, ordp, lenp, nlog, blk, rws, liv, err = \
            lanes_blocked_replay(*staged, *ini, **shape)
        return BlockedLanesResult(
            ordp=ordp, lenp=lenp, nlog=nlog, blkord=blk, rws=rws, liv=liv,
            ol=ol[:S], orr=orr[:S], err=err, batch=B, block_k=block_k)

    run.staged = staged
    run.initial = initial
    run.shape = shape
    run.capacity, run.nbt = capacity, NBT
    run.grow = lambda state: _grow_blocked_state(state, capacity, block_k,
                                                 B, dev)
    return run


# -- expansion to per-char state ---------------------------------------------


def _expand_runs(o: np.ndarray, ln: np.ndarray) -> np.ndarray:
    o = o.astype(np.int64)
    ln = ln.astype(np.int64)
    if len(o) == 0:
        return np.zeros(0, np.int32)
    assert (ln > 0).all(), "occupied run with non-positive length"
    total = int(ln.sum())
    base = np.repeat(np.abs(o), ln)
    within = np.arange(total) - np.repeat(np.cumsum(ln) - ln, ln)
    return (np.repeat(np.sign(o), ln) * (base + within)).astype(np.int32)


def expand_lane_blocked(res, doc_index: int) -> np.ndarray:
    """One lane of a blocked result -> per-char ±(order+1) column in doc
    order (walks the logical block table)."""
    res.check()
    K = res.block_k
    ordc = res.ordp[:, doc_index].cpu().numpy()
    lenc = res.lenp[:, doc_index].cpu().numpy()
    blk = res.blkord[:, doc_index].cpu().numpy()
    rows = res.rws[:, doc_index].cpu().numpy()
    nlog = int(res.nlog[0, doc_index])
    o_parts, l_parts = [], []
    for l in range(nlog):
        b, r = int(blk[l]), int(rows[l])
        o_parts.append(ordc[b * K: b * K + r])
        l_parts.append(lenc[b * K: b * K + r])
    if not o_parts:
        return np.zeros(0, np.int32)
    return _expand_runs(np.concatenate(o_parts), np.concatenate(l_parts))


def expand_lane(res, doc_index: int) -> np.ndarray:
    """One lane's run rows -> per-char ±(order+1) column in doc order
    (dispatches on the blocked-layout results too)."""
    if hasattr(res, "blkord"):
        return expand_lane_blocked(res, doc_index)
    res.check()
    r = int(res.rows[0, doc_index])
    return _expand_runs(res.ordp[:r, doc_index].cpu().numpy(),
                        res.lenp[:r, doc_index].cpu().numpy())


def lanes_to_flat(ops: OpTensors, res, doc_index: int,
                  capacity: int | None = None,
                  order_capacity: int | None = None) -> FlatDoc:
    """One lane -> a standard ``FlatDoc`` (prefilled by-order logs and the
    replay's per-op origins merged in), on the result's device."""
    flat = expand_lane(res, doc_index)
    n = len(flat)
    if capacity is None:
        capacity = max(2 << max(n - 1, 5).bit_length(), n)
    per_doc = OpTensors(**{f.name: np.asarray(getattr(ops, f.name))[:,
                                                                   doc_index]
                           for f in dataclasses.fields(OpTensors)})
    dev = res.ordp.device
    doc = prefill_logs(make_flat_doc(capacity, order_capacity, device=dev),
                       per_doc)
    ol_log = doc.ol_log.cpu().numpy().view(np.uint32).copy()
    or_log = doc.or_log.cpu().numpy().view(np.uint32).copy()
    ol_np = res.ol[:, doc_index].cpu().numpy().view(np.uint32)
    or_np = res.orr[:, doc_index].cpu().numpy().view(np.uint32)
    merge_fused_origins(ol_log, or_log, per_doc, ol_np, or_np)
    signed_col = np.zeros(capacity, np.int32)
    signed_col[:n] = flat
    advance = int(np.asarray(per_doc.order_advance, dtype=np.int64).sum())
    return dataclasses.replace(
        doc,
        signed=torch.from_numpy(signed_col).to(dev),
        ol_log=torch.from_numpy(ol_log.view(np.int32)).to(dev),
        or_log=torch.from_numpy(or_log.view(np.int32)).to(dev),
        n=n,
        next_order=advance & 0xFFFF_FFFF,
    )
