"""Sequence-parallel RLE mutation: the full op surface for one huge document
sharded over the mesh's ``sp`` axis (counterpart of
``text_crdt_rust_tpu/parallel/sp_apply.py``; config ``sp``'s engine,
``sp-apply``).

Layout, as in the JAX package: rank ``s`` of the ``sp`` group owns a PACKED
slice of ``R`` run rows ``(±(order+1), len)`` and a row count; document
order is the concatenation of the shards' packed prefixes in ``sp`` order.
The by-order origin/rank tables (the YATA scan's inputs) are sharded by
ORDER RANGE: shard ``s`` owns orders ``[s*OTS, (s+1)*OTS)``.

Each step runs the phases of the JAX ``step`` in its order — local delete,
local insert, remote delete, remote insert (the YATA integrate loop), table
upkeep — as shard-local work on the rank's ``[R]`` rows and ``[OTS]`` table
slice between the mesh's collectives (``parallel/mesh.py``):

- **local delete** (`mutations.rs:520-570`): every shard clips the live
  span ``[p, p+d)`` against its carry-adjusted cumsum and flips or
  boundary-splits on its own; an all-gather of the shard totals and one sum
  of the covered count;
- **local insert** (`mutations.rs:17-179`): the one shard owning live rank
  ``p`` splices (<= 3 touched rows); one all-gather of (shard total, head
  row) pairs, one sum of (owner, left origin, right origin, active);
- **remote delete** (`doc.rs:295-340`): the one-pass order-interval clip;
  one sum of the covered count;
- **remote insert** (`doc.rs:167-234`): the YATA conflict scan with the
  scan state replicated on every rank; each probe resolves its run through
  the owning row shard and its origins and rank through the owning table
  shard (three sums a probe), then the owner splices (one sum of owner and
  active);
- at the end of the stream, one all-gather ORs the error bits.

The phases are cut at their collectives into segments (``_Shard``'s
methods, ``SEG_*`` of ``parallel/sp_kernel.py``); ``drive`` runs a
stream's segments in order and makes the collectives between them.
``_Shard``'s segments in torch are the plain version, the specification;
on CUDA tensors ``SpReplay`` runs S1 (``ops/csrc/sp_replay.cu``): the whole
stream in one launch at sp = 1, where each collective of a one-rank group
is the identity that S1 makes in place (``Mesh.calls`` then counts only
the closing OR), and at sp > 1 ``drive`` over ``sp_kernel.KernelSegments``,
one launch for the work between two collectives.

What differs from the JAX program, without changing a result bit:

- the op stream is host data replicated on every rank, so a phase that the
  step's kind and lengths switch off is skipped (the JAX scan runs it
  masked, as a no-op, with its collectives);
- the scalars one JAX phase psums apart ride one sum here, and the remote
  insert's probes reuse the raw carry computed when the scan starts (the
  scan mutates nothing), where the JAX program all-gathers it again;
- at sp > 1 the integrate loop's predicate is read to the host once an
  iteration; it is computed from collective results only, so every rank
  leaves at the same iteration.

Indices computed on the device are read as JAX reads them (negative counts
from the end, then clamped: ``sp_runs.take``), so the masked reads of a
capacity-blocked or empty shard read the rows the JAX program reads.
``replay`` records its collectives (``Mesh.calls``); ``SpDoc.last`` keeps the
last stream's steps and collective calls.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

from ..common import ROOT_ORDER
from ..ops.batch import (
    KIND_LOCAL,
    KIND_REMOTE_DEL,
    KIND_REMOTE_INS,
    OpTensors,
    require_unfused,
)
from . import sp_kernel as SK
from .mesh import Mesh
from .sp_kernel import (
    SEG_FINISH,
    SEG_INIT,
    SEG_LD_COVER,
    SEG_LD_SPLIT,
    SEG_LD_TOTAL,
    SEG_LI_END,
    SEG_LI_HEAD,
    SEG_LI_SPLICE,
    SEG_RD_COVER,
    SEG_RD_SPLIT,
    SEG_RI_END,
    SEG_RI_LEFT,
    SEG_RI_NEXT,
    SEG_RI_OLEFT,
    SEG_RI_RUN,
    SEG_RI_SPLICE,
    SEG_RI_START,
    SEG_RI_TABS,
    SEG_RI_TOTAL,
)
from .sp_runs import cumsum32, first_true, pick, sum32, take

I32 = torch.int32
ROOT_I = int(np.uint32(ROOT_ORDER).view(np.int32))  # -1
TAB_UNKNOWN = -2  # by-order table sentinel: entry not yet known

# Error flag bits (SpDoc.apply_stream decodes).
ERR_CAPACITY = 1
ERR_BAD_DELETE = 2
ERR_NO_OWNER = 4
ERR_ORDER_MISS = 8

#: The op columns ``replay`` takes, in order (u32 bits viewed as int32).
OP_FIELDS = ("kind", "pos", "del_len", "del_target", "origin_left",
             "origin_right", "rank", "ins_len", "ins_order_start")


def _shift2(x: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """Rows shifted toward higher indices by ``amt`` in {0, 1, 2}."""
    return torch.where(amt == 0, x,
                       torch.where(amt == 1, torch.roll(x, 1),
                                   torch.roll(x, 2)))


def _flag(cond: torch.Tensor, bit: int) -> torch.Tensor:
    return torch.where(cond, bit, 0).to(I32)


class _Shard:
    """One rank's state during a stream and the segments of a step: the
    plain version, the specification S1 (``ops/csrc/sp_replay.cu``) is held
    to. A segment is the shard-local work between two collectives; it
    reads the last collective's result (``recv``) and leaves the next
    one's input (``send``). ``drive`` runs them in the JAX ``step`` order
    and makes the collectives."""

    def __init__(self, mesh: Mesh, R: int, OTS: int, ordp, lenp, nrows,
                 oll, orl, rkl, cols: np.ndarray):
        self.mesh, self.R, self.OTS = mesh, R, OTS
        dev = ordp.device
        self.sidx = mesh.index("sp")
        self.idx = torch.arange(R, dtype=I32, device=dev)
        self.tab_base = self.sidx * OTS
        self.tab_g = self.tab_base + torch.arange(OTS, dtype=I32, device=dev)
        self.ordp, self.lenp, self.nrows = ordp, lenp, nrows
        self.oll, self.orl, self.rkl = oll, orl, rkl
        self.err = torch.zeros((), dtype=I32, device=dev)
        self.cols = cols
        S = cols.shape[1]
        self.ols = torch.zeros(S, dtype=I32, device=dev)
        self.ors = torch.zeros(S, dtype=I32, device=dev)
        self.yes = torch.ones((), dtype=torch.bool, device=dev)
        self.send = self.recv = None
        self._segments = {
            SEG_INIT: lambda s, op: None,
            SEG_LD_TOTAL: self.ld_total, SEG_LD_COVER: self.ld_cover,
            SEG_LD_SPLIT: self.ld_split,
            SEG_LI_HEAD: self.li_head, SEG_LI_SPLICE: self.li_splice,
            SEG_LI_END: self.li_end,
            SEG_RD_COVER: self.rd_cover, SEG_RD_SPLIT: self.rd_split,
            SEG_RI_TOTAL: self.ri_total, SEG_RI_LEFT: self.ri_left,
            SEG_RI_START: self.ri_start, SEG_RI_RUN: self.ri_run,
            SEG_RI_TABS: self.ri_tabs, SEG_RI_OLEFT: self.ri_oleft,
            SEG_RI_NEXT: self.ri_next, SEG_RI_SPLICE: self.ri_splice,
            SEG_RI_END: self.ri_end, SEG_FINISH: self.finish}

    # ---- the driver's interface -------------------------------------------

    def run(self, code: int, s: int) -> None:
        op = (tuple(self.cols[:, s].tolist()) if s < self.cols.shape[1]
              else None)
        self._segments[code](s, op)

    def gather(self) -> None:
        self.recv = self.mesh.all_gather(self.send)

    def sum(self) -> None:
        self.recv = self.mesh.sum(self.send)

    def more(self) -> bool:
        """The integrate loop's predicate, read to the host; computed from
        collective results only, so every rank leaves at the same
        iteration."""
        return bool(~self.done & (self.cursor < self.n))

    def result(self):
        err = self.mesh.bor(self.send)[0]
        return (self.ordp, self.lenp, self.nrows.reshape(1), self.oll,
                self.orl, self.rkl, self.ols, self.ors, err)

    # ---- by-order tables (sharded by order range) ------------------------

    def tab_local(self, tab, o):
        """This shard's term of ``tab[o]`` (0 off its range; o < 0 reads
        0 — callers mask ROOT)."""
        j = (o - self.tab_base).clamp(0, self.OTS - 1)
        mine = (o >= self.tab_base) & (o < self.tab_base + self.OTS)
        return torch.where(mine, pick(tab, j), 0)

    def tab_write_run(self, tab, st, ln, v):
        """tab[st:st+ln] = v on the owning range shard(s)."""
        hit = (self.tab_g >= st) & (self.tab_g < st + ln)
        return torch.where(hit, v, tab)

    def tab_write_chain(self, tab, st, ln, head_val):
        """The insert run's origin_left column: the head gets
        ``head_val``, char k > 0 its predecessor's order (`span.rs:9-13`)."""
        hit = (self.tab_g >= st) & (self.tab_g < st + ln)
        return torch.where(hit, torch.where(self.tab_g == st, head_val,
                                            self.tab_g - 1), tab)

    def upkeep(self, s, op, ins_on, head_ol, run_or) -> None:
        """Table upkeep (replicated values, masked to the order-range
        owners) and step ``s``'s log entries: a local insert records the
        origins it discovered, a remote insert its given ones; a
        capacity-blocked splice records nothing."""
        rk, il, st = op[6], op[7], op[8]
        self.oll = torch.where(ins_on, self.tab_write_chain(
            self.oll, st, il, head_ol), self.oll)
        self.orl = torch.where(ins_on, self.tab_write_run(
            self.orl, st, il, run_or), self.orl)
        self.rkl = torch.where(ins_on, self.tab_write_run(
            self.rkl, st, il, rk), self.rkl)
        self.ols[s] = head_ol
        self.ors[s] = run_or

    # ---- order -> raw position -------------------------------------------

    def raw_pos_terms(self, o, raw_carry, rawcum):
        """This shard's (raw position term, found) of order ``o``."""
        ordp, lenp = self.ordp, self.lenp
        so = ordp.abs() - 1
        hit = (ordp != 0) & (so <= o) & (o < so + lenp)
        row = first_true(hit)
        found_l = hit.any()
        raw_before = pick(rawcum, row) - pick(lenp, row)
        off = o - (pick(ordp, row).abs() - 1)
        return (torch.where(found_l, raw_carry + raw_before + off, 0),
                found_l.to(I32))

    def cursor_terms(self, o, need) -> None:
        """The first half of the replicated raw cursor just after order
        ``o``: flags an unknown order when ``need`` and sends this shard's
        (raw position term, found)."""
        self.err = self.err | _flag(need & (o == TAB_UNKNOWN),
                                    ERR_ORDER_MISS)
        p, f = self.raw_pos_terms(torch.clamp(o, min=0), self.carry,
                                  self.rawcum)
        self.send = torch.stack([p, f]).to(I32)
        self.cursor_of = (o, need)

    def cursor_done(self):
        """The second half: the cursor (0 for ROOT) from the summed terms,
        flagging an absent order when ``need``."""
        o, need = self.cursor_of
        red = self.recv
        is_root = o == ROOT_I
        self.err = self.err | _flag(need & ~is_root & (red[1] == 0),
                                    ERR_ORDER_MISS)
        return torch.where(is_root, 0, red[0] + 1)

    # ---- splices -----------------------------------------------------------

    def apply_partial(self, act, i_p, cs, ce):
        ordp, lenp, idx = self.ordp, self.lenp, self.idx
        o = take(ordp, i_p)
        ln = take(lenp, i_p)
        cs_i = take(cs, i_p)
        ce_i = take(ce, i_p)
        cov_i = ce_i - cs_i
        has_head = (cs_i > 0) & act
        has_tail = (ce_i < ln) & act
        amt = has_head.to(I32) + has_tail.to(I32)
        so = _shift2(ordp, amt)
        sl = _shift2(lenp, amt)
        no = torch.where(idx <= i_p, ordp, so)
        nl = torch.where(idx <= i_p, lenp, sl)
        p0o = torch.where(has_head, o, -(o + cs_i))
        p0l = torch.where(has_head, cs_i, cov_i)
        p1o = torch.where(has_head, -(o + cs_i), o + ce_i)
        p1l = torch.where(has_head, cov_i, ln - ce_i)
        w0 = act & (idx == i_p)
        no = torch.where(w0, p0o, no)
        nl = torch.where(w0, p0l, nl)
        w1 = act & (idx == i_p + 1) & (amt >= 1)
        no = torch.where(w1, p1o, no)
        nl = torch.where(w1, p1l, nl)
        w2 = act & (idx == i_p + 2) & (amt == 2)
        no = torch.where(w2, o + ce_i, no)
        nl = torch.where(w2, ln - ce_i, nl)
        self.ordp, self.lenp = no, nl
        return amt

    def clip_and_split(self, full, part, cs, ce):
        """The shared tail of both deletes: the capacity gate, full-cover
        flips, then the two boundary splits (the later row first)."""
        R, idx = self.R, self.idx
        npart = sum32(part)
        cap_bad = self.nrows + 2 > R
        self.err = self.err | _flag((npart > 0) & cap_bad, ERR_CAPACITY)
        act = ~cap_bad
        i1 = torch.where(part, idx, R).min()
        i2 = torch.where(part, idx, -1).max()
        # Full-cover flips share the capacity gate: a flagged delete is a
        # clean no-op, not a half-applied one.
        self.ordp = torch.where(full & act, -self.ordp, self.ordp)
        a2 = self.apply_partial(act & (npart >= 1), i2, cs, ce)
        a1 = self.apply_partial(act & (npart == 2), i1, cs, ce)
        self.nrows = self.nrows + torch.where(act, a1 + a2, 0)

    def splice(self, active, is_split, mrg, i_r, ins_at, o_r, l_r, off,
               tail_o, il, st):
        """The insert splice shared by both inserts: rows from ``ins_at``
        shift by 0, 1 or 2 (a circular roll of the whole plane), the run
        at ``i_r`` is cut or grown, the new run and a split's tail are
        written."""
        idx = self.idx
        amt = torch.where(~active | mrg, 0,
                          torch.where(is_split, 2, 1)).to(I32)
        so = _shift2(self.ordp, amt)
        sl = _shift2(self.lenp, amt)
        no = torch.where(idx < ins_at, self.ordp, so)
        nl = torch.where(idx < ins_at, self.lenp, sl)
        nl = torch.where(active & is_split & (idx == i_r), off, nl)
        new_run = active & ~mrg & (idx == ins_at)
        no = torch.where(new_run, st + 1, no)
        nl = torch.where(new_run, il, nl)
        tail = active & is_split & (idx == ins_at + 1)
        no = torch.where(tail, tail_o, no)
        nl = torch.where(tail, l_r - off, nl)
        nl = torch.where(active & mrg & (idx == i_r), l_r + il, nl)
        self.ordp, self.lenp = no, nl
        self.nrows = self.nrows + amt

    # ---- local delete: live span [p, p+d), every shard clips its part -----

    def ld_total(self, s, op):
        self.lv = torch.where(self.ordp > 0, self.lenp, 0)
        self.local = cumsum32(self.lv)
        self.send = self.local[-1].reshape(1)

    def ld_cover(self, s, op):
        p, d = op[1], op[2]
        carry = sum32(self.recv.reshape(-1)[:self.sidx])
        before = carry + self.local - self.lv
        self.cs = torch.minimum((p - before).clamp(min=0), self.lv)
        self.ce = torch.minimum((p + d - before).clamp(min=0), self.lv)
        self.cov = self.ce - self.cs
        self.send = sum32(self.cov).reshape(1)

    def ld_split(self, s, op):
        covered = self.recv[0]
        self.err = self.err | _flag(covered < op[2], ERR_BAD_DELETE)
        full = (self.cov > 0) & (self.cov == self.lenp)
        part = (self.cov > 0) & ~full
        self.clip_and_split(full, part, self.cs, self.ce)

    # ---- local insert at live rank p: the owner shard splices -------------

    def li_head(self, s, op):
        self.lv = torch.where(self.ordp > 0, self.lenp, 0)
        self.local = cumsum32(self.lv)
        head = torch.where(self.nrows > 0, self.ordp[0], 0)
        self.send = torch.stack([self.local[-1], head])

    def li_splice(self, s, op):
        p, il, st = op[1], op[7], op[8]
        R, idx, sidx = self.R, self.idx, self.sidx
        ordp, lenp, nrows = self.ordp, self.lenp, self.nrows
        lv, local = self.lv, self.local
        totals, heads = self.recv[:, 0], self.recv[:, 1]
        carry = sum32(totals[:sidx])
        if p == 0:
            owner = torch.full((), sidx == 0, device=ordp.device)
        else:
            owner = (carry < p) & (p <= carry + local[-1])
        cap_bad = nrows + 2 > R
        active = owner & ~cap_bad

        local_rank = p - carry
        i_r = sum32((local < local_rank) & (idx < nrows)).clamp(max=R - 1)
        o_r = pick(ordp, i_r)
        l_r = pick(lenp, i_r)
        off = local_rank - (pick(local, i_r) - pick(lv, i_r))

        # Successor across the shard boundary: the first occupied head
        # past this shard is the raw successor of a splice at the local
        # end.
        sp_ids = torch.arange(heads.shape[0], device=ordp.device)
        after = (sp_ids > sidx) & (heads != 0)
        nxt_head = torch.where(after.any(), pick(heads, first_true(after)),
                               0)
        occupied = heads != 0
        first_head = torch.where(occupied.any(),
                                 pick(heads, first_true(occupied)), 0)

        mrg = (p > 0) & (off == l_r) & ((st + 1) == (o_r + l_r))
        is_split = (p > 0) & (off < l_r)
        left = (ROOT_I if p == 0 else (o_r - 1) + (off - 1))
        nxt_in_rows = torch.where(i_r + 1 < nrows,
                                  pick(ordp, (i_r + 1).clamp(max=R - 1)),
                                  nxt_head)
        if p == 0:
            succ = first_head
        else:
            succ = torch.where(is_split, o_r + off, nxt_in_rows)
        right = torch.where(succ == 0, ROOT_I, succ.abs() - 1)

        ins_at = torch.zeros_like(i_r) if p == 0 else i_r + 1
        self.splice(active, is_split, mrg, i_r, ins_at, o_r, l_r, off,
                    o_r + off, il, st)
        self.owner, self.cap_bad = owner, cap_bad
        self.send = torch.stack([
            owner.to(I32), torch.where(active, left, 0).to(I32),
            torch.where(active, right, 0).to(I32), active.to(I32)])

    def li_end(self, s, op):
        red = self.recv
        self.err = (self.err | _flag(red[0] == 0, ERR_NO_OWNER)
                    | _flag(self.owner & self.cap_bad, ERR_CAPACITY))
        any_act = red[3] > 0
        self.upkeep(s, op, any_act, torch.where(any_act, red[1], 0),
                    torch.where(any_act, red[2], 0))

    # ---- remote delete: the order interval [t, t+d) ------------------------

    def rd_cover(self, s, op):
        """Order-interval tombstone (`doc.rs:295-340`): covered dead runs
        count toward the idempotency total without flipping
        (`double_delete.rs:6-9`)."""
        d, t = op[2], op[3]
        ordp, lenp = self.ordp, self.lenp
        so = ordp.abs() - 1
        occ = ordp != 0
        self.cs = torch.minimum((t - so).clamp(min=0), lenp)
        self.ce = torch.minimum((t + d - so).clamp(min=0), lenp)
        self.cov = torch.where(occ, self.ce - self.cs, 0)
        self.send = sum32(self.cov).reshape(1)

    def rd_split(self, s, op):
        covered = self.recv[0]
        self.err = self.err | _flag(covered < op[2], ERR_BAD_DELETE)
        cov, live = self.cov, self.ordp > 0
        full = live & (cov > 0) & (cov == self.lenp)
        part = live & (cov > 0) & ~(cov == self.lenp)
        # Max growth is +2: one run holding both endpoints 3-way splits,
        # or the two endpoint runs each split one-sided.
        self.clip_and_split(full, part, self.cs, self.ce)

    # ---- remote insert: the YATA scan (`doc.rs:167-234`), then a splice ----

    def ri_total(self, s, op):
        self.rawcum = cumsum32(self.lenp)
        self.send = self.rawcum[-1].reshape(1)

    def ri_left(self, s, op):
        totals = self.recv.reshape(-1)
        self.carry = sum32(totals[:self.sidx])
        self.n = sum32(totals)
        self.cursor_terms(torch.tensor(op[4], dtype=I32,
                                       device=self.ordp.device), self.yes)

    def ri_start(self, s, op):
        """The scan state, replicated; conflict-free ops leave on the
        first probe (`doc.rs:192-194`)."""
        self.left_cursor = self.cursor_done()
        self.cursor = self.scan_start = self.left_cursor
        self.scanning = torch.zeros_like(self.yes)
        self.done = torch.zeros_like(self.yes)

    def ri_run(self, s, op):
        """The probed run, through the shard that owns the cursor."""
        R, idx = self.R, self.idx
        ordp, lenp, rawcum, carry = self.ordp, self.lenp, self.rawcum, \
            self.carry
        own = (self.cursor >= carry) & (self.cursor < carry + rawcum[-1])
        local = self.cursor - carry
        i_r = sum32((rawcum <= local) & (idx < self.nrows)).clamp(max=R - 1)
        self.send = torch.stack([
            torch.where(own, pick(ordp, i_r), 0),
            torch.where(own, pick(lenp, i_r), 0),
            torch.where(own, local - (pick(rawcum, i_r)
                                      - pick(lenp, i_r)), 0)])

    def ri_tabs(self, s, op):
        """The probed item's origins and rank, through the shard that owns
        its order."""
        red = self.recv
        self.o_r, self.l_r, self.off = red[0], red[1], red[2]
        self.so = self.o_r.abs() - 1
        self.other_order = self.so + self.off
        self.send = torch.stack([
            self.tab_local(self.oll, self.other_order),
            self.tab_local(self.orl, self.other_order),
            self.tab_local(self.rkl, self.other_order)])

    def ri_oleft(self, s, op):
        tabs = self.recv
        self.other_left, self.other_right, self.other_rank = (
            tabs[0], tabs[1], tabs[2])
        self.cursor_terms(self.other_left, ~self.done)

    def ri_next(self, s, op):
        """One step of the conflict scan (`doc.rs:183-222`)."""
        my_rank, o_right = op[6], op[5]
        olc = self.cursor_done()
        scanning, cursor = self.scanning, self.cursor
        other_order, other_right = self.other_order, self.other_right
        brk = (other_order == o_right) | (olc < self.left_cursor)
        eq = ~brk & (olc == self.left_cursor)
        gt = my_rank > self.other_rank
        brk = brk | (eq & ~gt & (o_right == other_right))
        starts_scan = eq & ~gt & (o_right != other_right)
        self.scan_start = torch.where(starts_scan & ~scanning, cursor,
                                      self.scan_start)
        self.scanning = torch.where(
            eq, torch.where(gt, False,
                            torch.where(o_right == other_right,
                                        scanning, True)),
            scanning)
        contains_right = ((o_right > other_order)
                          & (o_right < self.so + self.l_r))
        stp = torch.where(contains_right, o_right - other_order,
                          self.l_r - self.off)
        self.cursor = torch.where(brk, cursor, cursor + stp)
        self.done = self.done | brk

    def ri_splice(self, s, op):
        """`doc.rs:274-293` sharded: splice at the scan's raw position on
        the owner shard (a tombstone-sign-preserving tail; the merge gated
        on the origin chain)."""
        o_left, il, st = op[4], op[7], op[8]
        R, idx, sidx = self.R, self.idx, self.sidx
        ordp, lenp, nrows = self.ordp, self.lenp, self.nrows
        rawcum, carry = self.rawcum, self.carry
        c = torch.where(self.scanning, self.scan_start, self.cursor)
        owner = torch.where(c == 0, sidx == 0,
                            (carry < c) & (c <= carry + rawcum[-1]))
        cap_bad = nrows + 2 > R
        active = owner & ~cap_bad

        local = c - carry
        i_r = sum32((rawcum < local) & (idx < nrows)).clamp(max=R - 1)
        o_r = pick(ordp, i_r)
        l_r = pick(lenp, i_r)
        off = local - (pick(rawcum, i_r) - l_r)

        mrg = ((c > 0) & (o_r > 0) & (off == l_r)
               & ((st + 1) == (o_r + l_r)) & (o_left == o_r + l_r - 2))
        is_split = (c > 0) & (off < l_r)
        ins_at = torch.where(c == 0, 0, i_r + 1)
        tail_o = torch.where(o_r > 0, o_r + off, o_r - off)
        self.splice(active, is_split, mrg, i_r, ins_at, o_r, l_r, off,
                    tail_o, il, st)
        self.owner, self.cap_bad = owner, cap_bad
        self.send = torch.stack([owner.to(I32), active.to(I32)])

    def ri_end(self, s, op):
        red = self.recv
        self.err = (self.err | _flag(red[0] == 0, ERR_NO_OWNER)
                    | _flag(self.owner & self.cap_bad, ERR_CAPACITY))
        ri = red[1] > 0
        self.upkeep(s, op, ri, torch.where(ri, op[4], 0).to(I32),
                    torch.where(ri, op[5], 0).to(I32))

    def finish(self, s, op):
        self.send = self.err.reshape(1)


def drive(seg, cols: np.ndarray):
    """Apply the op columns ``cols`` (int32 ``[9, S]``, host data, every
    rank the same) through ``seg``, one rank's segments (``_Shard``, the
    plain version, or ``sp_kernel.KernelSegments``, S1 a segment): the
    phases of each step in the JAX ``step`` order, each segment followed
    by the collective that the next one reads. A phase that the step's
    kind and lengths switch off is skipped (the JAX scan runs it masked,
    as a no-op, with its collectives). Returns ``seg.result()``."""
    seg.run(SEG_INIT, 0)
    for s, (kd, _p, d, _t, _ol, _or, _rk, il, _st) in enumerate(
            cols.T.tolist()):
        if kd == KIND_LOCAL and d > 0:
            seg.run(SEG_LD_TOTAL, s)
            seg.gather()
            seg.run(SEG_LD_COVER, s)
            seg.sum()
            seg.run(SEG_LD_SPLIT, s)
        if kd == KIND_LOCAL and il > 0:
            seg.run(SEG_LI_HEAD, s)
            seg.gather()
            seg.run(SEG_LI_SPLICE, s)
            seg.sum()
            seg.run(SEG_LI_END, s)
        if kd == KIND_REMOTE_DEL and d > 0:
            seg.run(SEG_RD_COVER, s)
            seg.sum()
            seg.run(SEG_RD_SPLIT, s)
        if kd == KIND_REMOTE_INS and il > 0:
            seg.run(SEG_RI_TOTAL, s)
            seg.gather()
            seg.run(SEG_RI_LEFT, s)
            seg.sum()
            seg.run(SEG_RI_START, s)
            while seg.more():
                seg.run(SEG_RI_RUN, s)
                seg.sum()
                seg.run(SEG_RI_TABS, s)
                seg.sum()
                seg.run(SEG_RI_OLEFT, s)
                seg.sum()
                seg.run(SEG_RI_NEXT, s)
            seg.run(SEG_RI_SPLICE, s)
            seg.sum()
            seg.run(SEG_RI_END, s)
    seg.run(SEG_FINISH, cols.shape[1])
    return seg.result()


class SpReplay:
    """The sharded full-surface replayer of one ``(mesh, R, OTS)``
    geometry (``make_sp_apply``). ``__call__`` picks by the state's
    device: on CUDA tensors S1 (``parallel/sp_kernel.py``; one launch a
    stream at sp = 1, one a segment between the collectives at sp > 1),
    on CPU tensors the plain version; S1 launches or raises."""

    def __init__(self, mesh: Mesh, R: int, OTS: int):
        self.mesh, self.R, self.OTS = mesh, R, OTS

    @staticmethod
    def _columns(cols) -> np.ndarray:
        return np.stack([np.asarray(c, np.int32) for c in cols])

    def __call__(self, ordp, lenp, rows, oll, orl, rkl, *cols):
        """Apply op columns (``OP_FIELDS`` order, host int32 ``[S]``,
        every rank the same) to this rank's state: ``ordp``/``lenp``
        ``[R]``, ``rows`` ``[1]``, ``oll``/``orl``/``rkl`` ``[OTS]``.
        Returns (new state ..., origin-left log ``[S]``, origin-right log
        ``[S]``, error bits ORed over the group); the logs are int32
        tensors holding u32 bits, 0 on steps that insert nothing. The
        inputs are not written."""
        dev = ordp.device
        cols = self._columns(cols)
        if dev.type == "cuda":
            if self.mesh.sp == 1:
                # Each collective of a one-rank group is the identity: S1
                # makes them in place, so only the closing OR is a call.
                *out, err = SK.sp_replay_cuda(ordp, lenp, rows, oll, orl,
                                              rkl, cols)
                return (*out, self.mesh.bor(err.reshape(1))[0])
            return drive(SK.KernelSegments(self.mesh, ordp, lenp, rows, oll,
                                           orl, rkl, cols), cols)
        if dev.type != "cpu":
            raise ValueError(f"no sp replay for device {dev}")
        return self.plain(ordp, lenp, rows, oll, orl, rkl, cols)

    def plain(self, ordp, lenp, rows, oll, orl, rkl, cols):
        """The plain version on the state's device (any): ``drive`` over
        ``_Shard``'s torch segments; ``cols`` int32 ``[9, S]``."""
        cols = self._columns(cols)
        return drive(_Shard(self.mesh, self.R, self.OTS, ordp, lenp,
                            rows[0], oll, orl, rkl, cols), cols)


@functools.lru_cache(maxsize=16)
def make_sp_apply(mesh: Mesh, R: int, OTS: int) -> SpReplay:
    """The sharded full-surface replayer of ``mesh``: ``R`` run rows a
    shard, ``OTS`` by-order table rows a shard (order space
    ``sp * OTS``); one object per geometry."""
    return SpReplay(mesh, R, OTS)


@dataclasses.dataclass
class StreamStats:
    """The last ``apply_stream``'s work: its steps and the mesh's
    collective calls during it (a retry's included)."""

    steps: int = 0
    collectives: int = 0

    @property
    def collectives_per_step(self) -> float:
        return self.collectives / max(self.steps, 1)


class SpDoc:
    """One huge document sharded over the mesh's ``sp`` axis: this rank's
    packed run-row slice, its count and its order-range table slices on the
    mesh's device, with a host-side apply/expand surface for the full op
    stream (local + remote). Every rank of the ``sp`` group builds the
    ``SpDoc`` and calls each method with the same arguments; the read-backs
    (``runs``, ``planes``, ``expand``, ``to_string``) are collective too and
    answer on every rank."""

    def __init__(self, mesh: Mesh, shard_rows: int, order_rows: int = 1024,
                 auto_reshard: bool = False):
        self.mesh = mesh
        self.nsp = mesh.sp
        self.R = shard_rows
        self.OTS = order_rows
        self.auto_reshard = auto_reshard
        self._replay = make_sp_apply(mesh, shard_rows, order_rows)
        dev = mesh.device
        self.ordp = torch.zeros(shard_rows, dtype=I32, device=dev)
        self.lenp = torch.zeros(shard_rows, dtype=I32, device=dev)
        self.rows = torch.zeros(1, dtype=I32, device=dev)
        self.oll = torch.full((order_rows,), TAB_UNKNOWN, dtype=I32,
                              device=dev)
        self.orl = torch.full((order_rows,), TAB_UNKNOWN, dtype=I32,
                              device=dev)
        self.rkl = torch.zeros(order_rows, dtype=I32, device=dev)
        self.ol_log: Dict[int, int] = {}
        self.or_log: Dict[int, int] = {}
        self.last = StreamStats()
        self.reshards = 0

    def load(self, ordp: np.ndarray, lenp: np.ndarray) -> None:
        """Reshard a document's packed global runs evenly across the
        ``sp`` axis (row-balanced; the first shards take the extra row).
        A fresh ``SpDoc`` holds every live rank in shard 0, so long-lived
        streams load a distributed snapshot first and re-load when a shard
        nears its row budget — the host-side analog of a B-tree rebuild.
        The by-order tables are keyed by order and stay; a document loaded
        from a snapshot must also ``load_tables`` before remote ops."""
        n = len(ordp)
        if n > self.nsp * self.R:
            raise ValueError(f"{n} runs exceed {self.nsp} x {self.R} rows")
        per = -(-n // self.nsp)
        s = self.mesh.index("sp")
        at = min(s * per, n)
        take_n = min(per, n - at)
        o = np.zeros(self.R, np.int32)
        ln = np.zeros(self.R, np.int32)
        o[:take_n] = np.asarray(ordp[at:at + take_n], np.int32)
        ln[:take_n] = np.asarray(lenp[at:at + take_n], np.int32)
        dev = self.mesh.device
        self.ordp = torch.from_numpy(o).to(dev)
        self.lenp = torch.from_numpy(ln).to(dev)
        self.rows = torch.tensor([take_n], dtype=I32, device=dev)

    def load_tables(self, oll: np.ndarray, orl: np.ndarray,
                    rkl: np.ndarray) -> None:
        """Load by-order origin/rank tables (1-D ``[order]`` arrays, int32,
        ROOT = -1, unknown = -2) — required before remote ops touch history
        that predates this ``SpDoc``."""
        ocap = self.nsp * self.OTS
        lo = self.mesh.index("sp") * self.OTS

        def put(a, fill):
            a = np.asarray(a, np.int32)
            if len(a) > ocap:
                raise ValueError(f"table of {len(a)} orders exceeds {ocap}")
            out = np.full(ocap, fill, np.int32)
            out[:len(a)] = a
            return torch.from_numpy(out[lo:lo + self.OTS].copy()).to(
                self.mesh.device)

        self.oll = put(oll, TAB_UNKNOWN)
        self.orl = put(orl, TAB_UNKNOWN)
        self.rkl = put(rkl, 0)

    def apply_stream(self, ops: OpTensors) -> None:
        """Apply a compiled op stream (unbatched ``[S]`` columns, any kind
        mix) to the sharded state. With ``auto_reshard``, a shard-capacity
        flag triggers one even rebalance and a retry (state commits only on
        a clean stream, so the retry replays from the pre-stream state).
        A flagged stream raises ``RuntimeError`` on every rank."""
        kinds = np.asarray(ops.kind)
        if kinds.ndim != 1:
            raise ValueError("sp apply takes one unbatched stream")
        require_unfused(ops, "sp apply")
        # Local ops never read the tables, so a local-only stream may run
        # past the table range; remote ops probe by order, so their order
        # space must fit (out-of-range writes would drop silently).
        if bool((kinds != KIND_LOCAL).any()):
            top = int((np.asarray(ops.ins_order_start, np.int64)
                       + np.asarray(ops.ins_len, np.int64)).max(initial=0))
            if top > self.nsp * self.OTS:
                raise ValueError(
                    f"order space {top} exceeds the table capacity "
                    f"{self.nsp * self.OTS}; raise order_rows")
        cols = [np.asarray(getattr(ops, f), dtype=np.uint32).view(np.int32)
                for f in OP_FIELDS]
        calls0 = dict(self.mesh.calls)
        stats = StreamStats(steps=len(kinds))
        for attempt in (0, 1):
            out = self._replay(self.ordp, self.lenp, self.rows, self.oll,
                               self.orl, self.rkl, *cols)
            ordp, lenp, rows, oll, orl, rkl, ols, ors, err = out
            # Commit only a clean stream: a flagged one is half-applied,
            # and recovery (reshard + replay) needs the pre-stream state.
            err = int(err)
            if not err:
                self.ordp, self.lenp, self.rows = ordp, lenp, rows
                self.oll, self.orl, self.rkl = oll, orl, rkl
                break
            if (err & ERR_CAPACITY) and self.auto_reshard and attempt == 0:
                self.reshards += 1
                self.load(*self.runs())
                continue
            self._record(stats, calls0)
            if err & ERR_CAPACITY:
                raise RuntimeError(
                    "sp shard capacity exhausted; reshard with a larger "
                    "per-shard row budget")
            if err & ERR_BAD_DELETE:
                raise RuntimeError("delete ran past the end of the document")
            if err & ERR_NO_OWNER:
                raise RuntimeError("insert rank beyond the document length")
            if err & ERR_ORDER_MISS:
                raise RuntimeError(
                    "order lookup missed: an op referenced an order absent "
                    "from device state (load_tables missing?)")
        self._record(stats, calls0)
        starts = np.asarray(ops.ins_order_start, np.int64)
        ilens = np.asarray(ops.ins_len, np.int64)
        steps = np.nonzero(ilens > 0)[0]
        ol_np = ols.cpu().numpy().view(np.uint32)
        or_np = ors.cpu().numpy().view(np.uint32)
        for s in steps.tolist():
            self.ol_log[int(starts[s])] = int(ol_np[s])
            self.or_log[int(starts[s])] = int(or_np[s])

    def _record(self, stats: StreamStats, calls0: dict) -> None:
        calls = self.mesh.calls
        stats.collectives = (calls["all_gather"] + calls["sum"]
                             - calls0.get("all_gather", 0)
                             - calls0.get("sum", 0))
        self.last = stats

    def planes(self) -> Dict[str, np.ndarray]:
        """Every shard's state, gathered: ``ordp``/``lenp`` ``[sp * R]``,
        ``rows`` ``[sp]``, ``oll``/``orl``/``rkl`` ``[sp * OTS]`` (int32,
        the JAX ``SpDoc``'s global arrays)."""
        def g(t):
            return self.mesh.all_gather(t).reshape(-1).cpu().numpy()

        return {"ordp": g(self.ordp), "lenp": g(self.lenp),
                "rows": g(self.rows), "oll": g(self.oll),
                "orl": g(self.orl), "rkl": g(self.rkl)}

    def runs(self) -> tuple:
        """Host copy of the global packed runs: (ordp, lenp) 1-D."""
        packed = torch.cat([self.ordp, self.lenp, self.rows])
        g = self.mesh.all_gather(packed).cpu().numpy()
        o = g[:, :self.R]
        ln = g[:, self.R:2 * self.R]
        r = g[:, 2 * self.R]
        return (np.concatenate([o[s, :r[s]] for s in range(self.nsp)]),
                np.concatenate([ln[s, :r[s]] for s in range(self.nsp)]))

    def expand(self) -> np.ndarray:
        """Per-char ±(order+1) column in document order (host)."""
        o, ln = self.runs()
        return expand_runs(o, ln)

    def to_string(self, ops_list) -> str:
        """The content, from the expanded orders and the op streams' char
        logs (the device state stores orders, not text)."""
        chars = {}
        for ops in ops_list:
            ilens = np.asarray(ops.ins_len)
            starts = np.asarray(ops.ins_order_start, np.int64)
            cps = np.asarray(ops.chars)
            for s in np.nonzero(ilens)[0]:
                for j in range(int(ilens[s])):
                    chars[int(starts[s]) + j] = chr(int(cps[s, j]))
        return "".join(chars[int(x) - 1] for x in self.expand() if x > 0)


def expand_runs(ordp: np.ndarray, lenp: np.ndarray) -> np.ndarray:
    """Per-char ±(order+1) column of packed runs (host)."""
    if len(ordp) == 0:
        return np.zeros(0, np.int32)
    o = np.asarray(ordp, np.int64)
    ln = np.asarray(lenp, np.int64)
    if not (ln > 0).all():
        raise AssertionError("occupied run with non-positive length")
    total = int(ln.sum())
    base = np.repeat(np.abs(o), ln)
    within = np.arange(total) - np.repeat(np.cumsum(ln) - ln, ln)
    return (np.repeat(np.sign(o), ln) * (base + within)).astype(np.int32)


__all__ = ["ERR_BAD_DELETE", "ERR_CAPACITY", "ERR_NO_OWNER",
           "ERR_ORDER_MISS", "OP_FIELDS", "SpDoc", "SpReplay",
           "StreamStats", "TAB_UNKNOWN", "drive", "expand_runs",
           "make_sp_apply"]
