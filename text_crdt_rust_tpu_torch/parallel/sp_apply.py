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
upkeep — as shard-local torch work on the rank's ``[R]`` rows and ``[OTS]``
table slice between the mesh's collectives (``parallel/mesh.py``):

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

What differs from the JAX program, without changing a result bit:

- the op stream is host data replicated on every rank, so a phase that the
  step's kind and lengths switch off is skipped on the host (the JAX scan
  runs it masked, as a no-op, with its collectives);
- the scalars one JAX phase psums apart ride one sum here, and the remote
  insert's probes reuse the raw carry computed when the scan starts (the
  scan mutates nothing), where the JAX program all-gathers it again;
- the integrate loop's predicate is read to the host once an iteration
  (``.item()``); it is computed from collective results only, so every rank
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
from .mesh import Mesh
from .sp_runs import carry_of, cumsum32, first_true, pick, sum32, take

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
    """One rank's state during a stream and the phases of a step."""

    def __init__(self, mesh: Mesh, R: int, OTS: int, ordp, lenp, nrows,
                 oll, orl, rkl):
        self.mesh, self.R, self.OTS = mesh, R, OTS
        dev = ordp.device
        self.sidx = mesh.index("sp")
        self.idx = torch.arange(R, dtype=I32, device=dev)
        self.tab_base = self.sidx * OTS
        self.tab_g = self.tab_base + torch.arange(OTS, dtype=I32, device=dev)
        self.ordp, self.lenp, self.nrows = ordp, lenp, nrows
        self.oll, self.orl, self.rkl = oll, orl, rkl
        self.err = torch.zeros((), dtype=I32, device=dev)

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

    def cursor_after(self, o, need, raw_carry, rawcum):
        """The replicated raw cursor just after order ``o`` (0 for ROOT),
        flagging an unknown or absent order when ``need``."""
        is_root = o == ROOT_I
        self.err = self.err | _flag(need & (o == TAB_UNKNOWN),
                                    ERR_ORDER_MISS)
        p, f = self.raw_pos_terms(torch.clamp(o, min=0), raw_carry, rawcum)
        red = self.mesh.sum(torch.stack([p, f]).to(I32))
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

    def do_delete(self, p: int, d: int):
        """Local delete of live span [p, p+d): every shard retires its
        intersection in one clip pass."""
        ordp, lenp = self.ordp, self.lenp
        lv = torch.where(ordp > 0, lenp, 0)
        local = cumsum32(lv)
        carry, _ = carry_of(self.mesh, local[-1])
        before = carry + local - lv
        cs = torch.minimum((p - before).clamp(min=0), lv)
        ce = torch.minimum((p + d - before).clamp(min=0), lv)
        cov = ce - cs
        covered = self.mesh.sum(sum32(cov))
        self.err = self.err | _flag(covered < d, ERR_BAD_DELETE)
        full = (cov > 0) & (cov == lenp)
        part = (cov > 0) & ~full
        self.clip_and_split(full, part, cs, ce)

    def do_insert(self, p: int, il: int, st: int):
        """Local insert at live rank ``p``: the owner shard splices; the
        discovered origins reach every shard in one sum. Returns
        (left origin, right origin, active anywhere)."""
        R, idx, sidx = self.R, self.idx, self.sidx
        ordp, lenp, nrows = self.ordp, self.lenp, self.nrows
        lv = torch.where(ordp > 0, lenp, 0)
        local = cumsum32(lv)
        head = torch.where(nrows > 0, ordp[0], 0)
        g = self.mesh.all_gather(torch.stack([local[-1], head]))  # [sp, 2]
        totals, heads = g[:, 0], g[:, 1]
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
        amt = torch.where(~active | mrg, 0, torch.where(is_split, 2, 1))
        so = _shift2(ordp, amt)
        sl = _shift2(lenp, amt)
        no = torch.where(idx < ins_at, ordp, so)
        nl = torch.where(idx < ins_at, lenp, sl)
        nl = torch.where(active & is_split & (idx == i_r), off, nl)
        new_run = active & ~mrg & (idx == ins_at)
        no = torch.where(new_run, st + 1, no)
        nl = torch.where(new_run, il, nl)
        tail = active & is_split & (idx == ins_at + 1)
        no = torch.where(tail, o_r + off, no)
        nl = torch.where(tail, l_r - off, nl)
        nl = torch.where(active & mrg & (idx == i_r), l_r + il, nl)
        self.ordp, self.lenp = no, nl
        self.nrows = nrows + amt

        red = self.mesh.sum(torch.stack([
            owner.to(I32), torch.where(active, left, 0).to(I32),
            torch.where(active, right, 0).to(I32), active.to(I32)]))
        self.err = (self.err | _flag(red[0] == 0, ERR_NO_OWNER)
                    | _flag(owner & cap_bad, ERR_CAPACITY))
        any_act = red[3] > 0
        return (torch.where(any_act, red[1], 0),
                torch.where(any_act, red[2], 0), any_act)

    def do_remote_delete(self, t: int, d: int):
        """Order-interval tombstone of [t, t+d) (`doc.rs:295-340`): covered
        dead runs count toward the idempotency total without flipping
        (`double_delete.rs:6-9`)."""
        ordp, lenp = self.ordp, self.lenp
        so = ordp.abs() - 1
        occ = ordp != 0
        cs = torch.minimum((t - so).clamp(min=0), lenp)
        ce = torch.minimum((t + d - so).clamp(min=0), lenp)
        cov = torch.where(occ, ce - cs, 0)
        covered = self.mesh.sum(sum32(cov))
        self.err = self.err | _flag(covered < d, ERR_BAD_DELETE)
        live = ordp > 0
        full = live & (cov > 0) & (cov == lenp)
        part = live & (cov > 0) & ~(cov == lenp)
        # Max growth is +2: one run holding both endpoints 3-way splits,
        # or the two endpoint runs each split one-sided.
        self.clip_and_split(full, part, cs, ce)

    def integrate(self, my_rank: int, o_left: int, o_right: int):
        """The YATA conflict scan (`doc.rs:183-222`) with the scan state
        replicated; conflict-free ops leave on the first probe
        (`doc.rs:192-194`). Returns (cursor, raw cumsum, raw carry)."""
        R, idx, mesh = self.R, self.idx, self.mesh
        ordp, lenp, nrows = self.ordp, self.lenp, self.nrows
        rawcum = cumsum32(lenp)
        carry, totals = carry_of(mesh, rawcum[-1])
        n = sum32(totals)
        yes = torch.ones((), dtype=torch.bool, device=ordp.device)
        left_cursor = self.cursor_after(
            torch.tensor(o_left, dtype=I32, device=ordp.device), yes, carry,
            rawcum)
        cursor, scan_start = left_cursor, left_cursor
        scanning = torch.zeros_like(yes)
        done = torch.zeros_like(yes)
        while bool(~done & (cursor < n)):
            own = (cursor >= carry) & (cursor < carry + rawcum[-1])
            local = cursor - carry
            i_r = sum32((rawcum <= local) & (idx < nrows)).clamp(max=R - 1)
            red = mesh.sum(torch.stack([
                torch.where(own, pick(ordp, i_r), 0),
                torch.where(own, pick(lenp, i_r), 0),
                torch.where(own, local - (pick(rawcum, i_r)
                                          - pick(lenp, i_r)), 0)]))
            o_r, l_r, off = red[0], red[1], red[2]
            so = o_r.abs() - 1
            other_order = so + off
            tabs = mesh.sum(torch.stack([
                self.tab_local(self.oll, other_order),
                self.tab_local(self.orl, other_order),
                self.tab_local(self.rkl, other_order)]))
            other_left, other_right, other_rank = tabs[0], tabs[1], tabs[2]
            olc = self.cursor_after(other_left, ~done, carry, rawcum)
            brk = (other_order == o_right) | (olc < left_cursor)
            eq = ~brk & (olc == left_cursor)
            gt = my_rank > other_rank
            brk = brk | (eq & ~gt & (o_right == other_right))
            starts_scan = eq & ~gt & (o_right != other_right)
            scan_start = torch.where(starts_scan & ~scanning, cursor,
                                     scan_start)
            scanning = torch.where(
                eq, torch.where(gt, False,
                                torch.where(o_right == other_right,
                                            scanning, True)),
                scanning)
            contains_right = (o_right > other_order) & (o_right < so + l_r)
            stp = torch.where(contains_right, o_right - other_order,
                              l_r - off)
            cursor = torch.where(brk, cursor, cursor + stp)
            done = done | brk
        return torch.where(scanning, scan_start, cursor), rawcum, carry

    def do_remote_insert(self, my_rank: int, o_left: int, o_right: int,
                         il: int, st: int):
        """`doc.rs:274-293` sharded: integrate to a raw position, splice on
        the owner shard (a tombstone-sign-preserving tail; the merge gated
        on the origin chain), report whether it applied."""
        R, idx, sidx = self.R, self.idx, self.sidx
        c, rawcum, carry = self.integrate(my_rank, o_left, o_right)
        ordp, lenp, nrows = self.ordp, self.lenp, self.nrows
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
        amt = torch.where(~active | mrg, 0, torch.where(is_split, 2, 1))
        so_s = _shift2(ordp, amt)
        sl_s = _shift2(lenp, amt)
        no = torch.where(idx < ins_at, ordp, so_s)
        nl = torch.where(idx < ins_at, lenp, sl_s)
        nl = torch.where(active & is_split & (idx == i_r), off, nl)
        new_run = active & ~mrg & (idx == ins_at)
        no = torch.where(new_run, st + 1, no)
        nl = torch.where(new_run, il, nl)
        tail = active & is_split & (idx == ins_at + 1)
        tail_o = torch.where(o_r > 0, o_r + off, o_r - off)
        no = torch.where(tail, tail_o, no)
        nl = torch.where(tail, l_r - off, nl)
        nl = torch.where(active & mrg & (idx == i_r), l_r + il, nl)
        self.ordp, self.lenp = no, nl
        self.nrows = nrows + amt
        red = self.mesh.sum(torch.stack([owner.to(I32), active.to(I32)]))
        self.err = (self.err | _flag(red[0] == 0, ERR_NO_OWNER)
                    | _flag(owner & cap_bad, ERR_CAPACITY))
        return red[1] > 0

    def step(self, kd, p, d, t, olv, orv, rk, il, st):
        """One op (host ints); returns its (origin_left, origin_right) log
        entries as 0-dim tensors, or None for a step that inserts
        nothing (its entries are 0)."""
        if kd == KIND_LOCAL and d > 0:
            self.do_delete(p, d)
        li = ri = None
        if kd == KIND_LOCAL and il > 0:
            li = self.do_insert(p, il, st)
        if kd == KIND_REMOTE_DEL and d > 0:
            self.do_remote_delete(t, d)
        if kd == KIND_REMOTE_INS and il > 0:
            ri = self.do_remote_insert(rk, olv, orv, il, st)
        if li is None and ri is None:
            return None
        # Table upkeep (replicated values, masked to the order-range
        # owners): a local insert records the origins it discovered, a
        # remote insert its given ones; a capacity-blocked splice records
        # nothing.
        if li is not None:
            ol1, or1, ins_on = li
            head_ol, run_or = ol1, or1
        else:
            ins_on = ri
            head_ol = torch.where(ri, olv, 0).to(I32)
            run_or = torch.where(ri, orv, 0).to(I32)
        self.oll = torch.where(ins_on, self.tab_write_chain(
            self.oll, st, il, head_ol), self.oll)
        self.orl = torch.where(ins_on, self.tab_write_run(
            self.orl, st, il, run_or), self.orl)
        self.rkl = torch.where(ins_on, self.tab_write_run(
            self.rkl, st, il, rk), self.rkl)
        return head_ol, run_or


class SpReplay:
    """The sharded full-surface replayer of one ``(mesh, R, OTS)``
    geometry (``make_sp_apply``)."""

    def __init__(self, mesh: Mesh, R: int, OTS: int):
        self.mesh, self.R, self.OTS = mesh, R, OTS

    def __call__(self, ordp, lenp, rows, oll, orl, rkl, *cols):
        """Apply op columns (``OP_FIELDS`` order, host int32 ``[S]``,
        every rank the same) to this rank's state: ``ordp``/``lenp``
        ``[R]``, ``rows`` ``[1]``, ``oll``/``orl``/``rkl`` ``[OTS]``.
        Returns (new state ..., origin-left log ``[S]``, origin-right log
        ``[S]``, error bits ORed over the group); the logs are int32
        tensors holding u32 bits, 0 on steps that insert nothing."""
        sh = _Shard(self.mesh, self.R, self.OTS, ordp, lenp, rows[0], oll,
                    orl, rkl)
        cols = np.stack([np.asarray(c, np.int32) for c in cols])
        S = cols.shape[1]
        dev = ordp.device
        logs = {}
        for s, op in enumerate(cols.T.tolist()):
            out = sh.step(*op)
            if out is not None:
                logs[s] = out
        ols = torch.zeros(S, dtype=I32, device=dev)
        ors = torch.zeros(S, dtype=I32, device=dev)
        if logs:
            at = torch.tensor(list(logs), dtype=torch.int64, device=dev)
            ols[at] = torch.stack([v[0] for v in logs.values()]).to(I32)
            ors[at] = torch.stack([v[1] for v in logs.values()]).to(I32)
        err = self.mesh.bor(sh.err.reshape(1))[0]
        return (sh.ordp, sh.lenp, sh.nrows.reshape(1), sh.oll, sh.orl,
                sh.rkl, ols, ors, err)


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
           "StreamStats", "TAB_UNKNOWN", "expand_runs", "make_sp_apply"]
