"""Judge a run-block replay's outputs (kernel A1's layout) against the
plain reference, every document of every group.

The outputs, per doc group, as the port's ``RleResult`` holds them (all
int32, one column a document): ``ordp``/``lenp`` ``[CAP, B]`` run rows
(order + 1, negated when deleted, and the run's length) in physical
blocks of ``K`` rows; ``blkord``/``rows`` ``[NBL, B]``, the physical
block and the rows in use of each logical slot; ``meta[0]``, the slots
in use; ``ol``/``orr`` ``[S, B]``, each step's origins as u32 bits;
``err`` ``[8, B]``, the error flags. A document is read by walking its
slots in order, so its runs are its characters in document order; it is
right when those characters, merged into the fewest runs, are the
reference's runs. Each step that inserts emits the origins of its first
character (order ``start``), which must be the reference's for that
order.

Only this module reads the layout; the reference knows nothing of it.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.splice import Expected

I64 = torch.int64
#: Lanes judged together: a ``[CAP, lanes]`` int64 tensor stays near this
#: many elements.
ELEMENTS = 1 << 24


def _u32_as_i32(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.uint32).view(np.int32).astype(np.int64)


def runs_wrong(res, want_o: torch.Tensor, want_l: torch.Tensor,
               lanes: slice) -> torch.Tensor:
    """Bool ``[lanes]``: the document's state is not the reference's."""
    K, NB = int(res.block_k), int(res.num_blocks)
    CAP = NB * K
    o = res.ordp[:CAP, lanes].to(I64)
    ln = res.lenp[:CAP, lanes].to(I64)
    blk = res.blkord[:, lanes].to(I64)
    rws = res.rows[:, lanes].to(I64)
    nlog = res.meta[0, lanes].to(I64)
    NBL, B = blk.shape
    dev = o.device
    slot = torch.arange(NBL, device=dev)[:, None].expand(NBL, B)
    used = slot < nlog[None, :]
    bad = (nlog < 1) | (nlog > NB)
    bad |= (used & ((blk < 0) | (blk >= NB) | (rws < 0) | (rws > K))).any(0)
    # Physical block -> its logical slot; a block named twice is a fault.
    tgt = torch.where(used, blk.clamp(0, NB - 1), NB)
    seen = torch.zeros(NB + 1, B, dtype=I64, device=dev)
    seen.scatter_add_(0, tgt, torch.ones_like(tgt))
    bad |= (seen[:NB] > 1).any(0)
    slot_of = torch.full((NB + 1, B), -1, dtype=I64, device=dev)
    slot_of.scatter_(0, tgt, slot.contiguous())
    row_slot = slot_of[:NB].repeat_interleave(K, dim=0)          # [CAP, B]
    j = torch.arange(CAP, device=dev)[:, None] % K
    row_rws = rws.gather(0, row_slot.clamp(min=0))
    valid = (row_slot >= 0) & (j < row_rws)
    big = torch.iinfo(I64).max
    perm = torch.where(valid, row_slot * K + j, big).argsort(dim=0)
    o, ln = o.gather(0, perm), ln.gather(0, perm)
    del perm, row_slot, row_rws, j
    n_rows = valid.sum(0)
    v = torch.arange(CAP, device=dev)[:, None] < n_rows[None, :]
    bad |= (v & ((ln <= 0) | (o == 0))).any(0)
    # Merge the rows into the fewest runs and compare run by run.
    cont = torch.zeros_like(v)
    cont[1:] = ((torch.sign(o[1:]) == torch.sign(o[:-1]))
                & (o[1:].abs() == o[:-1].abs() + ln[:-1]))
    head = v & ~cont
    M = int(want_o.numel())
    rid = head.to(I64).cumsum(0) - 1
    bad |= head.sum(0) != M
    rid = torch.where(v & (rid < M), rid, M)
    got_o = torch.zeros(M + 1, B, dtype=I64, device=dev)
    got_o.scatter_(0, torch.where(head, rid, M), o)
    got_l = torch.zeros(M + 1, B, dtype=I64, device=dev)
    got_l.scatter_add_(0, rid, torch.where(v, ln, 0))
    bad |= (got_o[:M] != want_o[:, None]).any(0)
    bad |= (got_l[:M] != want_l[:, None]).any(0)
    return bad


def judge(results, steps, expected) -> dict:
    """Count the documents whose state, whose origins or whose error
    flags are wrong. ``results``: one output set a doc group; ``steps``:
    each group's ``(start, ins_len)`` columns (numpy, one entry a step of
    the stream the replay ran); ``expected``: each group's
    ``Expected``. Also counts the inserted orders that the steps do not
    cover exactly once (the compiler's steps against the reference)."""
    docs = docs_wrong = origins_wrong = uncovered = 0
    flags = None
    for res, (start, ilen), exp in zip(results, steps, expected):
        exp: Expected
        dev = res.ordp.device
        starts, lens = exp.runs()
        want_o = torch.from_numpy(starts).to(dev)
        want_l = torch.from_numpy(lens).to(dev)
        start = np.asarray(start, np.int64)
        ilen = np.asarray(ilen, np.int64)
        ins = np.flatnonzero(ilen > 0)
        cover = np.zeros(exp.orders + 1, np.int64)
        ok_range = (start[ins] >= 0) & (start[ins] + ilen[ins] <= exp.orders)
        for s, n in zip(start[ins][ok_range], ilen[ins][ok_range]):
            cover[s:s + n] += 1
        uncovered += int((cover[:-1] != exp.inserted).sum()) + \
            int((~ok_range).sum())
        heads = np.clip(start[ins], 0, max(exp.orders - 1, 0))
        want_ol = torch.from_numpy(_u32_as_i32(exp.ol[heads])).to(dev)
        want_or = torch.from_numpy(_u32_as_i32(exp.orr[heads])).to(dev)
        ins_t = torch.from_numpy(ins).to(dev)
        B = res.ordp.shape[1]
        CAP = int(res.block_k) * int(res.num_blocks)
        step = max(1, ELEMENTS // max(CAP, 1))
        for lo in range(0, B, step):
            lanes = slice(lo, min(B, lo + step))
            docs_wrong += int(runs_wrong(res, want_o, want_l, lanes).sum())
            ol = res.ol[:, lanes].to(I64).index_select(0, ins_t)
            orr = res.orr[:, lanes].to(I64).index_select(0, ins_t)
            if ol.shape[0] != len(ins) or orr.shape[0] != len(ins):
                origins_wrong += lanes.stop - lanes.start
                continue
            origins_wrong += int(((ol != want_ol[:, None])
                                  | (orr != want_or[:, None])).any(0).sum())
        docs += B
        f = (res.err != 0).any(0)
        flags = f if flags is None else flags | f
    return {"docs": docs, "docs_wrong": docs_wrong,
            "origins_wrong": origins_wrong,
            "flags_set": int(flags.sum()) if flags is not None else 0,
            "orders_uncovered": uncovered}
