"""Run-block replay with the planes in device memory and a two-level live
index, on PyTorch and CUDA (counterpart of
``text_crdt_rust_tpu/ops/rle_hbm.py``).

``ops.rle`` keeps a document's run planes small enough for on-chip memory;
this engine holds millions of run rows. Its two workloads:

- **kevin** (upstream ``benches/yjs.rs:51-62``): 5M single-char prepends
  into one document. Runs cannot merge backwards, so the state is one run
  row per op; the logical-block split keeps the always-at-front insert
  amortised O(1) (slot 0 fills, its top half moves to a fresh physical
  block, slot 0 keeps its physical block);
- **the north star at 1,024 documents**, which ``ops.rle``'s geometry
  would not hold.

Position -> slot is a two-level descent: the ``SUP``-slot segment sums
``supliv`` first, then one 64-slot segment of ``liv``, clamped twice;
``supliv`` is rebuilt in full after every split. The in-block row algebra
(run location, the W-row insert splice, the delete flip and boundary
splits) is ``ops.rle``'s, as the JAX engine imports it. Results are
``RleResult``s, read by ``expand_runs`` and ``rle_to_flat`` as they are.

Two implementations of the replay, held against each other bit for bit:

- ``rle_hbm_replay_plain``: plain PyTorch on ``[K, B]`` tensors, a
  line-for-line translation of ``_rle_hbm_kernel`` with its one-block
  write-back window (``ensure``), its next-slot peek read from the planes
  and its lane-max control scalars;
- ``ops/csrc/rle_hbm_replay.cu``: the hand-written CUDA kernel, one thread
  block per (group, lane), the cached block and the slot tables in shared
  memory.

``rle_hbm_replay`` picks between them by the device of its inputs.

Which rows are outputs: every row of a block the replay used (blocks
``< meta[g, 0]`` of group ``g``), the tables ``blkord``/``rows`` in full,
``meta``, ``err`` and the origins. The JAX engine never writes the planes'
rows of unused blocks; both versions here allocate the planes zeroed, so
those rows read 0 (and the two versions agree on every row).

``store_origins=False`` (kevin at 5M: the per-op origins alone would be
5.1 GB at 128 lanes) keeps no origins: the returned ``ol``/``orr`` are
empty, as the JAX engine's are, and ``rle_to_flat`` refuses such a
result; ``expand_runs`` needs none.
"""
from __future__ import annotations

import ctypes

import torch

from .. import resolve_device
from ..common import ROOT_ORDER
from . import _kernels
from .blocked import _cumsum_rows, _lane_scalar, _require, _shift_rows
from .rle import (
    RleResult,
    _delete_block_math,
    _insert_splice,
    _locate_run,
    _row_scalar,
    _shift_rows_up,
    split_results,
    stage_local_streams,
)
from .span_arrays import u32_bits

I32 = torch.int32

SUP = 64  # logical slots per super-segment (level-2 live index fan-out)

#: Most rows a thread block of the kernel holds (512 threads x 4 rows).
KMAX_KERNEL = 2048
#: Shared memory one thread block may use on an H100 (232,448 bytes).
SMEM_LIMIT = 232448
#: Plane rows compared at a time by ``lanes_equal`` (bounds its temporary).
_ROWS_PER_PASS = 1 << 20


def table_geometry(capacity: int, block_k: int):
    """``(NB, NSUP, NBLp, NSUPp)``: physical blocks, super-segments, the
    slot-table rows (whole segments) and the ``supliv`` rows (>= 8)."""
    NB = capacity // block_k
    NSUP = (NB + SUP - 1) // SUP
    return NB, NSUP, NSUP * SUP, max(8, NSUP)


# -- the plain replay -------------------------------------------------------


class _HbmGroup:
    """One doc group's replay state for ``rle_hbm_replay_plain``: the
    Pallas body's scratch (window, block tables, ``supliv``, ``nlog``) over
    the group's planes."""

    def __init__(self, ordp, lenp, ol, orr, err, K, NB, NSUP, NBL, NSUPp,
                 WMAX):
        B, dev = ordp.shape[1], ordp.device
        self.ordp, self.lenp, self.ol, self.orr, self.err = \
            ordp, lenp, ol, orr, err
        self.K, self.NB, self.NSUP, self.NBL = K, NB, NSUP, NBL
        self.WMAX = WMAX
        self.idx_k = torch.arange(K, dtype=I32, device=dev)[:, None]
        self.idx_l = torch.arange(NBL, dtype=I32, device=dev)[:, None]
        self.idx_s = torch.arange(NSUPp, dtype=I32, device=dev)[:, None]
        self.seg_idx = torch.arange(SUP, dtype=I32, device=dev)[:, None]
        self.blkord = torch.zeros(NBL, B, dtype=I32, device=dev)
        self.rws = torch.zeros_like(self.blkord)
        self.liv = torch.zeros_like(self.blkord)
        self.supliv = torch.zeros(NSUPp, B, dtype=I32, device=dev)
        # Fresh group: one empty block in logical slot 0, cached zeroed.
        self.wo = torch.zeros(K, B, dtype=I32, device=dev)
        self.wl = torch.zeros_like(self.wo)
        self.cached = 0
        self.nlog = 1  # blocks in use

    def _rows(self, b):
        return slice(b * self.K, (b + 1) * self.K)

    def ensure(self, b):
        """Cache physical block ``b`` in the window (write-back: the
        evicted block is always written)."""
        if self.cached != b:
            cb = self._rows(self.cached)
            self.ordp[cb] = self.wo
            self.lenp[cb] = self.wl
            self.wo = self.ordp[self._rows(b)].clone()
            self.wl = self.lenp[self._rows(b)].clone()
            self.cached = b

    def flush(self):
        cb = self._rows(self.cached)
        self.ordp[cb] = self.wo
        self.lenp[cb] = self.wl

    def slot_scalar(self, tbl, l):
        return int(tbl[l].max())

    def bump_liv(self, l, delta):
        self.liv[l] += delta
        self.supliv[l // SUP] += delta

    def resup(self):
        """Rebuild the super-segment sums from ``liv``."""
        segs = self.liv.view(self.NSUP, SUP, -1).sum(dim=1, dtype=I32)
        self.supliv[:self.NSUP] = segs

    def live_before_slot(self, l):
        s = l // SUP
        sup_part = _lane_scalar(torch.where(self.idx_s < s, self.supliv, 0))
        segm = self.liv[s * SUP:(s + 1) * SUP]
        seg_part = _lane_scalar(torch.where(self.seg_idx < (l - s * SUP),
                                            segm, 0))
        return sup_part + seg_part

    def slot_of_live_rank(self, rank1):
        """Two-level descent (upstream ``root.rs:54-88`` over segment
        sums), clamped to the last super-segment and the last slot."""
        NSUP, idx_s = self.NSUP, self.idx_s
        supcum = _cumsum_rows(torch.where(idx_s < NSUP, self.supliv, 0))
        s = min(_lane_scalar(((supcum < rank1) & (idx_s < NSUP)).to(I32)),
                NSUP - 1)
        base = _lane_scalar(torch.where(idx_s < s, self.supliv, 0))
        segcum = _cumsum_rows(self.liv[s * SUP:(s + 1) * SUP])
        within = _lane_scalar((segcum < (rank1 - base)).to(I32))
        return min(s * SUP + within, self.nlog - 1)

    def split(self, l):
        """Leaf split: the cached block's top half moves to a fresh
        physical block spliced into the logical order at ``l+1``; the kept
        half stays cached. At table capacity it is a no-op raising
        ``err[0]``."""
        if self.nlog >= self.NB:
            self.err[0] = 1
            return
        K, idx_k, idx_l = self.K, self.idx_k, self.idx_l
        b = self.slot_scalar(self.blkord, l)
        self.ensure(b)
        r = self.slot_scalar(self.rws, l)
        keep = r // 2
        mv = r - keep
        nb = self.nlog
        bo, bl = self.wo, self.wl
        liv_hi = _lane_scalar(torch.where(
            (idx_k >= keep) & (idx_k < r) & (bo > 0), bl, 0))
        liv_lo = self.slot_scalar(self.liv, l) - liv_hi
        new_mask = idx_k < mv
        self.ordp[self._rows(nb)] = torch.where(
            new_mask, _shift_rows_up(bo, keep, K), 0)
        self.lenp[self._rows(nb)] = torch.where(
            new_mask, _shift_rows_up(bl, keep, K), 0)
        self.wo = torch.where(idx_k < keep, bo, 0)
        self.wl = torch.where(idx_k < keep, bl, 0)
        for name in ("blkord", "rws", "liv"):
            tbl = getattr(self, name)
            setattr(self, name,
                    torch.where(idx_l <= l, tbl, _shift_rows(tbl, 1, 1)))
        self.rws[l] = keep
        self.liv[l] = liv_lo
        self.blkord[l + 1] = nb
        self.rws[l + 1] = mv
        self.liv[l + 1] = liv_hi
        self.nlog += 1
        self.resup()

    def find_insert_slot(self, p):
        l = 0 if p == 0 else self.slot_of_live_rank(p)
        return l, self.slot_scalar(self.rws, l)

    def do_insert(self, k, p, il, st, w):
        K = self.K
        l, r0 = self.find_insert_slot(p)
        if r0 + w + 1 > K:
            self.split(l)
        l, r0 = self.find_insert_slot(p)
        b = self.slot_scalar(self.blkord, l)
        self.ensure(b)
        base = self.live_before_slot(l)
        local = p - base
        bo, bl = self.wo, self.wl
        i_r, o_r, l_r, off = _locate_run(bo, bl, self.idx_k, r0, local)
        left = ROOT_ORDER if p == 0 else (o_r - 1) + (off - 1)
        is_split = p > 0 and off < l_r
        # Raw successor (`doc.rs:452`): within the block, else the next
        # slot's first row, read from the planes (that block is never the
        # cached one: distinct slots hold distinct blocks).
        nxt_in_blk = _row_scalar(bo, i_r + 1)
        need_peek = (p > 0 and not is_split and i_r + 1 >= r0
                     and l + 1 < self.nlog)
        succ_next = 0
        if need_peek:
            b2 = self.slot_scalar(self.blkord, min(l + 1, self.NBL - 1))
            succ_next = int(self.ordp[b2 * K].max())
        succ_p0 = _row_scalar(bo, 0) if r0 > 0 else 0
        if p == 0:
            succ = succ_p0
        elif is_split:
            succ = o_r + off
        else:
            succ = nxt_in_blk if i_r + 1 < r0 else succ_next
        right = ROOT_ORDER if succ == 0 else abs(succ) - 1

        no, nl, amt, _mrg, _sp = _insert_splice(
            bo, bl, self.idx_k, p, i_r, o_r, l_r, off, il, st, w, self.WMAX)
        self.wo, self.wl = no, nl
        self.rws[l] += amt
        self.bump_liv(l, il)
        if self.ol.shape[0]:
            self.ol[k] = u32_bits(left)
            self.orr[k] = u32_bits(right)

    def do_delete(self, p, d):
        K = self.K
        rem, iters = d, 0
        while rem > 0 and iters <= 2 * self.NBL:
            l = self.slot_of_live_rank(p + 1)
            if self.slot_scalar(self.rws, l) + 2 > K:
                self.split(l)
            l = self.slot_of_live_rank(p + 1)
            b = self.slot_scalar(self.blkord, l)
            self.ensure(b)
            base = self.live_before_slot(l)
            no, nl, added, tot = _delete_block_math(
                self.wo, self.wl, self.idx_k, K, base, p, rem)
            self.wo, self.wl = no, nl
            self.rws[l] += added
            self.bump_liv(l, -tot)
            rem -= tot
            iters += 1
        if rem > 0:
            self.err[1] = 1


def _alloc(G, S, B, CAP, NBL, store_origins, dev):
    """The eight outputs, in the JAX layout: origins ``[G, S or 0, B]``
    zeroed, planes zeroed (rows of unused blocks read 0), tables."""
    s_o = S if store_origins else 0
    ol = torch.zeros(G, s_o, B, dtype=I32, device=dev)
    orr = torch.zeros_like(ol)
    ordp = torch.zeros(G * CAP, B, dtype=I32, device=dev)
    lenp = torch.zeros_like(ordp)
    blk_out = torch.zeros(G, NBL, B, dtype=I32, device=dev)
    rows_out = torch.zeros_like(blk_out)
    meta_out = torch.zeros(G, 8, B, dtype=I32, device=dev)
    err = torch.zeros(8, B, dtype=I32, device=dev)
    return ol, orr, ordp, lenp, blk_out, rows_out, meta_out, err


def rle_hbm_replay_plain(pos, dlen, ilen, start, wcol, *, groups: int,
                         steps: int, batch: int, capacity: int, block_k: int,
                         wmax: int, store_origins: bool = True):
    """The plain PyTorch version of ``_rle_hbm_kernel``: replay each
    group's op stream (int32 columns ``[groups*steps]``) on ``[K, B]``
    planes. Returns ``(ol, orr, ordp, lenp, blkord, rows, meta, err)`` in
    the JAX layout on the device of the inputs; ``ol``/``orr`` have 0
    steps when ``store_origins`` is False."""
    G, S, B, CAP, K = groups, steps, batch, capacity, block_k
    NB, NSUP, NBL, NSUPp = table_geometry(CAP, K)
    dev = pos.device
    outs = _alloc(G, S, B, CAP, NBL, store_origins, dev)
    ol, orr, ordp, lenp, blk_out, rows_out, meta_out, err = outs
    cols = [c.cpu().tolist() for c in (pos, dlen, ilen, start, wcol)]
    for g in range(G):
        grp = _HbmGroup(ordp[g * CAP:(g + 1) * CAP],
                        lenp[g * CAP:(g + 1) * CAP], ol[g], orr[g], err,
                        K, NB, NSUP, NBL, NSUPp, wmax)
        for k in range(S):
            i = g * S + k
            p, d, il, st = cols[0][i], cols[1][i], cols[2][i], cols[3][i]
            w = max(cols[4][i], 1)  # no-op pad rows carry 0
            if d > 0:
                grp.do_delete(p, d)
            if il > 0:
                grp.do_insert(k, p, il, st, w)
        grp.flush()
        blk_out[g] = grp.blkord
        rows_out[g] = grp.rws
        meta_out[g, 0] = grp.nlog
    return outs


# -- the CUDA kernel ----------------------------------------------------------

_KERNEL = "rle_hbm_replay"
_LAUNCH = "rle_hbm_replay_launch"
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


def kernel_smem_bytes(block_k: int, nbl: int, nsupp: int) -> int:
    """Shared memory of one thread block, passed to the launcher: the
    window and two scratch rows (K each, twice), the three slot tables,
    ``supliv`` and 40 ints of reduction and broadcast scratch (the layout
    of ``rle_hbm_replay_kernel``'s ``smem``)."""
    return 4 * (4 * block_k + 3 * nbl + nsupp + 40)


def rle_hbm_replay_cuda(pos, dlen, ilen, start, wcol, *, groups: int,
                        steps: int, batch: int, capacity: int, block_k: int,
                        wmax: int, store_origins: bool = True):
    """Launch ``ops/csrc/rle_hbm_replay.cu`` on PyTorch's current stream.
    Same arguments and results as ``rle_hbm_replay_plain``."""
    G, S, B, CAP, K = groups, steps, batch, capacity, block_k
    NB, NSUP, NBL, NSUPp = table_geometry(CAP, K)
    dev = pos.device
    for c in (pos, dlen, ilen, start, wcol):
        _require(c.device == dev and c.dtype == I32 and c.is_contiguous()
                 and c.shape == (G * S,),
                 "op columns must be contiguous int32 [G*S] on one device")
    _require(8 <= K <= KMAX_KERNEL,
             f"block_k must lie in [8, {KMAX_KERNEL}] for the kernel")
    smem = kernel_smem_bytes(K, NBL, NSUPp)
    _require(smem <= SMEM_LIMIT,
             f"the slot tables of {NB} blocks and a {K}-row window need "
             f"{smem} B of shared memory (limit {SMEM_LIMIT}); raise block_k")
    outs = _alloc(G, S, B, CAP, NBL, store_origins, dev)
    fn = _kernels.function(_KERNEL, _LAUNCH, _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(*(t.data_ptr() for t in (pos, dlen, ilen, start, wcol)),
              *(t.data_ptr() for t in outs), G, S, B, CAP, K, NB, NBL, NSUP,
              wmax, int(store_origins), smem, stream)
    _kernels.check(_KERNEL, code)
    _kernels.count_launch(_KERNEL)
    return outs


def rle_hbm_replay(pos, dlen, ilen, start, wcol, **shape):
    """The replay on the device of its inputs: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if pos.device.type == "cpu":
        return rle_hbm_replay_plain(pos, dlen, ilen, start, wcol, **shape)
    if pos.device.type == "cuda":
        return rle_hbm_replay_cuda(pos, dlen, ilen, start, wcol, **shape)
    raise ValueError(f"no replay for device {pos.device}")


# -- the replayer -------------------------------------------------------------


def make_replayer_rle_hbm(
    ops,
    capacity: int,
    batch: int = 128,
    block_k: int = 512,
    chunk: int = 1024,
    store_origins: bool = True,
    device=None,
):
    """The HBM-plane variant of ``rle.make_replayer_rle`` (same contract;
    ``capacity`` counts RUN rows and may reach millions). ``ops`` is one
    local stream or a sequence of them (doc groups). Returns a function of
    no arguments that replays and returns an ``RleResult`` (a list for a
    sequence); ``chunk`` pads the step count to a multiple of itself.

    ``store_origins=False`` keeps no per-op origins (see the module
    docstring): the results' ``ol``/``orr`` are empty."""
    dev = resolve_device(device)
    grouped, lens, staged, shape = stage_local_streams(
        ops, "rle_hbm", capacity, block_k, chunk, dev)
    shape.update(batch=batch, store_origins=store_origins)

    def run():
        return split_results(rle_hbm_replay(*staged, **shape), grouped,
                             lens, capacity, block_k, batch, store_origins)

    run.staged = staged
    run.shape = shape
    return run


def replay_local_rle_hbm(ops, capacity: int, **kw):
    """One-shot convenience wrapper over ``make_replayer_rle_hbm``."""
    return make_replayer_rle_hbm(ops, capacity, **kw)()


def used_rows(res: RleResult) -> int:
    """Plane rows of the blocks a replay used (``meta[0]`` x K): the rows
    that are outputs."""
    return int(res.meta[0].max()) * res.block_k


def lanes_equal(res: RleResult) -> bool:
    """Every lane equals lane 0: the planes over the used blocks (a few
    row ranges at a time, so no full-size temporary is made), the tables,
    ``meta`` and the origins."""
    n = used_rows(res)
    for plane in (res.ordp, res.lenp):
        for lo in range(0, n, _ROWS_PER_PASS):
            part = plane[lo:min(lo + _ROWS_PER_PASS, n)]
            if not bool((part == part[:, :1]).all()):
                return False
    return all(bool((t == t[:, :1]).all())
               for t in (res.blkord, res.rows, res.meta, res.ol, res.orr))
