"""Run-length blocked replay engine on PyTorch and CUDA (counterpart of
``text_crdt_rust_tpu/ops/rle.py``).

Device state is the RLE run, not the character: two planes, ``ordp`` =
±(start_order+1) (sign = live / tombstone, 0 = empty slot) and ``lenp`` =
run char length, packed into blocks of ``K`` rows. A logical block table
(``blkord``) orders the physical blocks, with per-slot run counts
(``rws``), live-char counts (``liv``) and their inclusive prefix
(``cumliv``). Position -> slot is a masked scan over ``cumliv``, position
-> run one in-block live cumsum. An insert splices at most ``w + 2`` rows
(``fused_splice_rows``), a delete flips covered runs and splits at most
two boundary runs per block, and a full block SPLITS into a fresh
physical block spliced into the logical order. Every insert emits its
run-head ``origin_left`` and raw-successor ``origin_right``.

Documents batch in the lane dimension (every lane replays the same
stream); divergent doc GROUPS form a leading dimension, each group its
own stream.

Two implementations of the replay, held against each other bit for bit:

- ``rle_replay_plain``: plain PyTorch, vectorised over lanes on ``[K, B]``
  planes as the Pallas body ``_rle_kernel`` is, with its circular rolls
  (``torch.roll``) and lane-max control scalars;
- ``ops/csrc/rle_replay.cu``: the hand-written CUDA kernel, one thread
  block per (group, lane).

``rle_replay`` picks between them by the device of its inputs: the plain
version for CPU tensors, the kernel for CUDA tensors (it launches or
raises; it never falls back).

Results keep the JAX package's layout: ``ordp``/``lenp`` ``[G*CAP, B]``,
``blkord``/``rows`` ``[G, NBLp, B]``, ``meta`` ``[G, 8, B]``, ``ol``/``orr``
``[G, S, B]`` and ``err`` ``[8, B]``, all int32 (origins are u32 bits).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..common import ROOT_ORDER
from . import _kernels
from .batch import (
    KIND_LOCAL,
    OpTensors,
    fused_width_checked,
    merge_fused_origins,
    prefill_logs,
)
from .blocked import (
    _cumsum_rows,
    _lane_scalar,
    _require,
    _roll_amount,
    _row_scalar,
    _shift_rows,
)
from .span_arrays import FlatDoc, make_flat_doc, u32_bits

I32 = torch.int32


# -- plain PyTorch helpers (the Pallas body's arithmetic, row for row) --------


def _shift_rows_up(x: torch.Tensor, amount: int, max_amount: int) -> torch.Tensor:
    """Rows shifted toward LOWER indices by ``amount`` (out[j] =
    x[j + amount]), circularly, as the JAX package's per-bit rolls are."""
    return torch.roll(x, -_roll_amount(amount, max_amount, x.shape[0]), 0)


def _locate_run(bo, bl, idx_k, r0: int, local: int):
    """Find the run containing live char #``local`` (1-based) in a block:
    returns ``(i_r, o_r, l_r, off)`` — row index, ±(order+1), length and
    the 1-based char offset within the run."""
    lv = torch.where(bo > 0, bl, 0)
    cum = _cumsum_rows(lv)
    i_r = _lane_scalar(((cum < local) & (idx_k < r0)).to(I32))
    o_r = _row_scalar(bo, i_r)
    l_r = _row_scalar(bl, i_r)
    off = local - (_row_scalar(cum, i_r) - _row_scalar(lv, i_r))
    return i_r, o_r, l_r, off


def fused_splice_rows(bo, bl, idx, p: int, i_r: int, o_r: int, l_r: int,
                      off: int, il: int, st: int, w: int, wmax: int, shift):
    """The W-row fused-splice arithmetic for lane-shared control scalars.

    ``w`` run rows of stride ``L = il // w`` land in ONE shift; row j of
    the spliced window holds orders ``st + il - (j+1)*L`` (a same-position
    burst prepends each patch before the previous one). ``w == 1`` is the
    plain splice. The append-merge path is w==1-only. ``shift`` is the
    row-shift primitive (``_shift_rows``). Returns ``(no, nl, amt, mrg,
    is_split, lrun)``.

    The JAX package's optional per-lane ``active`` mask belongs to the
    divergent-lanes kernels and comes with their slice."""
    lrun = il // max(w, 1)
    mrg = (w == 1) and p > 0 and off == l_r and (st + 1) == (o_r + l_r)
    is_split = p > 0 and off < l_r
    ins_at = 0 if p == 0 else i_r + 1
    amt = 0 if mrg else w + int(is_split)
    so = shift(bo, amt, wmax + 1)
    sl = shift(bl, amt, wmax + 1)
    keep = idx < ins_at
    no = torch.where(keep, bo, so)
    nl = torch.where(keep, bl, sl)
    if is_split:
        nl = torch.where(idx == i_r, off, nl)
    if not mrg:
        new_run = (idx >= ins_at) & (idx < ins_at + w)
        no = torch.where(new_run, st + il - (idx - ins_at + 1) * lrun + 1, no)
        nl = torch.where(new_run, lrun, nl)
    if is_split:
        tail = idx == ins_at + w
        no = torch.where(tail, o_r + off, no)
        nl = torch.where(tail, l_r - off, nl)
    if mrg:
        nl = torch.where(idx == i_r, l_r + il, nl)
    return no, nl, amt, mrg, is_split, lrun


def _insert_splice(bo, bl, idx_k, p, i_r, o_r, l_r, off, il, st,
                   w: int = 1, wmax: int = 1):
    """In-register insert splice: at most ``w + 2`` touched rows
    regardless of ``il``. Returns ``(no, nl, amt, mrg, is_split)``."""
    no, nl, amt, mrg, is_split, _lrun = fused_splice_rows(
        bo, bl, idx_k, p, i_r, o_r, l_r, off, il, st, w, wmax, _shift_rows)
    return no, nl, amt, mrg, is_split


def _split_piece_aux(aux, idx_k, i_p: int, amt: int, w1, w2, so0: int,
                     s_off: int, e_off: int, has_head: bool):
    """Aux-plane transform of a 3-way run split ([head?] [mid] [tail?]):
    pieces after the first chain to their own predecessor char, their
    origin-right is poisoned with -2 and rank is inherited. ``so0`` is
    the run's 0-based start order; pieces begin at ``so0 + s_off`` /
    ``so0 + e_off``. Returns the three transformed planes."""
    olp_b, orp_b, rkp_b = aux
    t_rk = _row_scalar(rkp_b, i_p)
    sent = -2
    p1_ol = so0 + s_off - 1 if has_head else so0 + e_off - 1
    p2_ol = so0 + e_off - 1
    out = []
    for a, v1, v2 in ((olp_b, p1_ol, p2_ol), (orp_b, sent, sent),
                      (rkp_b, t_rk, t_rk)):
        na = torch.where(idx_k <= i_p, a, _shift_rows(a, amt, 2))
        na = torch.where(w1, v1, na)
        na = torch.where(w2, v2, na)
        out.append(na)
    return tuple(out)


def _delete_block_math(bo, bl, idx_k, K: int, base: int, p: int, rem: int,
                       aux=None):
    """One delete iteration over one block: flip fully-covered runs,
    split at most the two boundary runs. Returns ``(no, nl, added_rows,
    covered)``, plus the transformed ``aux`` planes (origin-left,
    origin-right, rank) as a 5th element when given."""

    def apply_partial(active, i_p, cs, ce, bo, bl, aux):
        if not active:
            return bo, bl, 0, aux
        o = _row_scalar(bo, i_p)
        ln = _row_scalar(bl, i_p)
        cs_i = _row_scalar(cs, i_p)
        ce_i = _row_scalar(ce, i_p)
        cov_i = ce_i - cs_i
        has_head = cs_i > 0
        has_tail = ce_i < ln
        amt = int(has_head) + int(has_tail)
        so = _shift_rows(bo, amt, 2)
        sl = _shift_rows(bl, amt, 2)
        no = torch.where(idx_k <= i_p, bo, so)
        nl = torch.where(idx_k <= i_p, bl, sl)
        # Part layout: [head?] [tombstone mid] [tail?]; the tombstone
        # start encodes as -(o + cs) per the ±(order+1) convention.
        p0o = o if has_head else -(o + cs_i)
        p0l = cs_i if has_head else cov_i
        p1o = -(o + cs_i) if has_head else o + ce_i
        p1l = cov_i if has_head else ln - ce_i
        w0 = idx_k == i_p
        no = torch.where(w0, p0o, no)
        nl = torch.where(w0, p0l, nl)
        w1 = (idx_k == i_p + 1) & (amt >= 1)
        no = torch.where(w1, p1o, no)
        nl = torch.where(w1, p1l, nl)
        w2 = (idx_k == i_p + 2) & (amt == 2)
        no = torch.where(w2, o + ce_i, no)
        nl = torch.where(w2, ln - ce_i, nl)
        if aux is None:
            return no, nl, amt, None
        # Partial covers only reach LIVE runs: o > 0, start order o-1.
        return no, nl, amt, _split_piece_aux(
            aux, idx_k, i_p, amt, w1, w2, o - 1, cs_i, ce_i, has_head)

    lv = torch.where(bo > 0, bl, 0)
    cum = _cumsum_rows(lv)
    before = base + cum - lv
    cs = torch.minimum(torch.clamp(p - before, min=0), lv)
    ce = torch.minimum(torch.clamp(p + rem - before, min=0), lv)
    cov = ce - cs
    tot = _lane_scalar(cov)
    full = (cov > 0) & (cov == bl)
    part = (cov > 0) & ~full
    npart = _lane_scalar(part.to(I32))
    i1 = int(torch.where(part, idx_k, K).min(dim=0).values.max())
    i2 = int(torch.where(part, idx_k, -1).max(dim=0).values.max())

    bo = torch.where(full, -bo, bo)
    # Higher-index boundary first so i1's row index stays valid.
    bo, bl, a2, aux = apply_partial(npart >= 1, i2, cs, ce, bo, bl, aux)
    bo, bl, a1, aux = apply_partial(npart == 2, i1, cs, ce, bo, bl, aux)
    if aux is None:
        return bo, bl, a1 + a2, tot
    return bo, bl, a1 + a2, tot, aux


# -- the plain replay -----------------------------------------------------------


class _PlainGroup:
    """One doc group's replay state for ``rle_replay_plain``: the Pallas
    body's scratch (block tables, ``nlog``) over the group's planes."""

    def __init__(self, ordp, lenp, ol, orr, err, K, NB, NBL, WMAX):
        B, dev = ordp.shape[1], ordp.device
        self.ordp, self.lenp, self.ol, self.orr, self.err = \
            ordp, lenp, ol, orr, err
        self.K, self.NB, self.NBL, self.WMAX = K, NB, NBL, WMAX
        self.idx_k = torch.arange(K, dtype=I32, device=dev)[:, None]
        self.idx_l = torch.arange(NBL, dtype=I32, device=dev)[:, None]
        self.blkord = torch.zeros(NBL, B, dtype=I32, device=dev)
        self.rws = torch.zeros_like(self.blkord)
        self.liv = torch.zeros_like(self.blkord)
        self.cumliv = torch.zeros_like(self.blkord)
        self.nlog = 1  # blocks in use (logical slots == physical blocks)

    def block(self, b):
        K = self.K
        return (self.ordp[b * K:(b + 1) * K].clone(),
                self.lenp[b * K:(b + 1) * K].clone())

    def store(self, b, no, nl):
        K = self.K
        self.ordp[b * K:(b + 1) * K] = no
        self.lenp[b * K:(b + 1) * K] = nl

    def slot_scalar(self, tbl, l):
        return int(tbl[l].max()) if 0 <= l < self.NBL else 0

    def live_before_slot(self, l):
        return self.slot_scalar(self.cumliv, l) - self.slot_scalar(self.liv, l)

    def slot_of_live_rank(self, rank1):
        """Smallest logical slot whose inclusive live prefix reaches
        ``rank1``; slots >= nlog may hold stale values and are masked."""
        hit = (self.cumliv < rank1) & (self.idx_l < self.nlog)
        return min(_lane_scalar(hit.to(I32)), self.nlog - 1)

    def split(self, l):
        """Leaf split: move the top half of slot ``l``'s rows to a fresh
        physical block spliced in at logical slot ``l+1``. At table
        capacity it is a no-op that raises ``err[0]``."""
        if self.nlog >= self.NB:
            self.err[0] = 1
            return
        K, idx_k, idx_l = self.K, self.idx_k, self.idx_l
        b = self.slot_scalar(self.blkord, l)
        r = self.slot_scalar(self.rws, l)
        keep = r // 2
        mv = r - keep
        nb = self.nlog  # fresh physical block id
        bo, bl = self.block(b)
        liv_hi = _lane_scalar(torch.where(
            (idx_k >= keep) & (idx_k < r) & (bo > 0), bl, 0))
        liv_lo = self.slot_scalar(self.liv, l) - liv_hi
        up_o = _shift_rows_up(bo, keep, K)
        up_l = _shift_rows_up(bl, keep, K)
        new_mask = idx_k < mv
        self.store(nb, torch.where(new_mask, up_o, 0),
                   torch.where(new_mask, up_l, 0))
        keep_mask = idx_k < keep
        self.store(b, torch.where(keep_mask, bo, 0),
                   torch.where(keep_mask, bl, 0))
        # Splice the new block into the logical order at slot l+1; the
        # circular roll leaves stale entries past nlog, as on the TPU.
        for name in ("blkord", "rws", "liv", "cumliv"):
            tbl = getattr(self, name)
            setattr(self, name,
                    torch.where(idx_l <= l, tbl, _shift_rows(tbl, 1, 1)))
        self.rws[l] = keep
        self.liv[l] = liv_lo
        self.cumliv[l] -= liv_hi
        self.blkord[l + 1] = nb
        self.rws[l + 1] = mv
        self.liv[l + 1] = liv_hi
        self.nlog += 1

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
        base = self.live_before_slot(l)
        local = p - base
        bo, bl = self.block(b)
        i_r, o_r, l_r, off = _locate_run(bo, bl, self.idx_k, r0, local)
        no, nl, amt, _mrg, is_split = _insert_splice(
            bo, bl, self.idx_k, p, i_r, o_r, l_r, off, il, st, w, self.WMAX)

        left = ROOT_ORDER if p == 0 else (o_r - 1) + (off - 1)
        # Raw successor (`doc.rs:452`: tombstones not skipped), read from
        # the PRE-splice block.
        nxt_in_blk = _row_scalar(bo, i_r + 1)  # 0 past the last row
        b2 = self.slot_scalar(self.blkord, min(l + 1, self.NBL - 1))
        nxt_slot_o = int(self.ordp[b2 * K].max())
        if i_r + 1 < r0:
            succ_signed = nxt_in_blk
        else:
            succ_signed = nxt_slot_o if l + 1 < self.nlog else 0
        succ_p0 = _row_scalar(bo, 0) if r0 > 0 else 0
        if p == 0:
            succ = succ_p0
        else:
            succ = o_r + off if is_split else succ_signed
        right = ROOT_ORDER if succ == 0 else abs(succ) - 1

        self.store(b, no, nl)
        self.rws[l] += amt
        self.liv[l] += il
        self.cumliv[l:] += il
        self.ol[k] = u32_bits(left)
        self.orr[k] = u32_bits(right)

    def do_delete(self, p, d):
        K = self.K
        rem, iters = d, 0
        # Each iteration clears one block's covered span; > 2*NBL
        # iterations means the delete ran off the document.
        while rem > 0 and iters <= 2 * self.NBL:
            l = self.slot_of_live_rank(p + 1)
            if self.slot_scalar(self.rws, l) + 2 > K:
                self.split(l)
            l = self.slot_of_live_rank(p + 1)
            b = self.slot_scalar(self.blkord, l)
            base = self.live_before_slot(l)
            bo, bl = self.block(b)
            no, nl, added, tot = _delete_block_math(
                bo, bl, self.idx_k, K, base, p, rem)
            self.store(b, no, nl)
            self.rws[l] += added
            self.liv[l] -= tot
            self.cumliv[l:] -= tot
            rem -= tot
            iters += 1
        if rem > 0:
            self.err[1] = 1


def rle_replay_plain(pos, dlen, ilen, start, wcol, *, groups: int,
                     steps: int, batch: int, capacity: int, block_k: int,
                     wmax: int):
    """The plain PyTorch version of ``_rle_kernel``: replay each group's
    op stream (int32 columns ``[groups*steps]``) on ``[K, B]`` planes.
    Returns ``(ol, orr, ordp, lenp, blkord, rows, meta, err)`` in the JAX
    layout, on the device of the inputs."""
    G, S, B, CAP, K = groups, steps, batch, capacity, block_k
    NB = CAP // K
    NBL = max(8, NB)
    dev = pos.device
    ol = torch.zeros(G, S, B, dtype=I32, device=dev)
    orr = torch.zeros_like(ol)
    ordp = torch.zeros(G * CAP, B, dtype=I32, device=dev)
    lenp = torch.zeros_like(ordp)
    blk_out = torch.zeros(G, NBL, B, dtype=I32, device=dev)
    rows_out = torch.zeros_like(blk_out)
    meta_out = torch.zeros(G, 8, B, dtype=I32, device=dev)
    err = torch.zeros(8, B, dtype=I32, device=dev)
    cols = [c.cpu().tolist() for c in (pos, dlen, ilen, start, wcol)]
    for g in range(G):
        grp = _PlainGroup(ordp[g * CAP:(g + 1) * CAP],
                          lenp[g * CAP:(g + 1) * CAP], ol[g], orr[g], err,
                          K, NB, NBL, wmax)
        for k in range(S):
            i = g * S + k
            p, d, il, st = cols[0][i], cols[1][i], cols[2][i], cols[3][i]
            w = max(cols[4][i], 1)  # no-op pad rows carry 0
            if d > 0:
                grp.do_delete(p, d)
            if il > 0:
                grp.do_insert(k, p, il, st, w)
        blk_out[g] = grp.blkord
        rows_out[g] = grp.rws
        meta_out[g, 0] = grp.nlog
    return ol, orr, ordp, lenp, blk_out, rows_out, meta_out, err


# -- the CUDA kernel ------------------------------------------------------------

_KERNEL = "rle_replay"
_LAUNCH = "rle_replay_launch"
_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def rle_replay_cuda(pos, dlen, ilen, start, wcol, *, groups: int,
                    steps: int, batch: int, capacity: int, block_k: int,
                    wmax: int):
    """Launch ``ops/csrc/rle_replay.cu`` on PyTorch's current stream.
    Same arguments and results as ``rle_replay_plain``."""
    G, S, B, CAP, K = groups, steps, batch, capacity, block_k
    NB = CAP // K
    NBL = max(8, NB)
    dev = pos.device
    for c in (pos, dlen, ilen, start, wcol):
        _require(c.device == dev and c.dtype == I32 and c.is_contiguous()
                 and c.shape == (G * S,),
                 "op columns must be contiguous int32 [G*S] on one device")
    _require(8 <= K <= 1024, "block_k must lie in [8, 1024] for the kernel")
    ol = torch.zeros(G, S, B, dtype=I32, device=dev)
    orr = torch.zeros_like(ol)
    ordp = torch.empty(G * CAP, B, dtype=I32, device=dev)
    lenp = torch.empty_like(ordp)
    blk_out = torch.empty(G, NBL, B, dtype=I32, device=dev)
    rows_out = torch.empty_like(blk_out)
    meta_out = torch.empty(G, 8, B, dtype=I32, device=dev)
    err = torch.zeros(8, B, dtype=I32, device=dev)
    # Lane-major working planes [G, B, CAP]: one thread block's rows are
    # contiguous; the kernel transposes into ordp/lenp once at the end.
    work_o = torch.empty(G, B, CAP, dtype=I32, device=dev)
    work_l = torch.empty_like(work_o)
    fn = _kernels.function(_KERNEL, _LAUNCH, _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tensors = (pos, dlen, ilen, start, wcol, ol, orr, ordp, lenp, blk_out,
               rows_out, meta_out, err, work_o, work_l)
    code = fn(*(t.data_ptr() for t in tensors), G, S, B, CAP, K, NB, NBL,
              wmax, stream)
    _kernels.check(_KERNEL, code)
    _kernels.count_launch(_KERNEL)
    return ol, orr, ordp, lenp, blk_out, rows_out, meta_out, err


def rle_replay(pos, dlen, ilen, start, wcol, **shape):
    """The replay on the device of its inputs: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if pos.device.type == "cpu":
        return rle_replay_plain(pos, dlen, ilen, start, wcol, **shape)
    if pos.device.type == "cuda":
        return rle_replay_cuda(pos, dlen, ilen, start, wcol, **shape)
    raise ValueError(f"no replay for device {pos.device}")


# -- the replayer -----------------------------------------------------------------


@dataclasses.dataclass
class RleResult:
    """Outputs of one RLE replay (one doc group)."""

    ordp: torch.Tensor     # i32[CAP, B] ±(start_order+1) per run row
    lenp: torch.Tensor     # i32[CAP, B] run char length
    blkord: torch.Tensor   # i32[NBLp, B] logical slot -> physical block
    rows: torch.Tensor     # i32[NBLp, B] occupied rows per logical slot
    meta: torch.Tensor     # i32[8, B]   row 0: blocks in use
    ol: torch.Tensor       # u32 bits[S, B] per-op run-head origin_left
    orr: torch.Tensor      # u32 bits[S, B] per-op origin_right
    err: torch.Tensor      # i32[8, B]   0: block capacity; 1: bad delete
    block_k: int
    num_blocks: int
    batch: int

    def check(self) -> None:
        err = self.err.cpu().numpy()
        if err[0].max() != 0:
            raise RuntimeError(
                "rle engine out of blocks (every split consumed); raise "
                "capacity")
        if err[1].max() != 0:
            raise RuntimeError(
                "delete ran past the end of the document (invalid op "
                "stream)")


def stage_local_streams(ops, engine: str, capacity: int, block_k: int,
                        chunk: int, dev):
    """Validate one local-edit stream (or a SEQUENCE of them, divergent
    doc groups) for a run-block replay of ``engine`` and stage its five
    int32 op columns ``[G * s_pad]`` on ``dev``, each group's padded to
    ``s_pad``, a multiple of ``chunk``. Returns ``(grouped, lens, staged,
    shape)``: ``shape`` holds the replay's keyword arguments but
    ``batch``."""
    grouped = isinstance(ops, (list, tuple))
    streams = list(ops) if grouped else [ops]
    G = len(streams)
    _require(G >= 1, "need at least one op stream")
    for st in streams:
        kinds = np.asarray(st.kind)
        _require(kinds.ndim == 1, f"{engine} engine takes per-group shared "
                 "streams (no per-lane batching inside a group)")
        _require(bool((kinds == KIND_LOCAL).all()),
                 f"{engine} engine replays local streams; remote ops -> "
                 "ops.rle_mixed")
    _require(capacity % block_k == 0,
             f"capacity ({capacity}) must be a multiple of block_k "
             f"({block_k})")
    _require(chunk >= 1, "chunk must be positive")
    _require(capacity // block_k >= 1, "need at least one block")
    _require(block_k >= 8, "block_k must hold a few runs")
    WMAX = fused_width_checked(streams, block_k)

    lens = [st.num_steps for st in streams]
    s_pad = max(((max(lens) + chunk - 1) // chunk) * chunk, chunk)

    def staged_col(get):
        cols = []
        for st in streams:
            a = np.asarray(get(st), dtype=np.int32)
            cols.append(np.pad(a, ((0, s_pad - len(a)),)))
        return torch.from_numpy(np.concatenate(cols)).to(dev)

    staged = (staged_col(lambda o: o.pos),
              staged_col(lambda o: o.del_len),
              staged_col(lambda o: o.ins_len),
              staged_col(lambda o: o.ins_order_start),
              staged_col(lambda o: o.rows_per_step))
    shape = dict(groups=G, steps=s_pad, capacity=capacity, block_k=block_k,
                 wmax=WMAX)
    return grouped, lens, staged, shape


def split_results(outs, grouped: bool, lens, capacity: int, block_k: int,
                  batch: int, keep_origins: bool = True):
    """A replay's eight outputs as one ``RleResult`` per group (a list
    when ``grouped``), origins cut to each group's real steps (to none
    when ``keep_origins`` is False)."""
    ol, orr, ordp, lenp, blk, rows, meta, err = outs
    results = [
        RleResult(
            ordp=ordp[gi * capacity:(gi + 1) * capacity],
            lenp=lenp[gi * capacity:(gi + 1) * capacity],
            blkord=blk[gi], rows=rows[gi], meta=meta[gi],
            ol=ol[gi, :lens[gi] if keep_origins else 0],
            orr=orr[gi, :lens[gi] if keep_origins else 0], err=err,
            block_k=block_k, num_blocks=capacity // block_k, batch=batch)
        for gi in range(len(lens))
    ]
    return results if grouped else results[0]


def make_replayer_rle(
    ops,
    capacity: int,
    batch: int = 128,
    block_k: int = 256,
    chunk: int = 1024,
    device=None,
):
    """Build a replayer for one local-edit stream (or a SEQUENCE of
    streams — divergent doc groups on a leading dimension). Returns a
    function of no arguments that runs the replay and returns an
    ``RleResult`` (a list of them for a sequence).

    ``capacity`` counts RUN ROWS, not characters: automerge-paper peaks at
    13,218 rows. ``chunk`` pads the step count to a multiple of itself,
    as the JAX package's grid does."""
    dev = resolve_device(device)
    grouped, lens, staged, shape = stage_local_streams(
        ops, "rle", capacity, block_k, chunk, dev)
    shape["batch"] = batch

    def run():
        return split_results(rle_replay(*staged, **shape), grouped, lens,
                             capacity, block_k, batch)

    run.staged = staged
    run.shape = shape
    return run


def replay_local_rle(ops, capacity: int, **kw):
    """One-shot convenience wrapper over ``make_replayer_rle``."""
    return make_replayer_rle(ops, capacity, **kw)()


def simulate_run_rows(patches) -> tuple:
    """Host dry-run of the replay's row algebra over a (merged) patch
    list: returns ``(peak_rows, final_rows)``, for capacity planning
    (blocks fragment to ~50% after splits, so size the device capacity at
    ~2.5x the peak)."""
    runs = []  # (order_start, char_len, live)
    next_order = 0
    peak = 0
    for p in patches:
        if p.del_len:
            rem = p.del_len
            before = 0
            i = 0
            while rem > 0 and i < len(runs):
                o, l, live = runs[i]
                lv = l if live else 0
                cs = min(max(p.pos - before, 0), lv)
                ce = min(max(p.pos + rem - before, 0), lv)
                cov = ce - cs
                if cov > 0:
                    parts = []
                    if cs > 0:
                        parts.append((o, cs, True))
                    parts.append((o + cs, cov, False))
                    if ce < l:
                        parts.append((o + ce, l - ce, True))
                    runs[i:i + 1] = parts
                    i += len(parts)
                    rem -= cov
                else:
                    i += 1
                before += lv - cov
            next_order += p.del_len
        il = len(p.ins_content)
        if il:
            st = next_order
            if p.pos == 0:
                runs.insert(0, (st, il, True))
            else:
                before = 0
                for i, (o, l, live) in enumerate(runs):
                    lv = l if live else 0
                    if before + lv >= p.pos:
                        off = p.pos - before
                        if off == l and live and st == o + l:
                            runs[i] = (o, l + il, True)
                        elif off == lv:
                            runs.insert(i + 1, (st, il, True))
                        else:
                            runs[i:i + 1] = [(o, off, True), (st, il, True),
                                             (o + off, l - off, True)]
                        break
                    before += lv
            next_order += il
        peak = max(peak, len(runs))
    return peak, len(runs)


def expand_runs(res: RleResult, doc_index: int = 0) -> np.ndarray:
    """Run rows -> per-char ±(order+1) column in document order (the
    ``FlatDoc.signed`` layout), host-side numpy."""
    res.check()
    K = res.block_k
    # Slice the lane on the device before downloading.
    ordc = res.ordp[:, doc_index].cpu().numpy()
    lenc = res.lenp[:, doc_index].cpu().numpy()
    blk = res.blkord[:, doc_index].cpu().numpy()
    rows = res.rows[:, doc_index].cpu().numpy()
    nlog = int(res.meta[0, doc_index])
    o_parts, l_parts = [], []
    for l in range(nlog):
        b, r = int(blk[l]), int(rows[l])
        o_parts.append(ordc[b * K: b * K + r])
        l_parts.append(lenc[b * K: b * K + r])
    if not o_parts:
        return np.zeros(0, np.int32)
    o = np.concatenate(o_parts).astype(np.int64)
    ln = np.concatenate(l_parts).astype(np.int64)
    if not (ln > 0).all():
        raise RuntimeError("occupied run with non-positive length")
    reps = ln
    total = int(reps.sum())
    starts = np.abs(o)
    sign = np.sign(o)
    base = np.repeat(starts, reps)
    within = np.arange(total) - np.repeat(np.cumsum(reps) - reps, reps)
    return (np.repeat(sign, reps) * (base + within)).astype(np.int32)


def rle_to_flat(
    ops: OpTensors,
    res: RleResult,
    capacity: int | None = None,
    order_capacity: int | None = None,
    doc_index: int = 0,
) -> FlatDoc:
    """Replay result -> a standard ``FlatDoc`` (one doc of the batch) on
    the result's device: expand runs to char rows, prefill the by-order
    logs, then merge the replay's per-op local origins."""
    flat = expand_runs(res, doc_index)
    n = len(flat)
    if capacity is None:
        capacity = max(2 << max(n - 1, 5).bit_length(), n)
    dev = res.ordp.device
    doc = prefill_logs(make_flat_doc(capacity, order_capacity, device=dev),
                       ops)
    ol_log = doc.ol_log.cpu().numpy().view(np.uint32).copy()
    or_log = doc.or_log.cpu().numpy().view(np.uint32).copy()
    ol_np = res.ol[:, doc_index].cpu().numpy().view(np.uint32)
    or_np = res.orr[:, doc_index].cpu().numpy().view(np.uint32)
    if len(ol_np) < ops.num_steps:
        raise ValueError(
            f"rle_to_flat needs per-op origins for all {ops.num_steps} "
            f"steps but the result carries {len(ol_np)}")
    merge_fused_origins(ol_log, or_log, ops, ol_np, or_np)

    signed_col = np.zeros(capacity, np.int32)
    signed_col[:n] = flat
    advance = int(np.asarray(ops.order_advance, dtype=np.int64).sum())
    return dataclasses.replace(
        doc,
        signed=torch.from_numpy(signed_col).to(dev),
        ol_log=torch.from_numpy(ol_log.view(np.int32)).to(dev),
        or_log=torch.from_numpy(or_log.view(np.int32)).to(dev),
        n=n,
        next_order=advance & 0xFFFF_FFFF,
    )
