"""Flat device engine: every CRDT op as whole-column work on one
``FlatDoc`` per lane (counterpart of ``text_crdt_rust_tpu/ops/flat.py``).

The device twin of ``models.oracle.ListCRDT`` — same flattened item layout
(``span_arrays``), same semantics:

- the B-tree descent `root.rs:54-88` -> one live-prefix cumsum and a
  compare-and-count (position -> row);
- the splice `mutations.rs:17-179` -> rows at or past the cursor shift
  right by the insert length; the new run is iota arithmetic (orders are
  consecutive, `span.rs:9-13`) — the whole mutable state is the one
  ``signed`` column;
- order -> row (`split_list/mod.rs:440`) -> the first row whose magnitude
  decodes to the order;
- tombstoning `span.rs:110-119` -> a sign flip of ``signed`` (local
  deletes select a live-rank window, remote deletes an order range);
- the YATA integrate scan `doc.rs:167-234` -> a loop from the origin
  cursor reading per-item origins and ranks through the by-order logs,
  with the scanning/scan_start backtrack carried as loop state.

Immutable per-item metadata lives in by-order logs prefilled with what the
op compiler knows (``batch.prefill_logs`` on the host, or
``batch.prefill_delta`` + ``apply_prefill_delta`` on the device); a local
insert step writes only the two origins it discovers at apply time.

Two versions compute each step stream:

- ``step``/``flat_replay_plain``: plain PyTorch on CPU tensors, one step
  at a time (the YATA scan as a loop over all lanes until every lane is
  done) — what the tests hold against the JAX package;
- ``flat_replay_cuda``: ``ops/csrc/flat_replay.cu``, one launch for a
  whole ``[T, S, B]`` op stack (one warp per lane walking its T x S
  steps in order over the rows in use) — the counterpart of the one XLA
  program
  ``lax.scan`` makes of a tick or a tick train. ``flat_replay`` picks by
  the tensors' device; on CUDA tensors it launches the kernel or raises.

``apply_train``'s idle-step skip is decided across lanes (a step idle on
every lane is skipped for all of them, its ``order_advance`` included):
the ``[T, S]`` active mask is computed on the host from the op columns
and passed in; ``apply_ops``/``apply_ops_batch`` skip nothing.

u32 columns ride int32 tensors (``span_arrays``); every unsigned compare
of the JAX package (the remote-delete range, the rank tiebreak, the
next-order bound) is unsigned here too.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..common import ROOT_ORDER
from . import _kernels
from .batch import (
    KIND_LOCAL,
    KIND_REMOTE_DEL,
    KIND_REMOTE_INS,
    OpTensors,
    require_unfused,
)
from .span_arrays import I32, FlatDoc, u32_bits

_M32 = 0xFFFF_FFFF
_ROOT = ROOT_ORDER & _M32

#: Op columns the kernel reads, in its column order (``flat_replay.cu``).
OP_COLUMNS = ("kind", "pos", "del_len", "del_target", "origin_left",
              "origin_right", "ins_len", "ins_order_start", "order_advance",
              "rank")

#: Shared memory of one H100 thread block (227 KB).
SMEM_LIMIT = 232448


# -- the plain version ------------------------------------------------------------
# Internal working form: int64 tensors; ``signed`` and ``n`` hold int32
# values, the logs, ``next_order`` and every op column hold u32 values.


def _s32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int64 value of its low 32 bits read as int32 (two's
    complement wrap, what int32 arithmetic does)."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _abs32(x: torch.Tensor) -> torch.Tensor:
    """int32 ``abs`` with wrap (INT_MIN stays INT_MIN)."""
    return _s32(torch.abs(x))


def _order_of(signed: torch.Tensor) -> torch.Tensor:
    """Magnitude decode: row content -> order (u32 value; garbage on
    empty rows — callers mask with ``signed != 0``)."""
    return (_abs32(signed) - 1) & _M32


def _row_of_order(signed: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Per lane, the first row holding item ``order``; 0 when none does
    (the JAX package's ``argmax`` of an all-false mask)."""
    hit = (signed != 0) & (_order_of(signed) == order[:, None])
    return torch.argmax(hit.to(torch.int8), dim=1)


def _cursor_after(signed: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Raw cursor just after item ``order`` (`doc.rs:121-136`)."""
    return torch.where(order == _ROOT, torch.zeros_like(order),
                       _row_of_order(signed, order) + 1)


def _read_log(log: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``log[clip(int32(order), 0, OCAP-1)]`` per lane: every order at or
    past 2^31 (ROOT included) reads row 0."""
    idx = torch.clamp(_s32(order), 0, log.shape[1] - 1)
    return torch.gather(log, 1, idx[:, None])[:, 0]


def _integrate_cursor(signed, ol_log, or_log, rank_log, n, my_rank,
                      origin_left, origin_right, active) -> torch.Tensor:
    """YATA conflict scan (`doc.rs:167-234`): the final insert row of a
    remote run, per lane; every lane loops until it breaks or reaches
    ``n`` (the pre-insert row count), inactive lanes never start."""
    cap = signed.shape[1]
    lanes = torch.arange(signed.shape[0], device=signed.device)
    cursor0 = _cursor_after(signed, origin_left)
    cursor = cursor0.clone()
    scanning = torch.zeros_like(active)
    scan_start = cursor0.clone()
    done = ~active
    while True:
        run = ~done & (cursor < n)
        if not bool(run.any()):
            break
        c = torch.clamp(cursor, 0, cap - 1)
        other_order = _order_of(signed[lanes, c])
        other_left = _read_log(ol_log, other_order)
        other_right = _read_log(or_log, other_order)
        other_rank = _read_log(rank_log, other_order)
        olc = _cursor_after(signed, other_left)
        # Break conditions, in the reference's order (`doc.rs:183-222`).
        brk = (other_order == origin_right) | (olc < cursor0)
        eq = ~brk & (olc == cursor0)
        gt = my_rank > other_rank          # name tiebreak, unsigned
        same_right = origin_right == other_right
        brk = brk | (eq & ~gt & same_right)
        starts_scan = eq & ~gt & ~same_right
        new_scan_start = torch.where(starts_scan & ~scanning, cursor,
                                     scan_start)
        new_scanning = torch.where(
            eq, ~gt & (~same_right | scanning), scanning)
        new_cursor = torch.where(brk, cursor, cursor + 1)
        cursor = torch.where(run, new_cursor, cursor)
        scanning = torch.where(run, new_scanning, scanning)
        scan_start = torch.where(run, new_scan_start, scan_start)
        done = torch.where(run, brk, done)
    return torch.where(scanning, scan_start, cursor)


def _plain_step(st: dict, op: dict, lmax: int, local_only: bool) -> None:
    """One step on every lane of the working state ``st`` (in place).
    ``op`` holds ``OP_COLUMNS`` as int64 ``[B]`` u32 values."""
    signed = st["signed"]
    B, cap = signed.shape
    ocap = st["ol"].shape[1]
    dev = signed.device
    j = torch.arange(cap, device=dev)[None, :]
    lanes = torch.arange(B, device=dev)
    kind = op["kind"]
    if local_only:
        is_local = torch.ones_like(kind, dtype=torch.bool)
        is_rins = is_rdel = torch.zeros_like(is_local)
    else:
        is_local = kind == KIND_LOCAL
        is_rins = kind == KIND_REMOTE_INS
        is_rdel = kind == KIND_REMOTE_DEL
    pos = _s32(op["pos"])
    dlen = _s32(op["del_len"])
    ilen = torch.where(is_rdel, torch.zeros_like(pos), _s32(op["ins_len"]))
    n = st["n"]

    live = signed > 0
    cum = torch.cumsum(live.to(torch.int64), dim=1)
    # ---- delete phase (tombstone sign flips, `span.rs:110-119`) ----------
    local_mask = (live & (cum > pos[:, None])
                  & (cum <= _s32(pos + dlen)[:, None]))
    orders = _order_of(signed)
    remote_mask = (signed != 0) & (
        ((orders - op["del_target"][:, None]) & _M32)
        < op["del_len"][:, None])
    del_mask = torch.where(is_local[:, None], local_mask,
                           is_rdel[:, None] & remote_mask)
    signed = torch.where(del_mask, _s32(-_abs32(signed)), signed)
    # Post-delete live prefix counts: a local delete removes the live-rank
    # window (pos, pos+dlen], so the first-i live count drops by
    # clip(cum - pos, 0, dlen).
    drop = torch.minimum(torch.clamp(_s32(cum - pos[:, None]), min=0),
                         dlen[:, None])
    cum2 = cum - torch.where(is_local[:, None], drop, torch.zeros_like(drop))

    # ---- insert phase -----------------------------------------------------
    oli = (cum2 < pos[:, None]).sum(dim=1)
    safe_oli = torch.clamp(oli, 0, cap - 1)
    l_cursor = torch.where(pos == 0, torch.zeros_like(oli), oli + 1)
    l_origin_left = torch.where(pos == 0, torch.full_like(oli, _ROOT),
                                _order_of(signed[lanes, safe_oli]))
    if local_only or not bool(is_rins.any()):
        cursor, origin_left = l_cursor, l_origin_left
    else:
        r_cursor = _integrate_cursor(
            signed, st["ol"], st["or"], st["rank"], n, op["rank"],
            op["origin_left"], op["origin_right"], is_rins)
        cursor = torch.where(is_rins, r_cursor, l_cursor)
        origin_left = torch.where(is_rins, op["origin_left"], l_origin_left)
    safe_cursor = torch.clamp(cursor, 0, cap - 1)
    l_origin_right = torch.where(cursor < n,
                                 _order_of(signed[lanes, safe_cursor]),
                                 torch.full_like(cursor, _ROOT))
    origin_right = torch.where(is_rins, op["origin_right"], l_origin_right)

    # Splice: rows >= cursor shift right by ilen (the JAX package's static
    # rolls by the set bits of ilen, i.e. a circular roll by its low bits);
    # the new run is iota arithmetic (+1 for the ±(order+1) encoding).
    eff = ilen & ((1 << max(lmax, 1).bit_length()) - 1)
    shifted = torch.gather(signed, 1,
                           torch.remainder(j - eff[:, None], cap))
    c = cursor[:, None]
    in_new = (j >= c) & (j < _s32(cursor + ilen)[:, None])
    new_signed = _s32(_s32(op["ins_order_start"])[:, None] + (j - c) + 1)
    signed = torch.where(j < c, signed,
                         torch.where(in_new, new_signed, shifted))

    # Log writes for what only apply time knows: a local insert's origins
    # (`doc.rs:447-453`), in the lmax-wide window at the run's first order.
    start = torch.clamp(_s32(op["ins_order_start"]), 0, ocap - lmax)
    k = torch.arange(lmax, device=dev)[None, :]
    idx = start[:, None] + k
    write = is_local[:, None] & (k < ilen[:, None])
    ol_chunk = torch.gather(st["ol"], 1, idx)
    or_chunk = torch.gather(st["or"], 1, idx)
    st["ol"].scatter_(1, idx, torch.where(write & (k == 0),
                                          origin_left[:, None], ol_chunk))
    st["or"].scatter_(1, idx, torch.where(write, origin_right[:, None],
                                          or_chunk))
    st["signed"] = signed
    st["cursor"], st["ilen"] = cursor, ilen
    st["n"] = _s32(n + ilen)
    st["next_order"] = (st["next_order"] + op["order_advance"]) & _M32


def _u32_of(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & _M32


def _working(signed, ol_log, or_log, rank_log, n, next_order) -> dict:
    return {"signed": signed.to(torch.int64), "ol": _u32_of(ol_log),
            "or": _u32_of(or_log), "rank": _u32_of(rank_log),
            "n": n.to(torch.int64), "next_order": _u32_of(next_order)}


def _write_back(st: dict, signed, ol_log, or_log, n, next_order) -> None:
    signed.copy_(st["signed"].to(I32))
    ol_log.copy_(_s32(st["ol"]).to(I32))
    or_log.copy_(_s32(st["or"]).to(I32))
    n.copy_(st["n"].to(I32))
    next_order.copy_(_s32(st["next_order"]).to(I32))


def flat_replay_plain(signed, ol_log, or_log, rank_log, n, next_order,
                      cols: np.ndarray, active: np.ndarray,
                      lmax: int, on_step=None) -> torch.Tensor:
    """Apply a ``[T, S, B]`` op stack to B lanes, in place: tick by tick,
    step by step, skipping the steps ``active`` ``[T, S]`` marks idle.
    ``cols`` is ``[len(OP_COLUMNS), T, S, B]`` u32. Returns the per-lane
    overflow flags (``n > CAP`` or ``next_order > OCAP - lmax`` after any
    tick), int32 ``[B]``. ``on_step(st)``, where given, sees the working
    state after every step run (int64 values; ``st["cursor"]`` and
    ``st["ilen"]`` are that step's insert row and length)."""
    st = _working(signed, ol_log, or_log, rank_log, n, next_order)
    cap, ocap = signed.shape[1], ol_log.shape[1]
    T, S = active.shape
    c64 = torch.from_numpy(np.asarray(cols, dtype=np.uint32)
                           .astype(np.int64)).to(signed.device)
    flags = torch.zeros(signed.shape[0], dtype=torch.bool,
                        device=signed.device)
    for t in range(T):
        for s in range(S):
            if not active[t, s]:
                continue
            op = {name: c64[i, t, s] for i, name in enumerate(OP_COLUMNS)}
            _plain_step(st, op, lmax, local_only=False)
            if on_step is not None:
                on_step(st)
        flags |= (st["n"] > cap) | (st["next_order"] > ocap - lmax)
    _write_back(st, signed, ol_log, or_log, n, next_order)
    return flags.to(I32)


# -- the CUDA kernel ----------------------------------------------------------------

_KERNEL = "flat_replay"
_LAUNCH = "flat_replay_launch"
# 9 state and op tensors, stats; T, S, B, CAP, OCAP, LMAX, lanes a block,
# shared memory; the stream.
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
             + [ctypes.c_void_p])
#: Lanes (one warp each) a thread block: four, as measured at the serve
#: shapes (PERF.md §6, F1: at B = 16 one, two and four within 0.5 %, at
#: B = 1,024 four 4.7 % under one), fewer only where four lanes' columns
#: do not fit one block's shared memory.
LANES_PER_BLOCK = (4, 2, 1)
#: Ints of a lane's op words in shared memory: two tiles of 32 steps' ten
#: words (``flat_replay.cu``'s ``kOpInts``).
_TILE_INTS = 640
#: Per-lane counters of ``stats`` (int64): steps with work (that delete
#: or insert; the others only move ``next_order``), remote
#: inserts, YATA iterations, order lookups, 32-row chunks those lookups
#: read, the extent E at the end, rows the prefix/delete passes covered,
#: rows the splices covered; then ``clock64`` cycles in op staging, the
#: prefix/delete passes, the YATA scans, the splices, the log writes, the
#: launch's loads, the write-out, and in all.
FLAT_STAT_NAMES = ("steps_with_work", "remote_inserts", "yata_iterations",
                   "lookups", "lookup_chunks", "extent", "pass_rows",
                   "splice_rows", "cy_staging", "cy_pass", "cy_yata",
                   "cy_splice", "cy_logs", "cy_load", "cy_write", "cy_all")
FLAT_STATS = len(FLAT_STAT_NAMES)


def kernel_smem_bytes(capacity: int, lanes_per_block: int = 4) -> int:
    """Shared memory of one thread block of ``flat_replay_kernel``: for
    each of its lanes two tiles of op words and the ``signed`` column
    padded to 128 rows (the by-order logs stay in device memory)."""
    return 4 * lanes_per_block * (_TILE_INTS + -(-capacity // 128) * 128)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A launch's shape: lanes a thread block, the block's shared-memory
    bytes."""
    lanes_per_block: int
    smem: int


def launch_geometry(capacity: int) -> Geometry:
    """The kernel's launch shape, from the capacity alone and before any
    build: the most lanes a block of ``LANES_PER_BLOCK`` whose columns fit
    its shared memory. Refuses, naming the bytes, a capacity whose column
    does not fit one block even alone."""
    for lanes in LANES_PER_BLOCK:
        smem = kernel_smem_bytes(capacity, lanes)
        if smem <= SMEM_LIMIT:
            return Geometry(lanes, smem)
    raise ValueError(
        f"the flat kernel keeps each lane's signed column in shared "
        f"memory: capacity {capacity} needs {smem} B (limit {SMEM_LIMIT})")


def describe_stats(stats) -> str:
    """A launch's ``stats`` (``[B, FLAT_STATS]``) summed over its lanes,
    as a line of text: counts, YATA iterations per remote insert, the
    mean extent, cycles a step with work and the phases' cycle shares."""
    v = [int(x) for x in torch.as_tensor(stats).sum(dim=0).tolist()]
    d = dict(zip(FLAT_STAT_NAMES, v))
    lanes = max(int(torch.as_tensor(stats).shape[0]), 1)
    work, tot = max(d["steps_with_work"], 1), max(d["cy_all"], 1)
    phases = ("staging", "pass", "yata", "splice", "logs", "load", "write")
    shares = ", ".join(f"{p} {d['cy_' + p] / tot:.4f}" for p in phases)
    return (f"{d['steps_with_work']} steps with work, "
            f"{d['remote_inserts']} remote inserts, "
            f"{d['yata_iterations'] / max(d['remote_inserts'], 1):.3f} YATA "
            f"iterations and {d['lookups'] / max(d['remote_inserts'], 1):.3f}"
            f" lookups a remote insert ({d['lookup_chunks']} chunks read), "
            f"mean extent {d['extent'] / lanes:.1f} rows, "
            f"{d['pass_rows'] / work:.1f} pass rows and "
            f"{d['splice_rows'] / work:.1f} splice rows a step with work; "
            f"{tot / work:.0f} cycles a step with work; cycle shares: "
            f"{shares}")


def _require_cuda(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"flat_replay_cuda takes CUDA tensors, not {dev}")


def flat_replay_cuda(signed, ol_log, or_log, rank_log, n, next_order,
                     cols_dev: torch.Tensor, active_dev: torch.Tensor,
                     lmax: int, *, stats=None) -> torch.Tensor:
    """Launch ``ops/csrc/flat_replay.cu`` on PyTorch's current stream:
    the same function as ``flat_replay_plain``, in place, with the op
    stack ``cols_dev`` (int32 ``[10, T, S, B]``) and the active mask
    ``active_dev`` (int32 ``[T, S]``) already on the card. Returns the
    per-lane overflow flags on the card. ``launch_geometry`` sets lanes a
    block (and refuses a capacity whose shared memory does not fit, before
    any build); ``stats``, an int64 ``[B, FLAT_STATS]`` tensor on the
    card, takes the counting build and receives each lane's counters."""
    B, CAP = signed.shape
    OCAP = ol_log.shape[1]
    _, T, S, _ = cols_dev.shape
    geo = launch_geometry(CAP)
    if OCAP < lmax:
        raise ValueError(f"order capacity {OCAP} is below lmax {lmax}")
    dev = signed.device
    for t in (signed, ol_log, or_log, rank_log, n, next_order, cols_dev,
              active_dev):
        if not (t.device == dev and t.dtype == I32 and t.is_contiguous()):
            raise ValueError("flat_replay takes contiguous int32 tensors "
                             "on one device")
    if stats is not None and not (
            stats.device == dev and stats.dtype == torch.int64
            and stats.is_contiguous() and stats.shape == (B, FLAT_STATS)):
        raise ValueError(f"stats must be a contiguous int64 [{B}, "
                         f"{FLAT_STATS}] on the card")
    _require_cuda(dev)
    flags = torch.empty(B, dtype=I32, device=dev)  # every lane writes its own
    fn = _kernels.function(_KERNEL, _LAUNCH, _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tensors = (signed, ol_log, or_log, rank_log, n, next_order, cols_dev,
               active_dev, flags)
    code = fn(*(t.data_ptr() for t in tensors),
              None if stats is None else stats.data_ptr(), T, S, B, CAP,
              OCAP, lmax, geo.lanes_per_block, geo.smem, stream)
    _kernels.check(_KERNEL, code)
    _kernels.count_launch(_KERNEL)
    return flags


def op_stack(ops: OpTensors) -> np.ndarray:
    """The kernel's op stack of a ``[S, B]`` or ``[T, S, B]`` stream:
    u32 ``[10, T, S, B]``."""
    cols = np.stack([np.asarray(getattr(ops, f), dtype=np.uint32)
                     for f in OP_COLUMNS])
    if cols.ndim == 3:
        cols = cols[:, None]
    return np.ascontiguousarray(cols)


def active_steps(ops: OpTensors) -> np.ndarray:
    """``[T, S]`` mask of the train steps that are active on ANY lane
    (``rows_per_step``, ``ins_len`` or ``del_len`` > 0 somewhere); a step
    idle on every lane is tick/step padding and is skipped for all."""
    def any_pos(f):
        return (np.asarray(getattr(ops, f), dtype=np.uint32) > 0).any(-1)

    return (any_pos("rows_per_step") | any_pos("ins_len")
            | any_pos("del_len"))


def flat_replay(docs: FlatDoc, ops: OpTensors, *,
                skip_idle: bool) -> torch.Tensor:
    """Apply a ``[S, B]`` tick or a ``[T, S, B]`` train to the batched
    ``docs`` in place, on the device of its tensors: the plain version on
    CPU tensors, one launch of the CUDA kernel on CUDA tensors.
    ``skip_idle`` skips the steps idle on every lane (``apply_train``). Returns the per-lane overflow flags, int32
    ``[B]`` on the docs' device."""
    cols = op_stack(ops)
    T, S = cols.shape[1], cols.shape[2]
    lmax = ops.lmax
    active = (active_steps(ops).reshape(T, S) if skip_idle
              else np.ones((T, S), bool))
    dev = docs.signed.device
    args = (docs.signed, docs.ol_log, docs.or_log, docs.rank_log, docs.n,
            docs.next_order)
    if dev.type == "cpu":
        return flat_replay_plain(*args, cols, active, lmax)
    if dev.type != "cuda":
        raise ValueError(f"no replay for device {dev}")
    # One pinned upload for the op stack and the mask, queued behind the
    # launches already on the stream (no host sync).
    host = torch.from_numpy(np.concatenate(
        [cols.view(np.int32).ravel(), active.astype(np.int32).ravel()]))
    flat = host.pin_memory().to(dev, non_blocking=True)
    cols_dev = flat[:cols.size].view(cols.shape)
    active_dev = flat[cols.size:].view(T, S)
    return flat_replay_cuda(*args, cols_dev, active_dev, lmax)


# -- capacity contract ----------------------------------------------------------------


def check_capacity_counts(n, next_order, capacity: int,
                          order_capacity: int, ops: OpTensors) -> None:
    """The ONE capacity contract for a flat-doc op stream, against
    caller-supplied occupancy counts (``n``/``next_order`` may be the
    device doc's or the serve backend's host mirrors). The bound is
    per-document: each lane's own occupancy pairs with its own stream's
    growth."""
    require_unfused(ops, "the flat engine")
    need = (np.asarray(n, dtype=np.int64)
            + np.asarray(ops.ins_len, dtype=np.int64).sum(axis=0))
    if int(np.max(need)) > capacity:
        raise AssertionError(
            f"op stream needs {int(np.max(need))} rows but capacity is "
            f"{capacity}; allocate a larger FlatDoc")
    o_need = (np.asarray(next_order, dtype=np.int64)
              + np.asarray(ops.order_advance, dtype=np.int64).sum(axis=0))
    # lmax slots of headroom: the log-write window is an lmax-wide slice
    # whose clipped start must never shift a real write.
    if int(np.max(o_need)) > order_capacity - ops.lmax:
        raise AssertionError(
            f"op stream needs {int(np.max(o_need))}+{ops.lmax} orders but "
            f"order capacity is {order_capacity}; allocate a larger FlatDoc")


def _host_counts(doc: FlatDoc) -> Tuple[np.ndarray, np.ndarray]:
    def host(v):
        if isinstance(v, torch.Tensor):
            return v.cpu().numpy().astype(np.int64)
        return np.asarray(v, dtype=np.int64)

    return host(doc.n), host(doc.next_order) & _M32


def _check_capacity(doc: FlatDoc, ops: OpTensors) -> None:
    """Host-side overflow guard: the splice wraps around silently on the
    device, so exceeding the static capacities would corrupt, not crash.
    Reads the doc's device counts (the serve backend checks its host
    mirrors with ``check_capacity_counts`` instead)."""
    n, nxt = _host_counts(doc)
    check_capacity_counts(n, nxt, doc.capacity, doc.order_capacity, ops)


# -- device-resident prefill -------------------------------------------------------


def _delta_writes(delta, ocap: int, batched_doc: bool, lanes: int):
    """A ``PrefillDelta``'s writes as (flat index, value) int64 pairs per
    log, dropping positions ``>= OCAP`` (``PREFILL_PAD`` among them)."""
    out = {}
    for log, pos_f, val_f in (("chars", "ins_pos", "chars_val"),
                              ("rank", "ins_pos", "rank_val"),
                              ("ol", "ol_pos", "ol_val"),
                              ("or", "or_pos", "or_val")):
        pos = np.asarray(getattr(delta, pos_f), dtype=np.uint32).astype(
            np.int64)
        val = np.asarray(getattr(delta, val_f), dtype=np.uint32)
        if pos.ndim == 1 and batched_doc:
            # An unbatched delta broadcasts over the doc axis.
            pos = np.broadcast_to(pos, (lanes,) + pos.shape)
            val = np.broadcast_to(val, (lanes,) + val.shape)
        keep = pos < ocap
        if pos.ndim == 2:
            rows = np.broadcast_to(np.arange(pos.shape[0])[:, None],
                                   pos.shape)
            flat = rows[keep] * ocap + pos[keep]
        else:
            flat = pos[keep]
        out[log] = (flat, val[keep])
    return out


def scatter_delta_(doc: FlatDoc, delta) -> None:
    """Apply a ``batch.PrefillDelta`` to the doc's by-order logs in place,
    on their device: an elementwise masked scatter (positions at or past
    ``OCAP`` dropped). Real positions are unique within one stream
    (orders are allocated uniquely), so the order of writes is moot. The
    writes go up in one pinned upload, queued behind earlier launches."""
    if delta is None:
        return
    doc_b = doc.ol_log.dim() == 2
    if np.asarray(delta.ins_pos).ndim == 2 and not doc_b:
        raise ValueError("batched delta needs a batched doc")
    ocap = doc.order_capacity
    writes = _delta_writes(delta, ocap, doc_b,
                           doc.ol_log.shape[0] if doc_b else 1)
    logs = {"chars": doc.chars_log, "rank": doc.rank_log,
            "ol": doc.ol_log, "or": doc.or_log}
    sizes = [len(writes[k][0]) for k in logs]
    if not sum(sizes):
        return
    host = np.concatenate(
        [writes[k][0] for k in logs]
        + [writes[k][1].view(np.int32).astype(np.int64) for k in logs])
    t = torch.from_numpy(host)
    dev = doc.ol_log.device
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    total = sum(sizes)
    idx_all, val_all = t[:total], t[total:].to(I32)
    at = 0
    for k, size in zip(logs, sizes):
        if size:
            logs[k].view(-1)[idx_all[at:at + size]] = val_all[at:at + size]
        at += size


def apply_prefill_delta(doc: FlatDoc, delta) -> FlatDoc:
    """Apply a ``batch.PrefillDelta`` to the by-order logs on the device —
    the device-resident twin of ``batch.prefill_logs`` (bit-identical
    logs). Takes every doc/delta batching combination ``prefill_logs``
    does: unbatched/unbatched, batched docs + unbatched delta (broadcast),
    batched/batched. A ``None`` delta passes the doc through. Returns a
    new doc; the input's logs are untouched."""
    if delta is None:
        return doc
    out = dataclasses.replace(
        doc, ol_log=doc.ol_log.clone(), or_log=doc.or_log.clone(),
        rank_log=doc.rank_log.clone(), chars_log=doc.chars_log.clone())
    scatter_delta_(out, delta)
    return out


# -- entry points --------------------------------------------------------------------


def _batched_copy(doc: FlatDoc) -> FlatDoc:
    """A batched copy of ``doc`` with its own storage: a single document
    becomes a batch of one; ``n``/``next_order`` become int32 ``[B]``
    tensors on the doc's device."""
    dev = doc.signed.device
    lead = (lambda t: t[None]) if doc.signed.dim() == 1 else (lambda t: t)

    def counts(v, bits):
        if isinstance(v, torch.Tensor):
            return lead(v.to(device=dev, dtype=I32)).clone()
        return torch.tensor([bits(int(v))], dtype=I32, device=dev)

    return FlatDoc(
        signed=lead(doc.signed).clone(), ol_log=lead(doc.ol_log).clone(),
        or_log=lead(doc.or_log).clone(), rank_log=lead(doc.rank_log).clone(),
        chars_log=lead(doc.chars_log).clone(),
        n=counts(doc.n, int), next_order=counts(doc.next_order, u32_bits))


def _single(doc: FlatDoc) -> FlatDoc:
    """Lane 0 of a batch of one, with ``n``/``next_order`` read back as
    ints."""
    return FlatDoc(signed=doc.signed[0], ol_log=doc.ol_log[0],
                   or_log=doc.or_log[0], rank_log=doc.rank_log[0],
                   chars_log=doc.chars_log[0], n=int(doc.n[0]),
                   next_order=int(doc.next_order[0]) & _M32)


def apply_ops(doc: FlatDoc, ops: OpTensors, prefill: bool = True) -> FlatDoc:
    """Apply a compiled step stream to one document.

    The by-order logs must be prefilled for this stream first:
    ``prefill=True`` (default) runs the host path ``batch.prefill_logs``;
    ``prefill=False`` leaves it to the caller (logs already prefilled, or
    ``apply_prefill_delta(doc, batch.prefill_delta(ops))`` applied).
    Applying an un-prefilled stream gives wrong results (NUL chars, wrong
    tiebreak ranks), not a crash. Returns a new document whose
    ``n``/``next_order`` are ints (read back from the device)."""
    from .batch import _map_fields, prefill_logs

    _check_capacity(doc, ops)
    if prefill:
        doc = prefill_logs(doc, ops)
    one = _batched_copy(doc)
    col = _map_fields(lambda a: np.asarray(a)[:, None], ops)
    flat_replay(one, col, skip_idle=False)
    return _single(one)


def apply_ops_batch(docs: FlatDoc, ops: OpTensors,
                    prefill: bool = True) -> FlatDoc:
    """Batched apply: ``docs`` has a leading doc axis, ``ops`` is
    time-major ``[S, B, ...]`` (``batch.stack_ops``/``tile_ops``). One
    launch on the card. Returns new docs."""
    from .batch import prefill_logs

    _check_capacity(docs, ops)
    if prefill:
        docs = prefill_logs(docs, ops)
    out = _batched_copy(docs)
    flat_replay(out, ops, skip_idle=False)
    return out


def apply_train(docs: FlatDoc, ops: OpTensors):
    """Apply a tick train — ``[T, S, B, ...]`` op tensors
    (``batch.stack_ticks``) — to batched docs in ONE launch. The caller
    applies the train's concatenated prefill delta first
    (``batch.concat_deltas`` + ``apply_prefill_delta``). Steps idle on
    every lane are skipped. Returns ``(docs, overflow_flag)``: new docs
    and a bool tensor on their device, set when a tick exceeded the static
    capacities mid-train (the docs are then corrupt; the serve backend's
    host-mirror check refuses such trains at enqueue)."""
    out = _batched_copy(docs)
    flags = flat_replay(out, ops, skip_idle=True)
    return out, flags.any()


def step(doc: FlatDoc, op: OpTensors, local_only: bool = False) -> FlatDoc:
    """Apply one compiled op to one document (``op`` fields scalars) or to
    a batch (``op`` fields ``[B]``): the plain version, on the doc's
    device. ``local_only`` treats every op as local (the JAX package's
    compiled-out remote paths; only valid for all-local streams).
    Returns a new doc."""
    batched = doc.signed.dim() == 2
    one = _batched_copy(doc)
    st = _working(one.signed, one.ol_log, one.or_log, one.rank_log, one.n,
                  one.next_order)
    dev = one.signed.device
    lanes = one.signed.shape[0]
    op64 = {f: torch.from_numpy(
        np.broadcast_to(np.asarray(getattr(op, f), dtype=np.uint32),
                        (lanes,)).astype(np.int64)).to(dev)
        for f in OP_COLUMNS}
    _plain_step(st, op64, int(np.asarray(op.chars).shape[-1]), local_only)
    _write_back(st, one.signed, one.ol_log, one.or_log, one.n,
                one.next_order)
    return one if batched else _single(one)


__all__ = [
    "OP_COLUMNS", "active_steps", "apply_ops",
    "apply_ops_batch", "apply_prefill_delta", "apply_train",
    "FLAT_STATS", "FLAT_STAT_NAMES", "Geometry", "LANES_PER_BLOCK",
    "check_capacity_counts", "describe_stats", "flat_replay",
    "flat_replay_cuda", "flat_replay_plain", "kernel_smem_bytes",
    "launch_geometry", "op_stack", "scatter_delta_", "step",
]
