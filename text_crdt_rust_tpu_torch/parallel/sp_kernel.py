"""S1: ``SpDoc``'s step program as one hand-written CUDA kernel
(``ops/csrc/sp_replay.cu``), the counterpart of the one device program
that the JAX package's ``make_sp_apply`` compiles a stream into (a
``jax.jit`` of a ``shard_map`` whose body is a ``lax.scan`` over the steps
with a ``lax.while_loop`` YATA scan; no ``pallas_call``).

The step's phases are cut at the collectives into segments
(``sp_apply._Shard``, the plain version, is the specification); a segment
reads the last collective's result and leaves the next one's input in a
small state struct (``ST_*``, int32 words on the card). Two launches:

- ``sp_replay_cuda``: a whole stream at sp = 1, in one launch. Each
  collective of a one-rank group is the identity, so S1 makes it in place
  and runs the YATA loop on the card, with no host read an iteration.
- ``KernelSegments``: the segment backend that ``sp_apply.drive`` runs at
  sp > 1. The collectives stay ``Mesh`` calls on the state's small send
  buffer, in the plain version's order and count; S1 runs the shard-local
  work between two of them, one launch a segment, its working state kept
  in the struct across launches. The host reads one flag an iteration of
  the integrate loop, as the plain version does.

Both check the geometry before any build and refuse CPU tensors: the plain
version (``SpReplay.plain``) is the CPU's. Each launch gets a scratch tile
index of the rows (``index_words``: four words a 32-row tile, allocated
from ``R``), which S1 rebuilds at the start of every launch, and copies of
the planes padded to whole 4-row quads; ``stats`` takes the counting build
(``SP_STAT_NAMES``, ``describe_stats``).

``tile_index``, ``index_rank`` and ``index_delete`` are a plain model of
how S1 answers the plain version's row-level counts and clips through that
index (the exact fast path, else the full pass): the tests hold them equal
to ``sp_apply._Shard`` after every step.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import _kernels

I32 = torch.int32

# Segment codes, in the order of ``sp_apply.drive`` (``sp_replay.cu``'s
# ``Seg``): local delete, local insert, remote delete, remote insert.
SEG_INIT = 0
SEG_LD_TOTAL, SEG_LD_COVER, SEG_LD_SPLIT = 1, 2, 3
SEG_LI_HEAD, SEG_LI_SPLICE, SEG_LI_END = 4, 5, 6
SEG_RD_COVER, SEG_RD_SPLIT = 7, 8
SEG_RI_TOTAL, SEG_RI_LEFT, SEG_RI_START, SEG_RI_RUN = 9, 10, 11, 12
SEG_RI_TABS, SEG_RI_OLEFT, SEG_RI_NEXT = 13, 14, 15
SEG_RI_SPLICE, SEG_RI_END, SEG_FINISH = 16, 17, 18

#: int32 words each segment leaves for the collective after it.
SEND_WIDTH = {SEG_LD_TOTAL: 1, SEG_LD_COVER: 1, SEG_LI_HEAD: 2,
              SEG_LI_SPLICE: 4, SEG_RD_COVER: 1, SEG_RI_TOTAL: 1,
              SEG_RI_LEFT: 2, SEG_RI_RUN: 3, SEG_RI_TABS: 3,
              SEG_RI_OLEFT: 2, SEG_RI_SPLICE: 2, SEG_FINISH: 1}

# The state struct's words (``sp_replay.cu``'s ``ST_*``).
ST_ROWS, ST_ERR, ST_MORE = 0, 1, 3
ST_SEND = 28
ST_WORDS = 32

MAX_ROWS = 1 << 30        # int32 row indices with room for rows + 2
MAX_ITEMS = 4             # segments one launch of KernelSegments runs

_KERNEL = "sp_replay"
_LAUNCH = "sp_replay_launch"
# 11 state, op and log tensors, the index scratch, stats; R, OTS, S, nsp,
# sidx, n_items and four (code, step) pairs; the stream.
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 14 + [ctypes.c_void_p]

TILE = 32                 # rows a tile of S1's index
SANE_LEN = 1 << 26        # a sane tile's lengths lie in [0, SANE_LEN)
INT_MAX = (1 << 31) - 1

#: Counters of S1's ``stats`` build (int64; ``sp_replay.cu``'s ``X_*``):
#: segments run, full passes taken (a count or clip the index cannot
#: answer exactly), index locates, shifts and the rows they moved, index
#: builds, the extent E at the end of the last launch; then ``clock64``
#: cycles in the index build and extent scan, totals, locates, delete
#: covers/flips, shifts, the YATA search, the table upkeep, the rest, and
#: in all. Counts and cycles add up over launches.
SP_STAT_NAMES = ("segments", "fallbacks", "locates", "moves", "moved_rows",
                 "index_builds", "extent", "cy_index", "cy_totals",
                 "cy_locate", "cy_delete", "cy_shift", "cy_yata",
                 "cy_tables", "cy_other", "cy_all")
SP_STATS = len(SP_STAT_NAMES)


def index_words(R: int) -> int:
    """int32 words of S1's tile index for ``R`` rows: four arrays (live
    sums, raw sums, counts of rows not sane, scan scratch) of one word for
    each of ceil(R / 32) tiles, rounded up to whole int4s; 16 B a tile (at most
    512 MiB at the 2^30 rows ``check_geometry`` takes)."""
    return 4 * ((-(-R // TILE) + 3) // 4 * 4)


def describe_stats(stats, steps: int) -> str:
    """S1's ``stats`` (``[SP_STATS]``) as a line of text: counts, cycles a
    step and the phases' cycle shares."""
    v = [int(x) for x in torch.as_tensor(stats).reshape(-1).tolist()]
    d = dict(zip(SP_STAT_NAMES, v))
    tot = max(d["cy_all"], 1)
    phases = ("index", "totals", "locate", "delete", "shift", "yata",
              "tables", "other")
    shares = ", ".join(f"{p} {d['cy_' + p] / tot:.4f}" for p in phases)
    per_shift = d["moved_rows"] / max(d["moves"], 1)
    return (f"{d['segments']} segments, {d['fallbacks']} full passes, "
            f"{d['locates']} locates, {d['moves']} shifts moving "
            f"{d['moved_rows']} rows ({per_shift:.1f} a shift), "
            f"{d['index_builds']} index builds, extent "
            f"{d['extent']}; {tot / max(steps, 1):.0f} cycles a step over "
            f"{steps} steps; cycle shares: {shares}")


def check_geometry(R: int, OTS: int, S: int) -> None:
    """Refuse, before any build, what S1 cannot hold: it indexes rows and
    table entries with int32, so each ``[R]`` plane and each ``[OTS]``
    table holds at most 2^30 entries (4 GiB)."""
    for what, n in (("run rows a shard (ordp/lenp)", R),
                    ("table rows a shard (oll/orl/rkl)", OTS)):
        if not 1 <= n <= MAX_ROWS:
            raise ValueError(
                f"S1 takes 1 to {MAX_ROWS} {what}: {n} would need "
                f"{4 * n} B a plane (limit {4 * MAX_ROWS} B)")
    if S >= 1 << 31:
        raise ValueError(f"S1 takes fewer than 2^31 steps, got {S}")


def _require_cuda(tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(
            f"S1 runs on CUDA tensors, got {dev}: the plain version "
            f"(SpReplay.plain) is the CPU's")
    for t in tensors:
        if not (t.device == dev and t.dtype == I32 and t.is_contiguous()):
            raise ValueError("S1 takes contiguous int32 tensors on one "
                             "device")
    return dev


def _quads(plane: torch.Tensor) -> torch.Tensor:
    """A copy of the ``[R]`` plane whose storage runs on to whole 4-row
    quads (zeros), for S1's int4 moves; the ``[R]`` view is returned."""
    R = plane.shape[0]
    buf = torch.zeros(-(-R // 4) * 4, dtype=plane.dtype, device=plane.device)
    buf[:R] = plane
    return buf[:R]


class _Launch:
    """One stream's buffers on the card: copies of the state (the inputs
    are not written), the op columns, the logs and the state struct."""

    def __init__(self, ordp, lenp, rows, oll, orl, rkl, cols, nsp, sidx,
                 stats=None):
        R, OTS = ordp.shape[0], oll.shape[0]
        cols = np.ascontiguousarray(np.asarray(cols, np.int32))
        if cols.ndim != 2 or cols.shape[0] != 9:
            raise ValueError(f"S1 takes op columns [9, S], got "
                             f"{cols.shape}")
        S = cols.shape[1]
        check_geometry(R, OTS, S)
        if lenp.shape != (R,) or rows.shape != (1,) \
                or orl.shape != (OTS,) or rkl.shape != (OTS,):
            raise ValueError("S1 takes ordp/lenp [R], rows [1], "
                             "oll/orl/rkl [OTS]")
        dev = _require_cuda((ordp, lenp, rows, oll, orl, rkl))
        self.R, self.OTS, self.S, self.nsp, self.sidx = R, OTS, S, nsp, sidx
        self.planes = [_quads(ordp), _quads(lenp)] + [
            t.clone() for t in (oll, orl, rkl)]
        self.rows_in = rows
        self.cols = torch.from_numpy(cols).to(dev)
        self.ols = torch.zeros(S, dtype=I32, device=dev)
        self.ors = torch.zeros(S, dtype=I32, device=dev)
        self.st = torch.zeros(ST_WORDS, dtype=I32, device=dev)
        # S1 writes every entry it reads: the index is rebuilt each launch.
        self.index = torch.empty(index_words(R), dtype=I32, device=dev)
        if stats is not None and not (
                stats.device == dev and stats.dtype == torch.int64
                and stats.is_contiguous() and stats.shape == (SP_STATS,)):
            raise ValueError(f"stats must be a contiguous int64 "
                             f"[{SP_STATS}] on the card")
        self.stats = stats

    def launch(self, recv: torch.Tensor, items) -> None:
        """One launch on PyTorch's current stream: the whole stream
        (``items`` None) or up to ``MAX_ITEMS`` (code, step) segments."""
        fn = _kernels.function(_KERNEL, _LAUNCH, _ARGTYPES)
        if items is None:
            n, flat = -1, [0] * (2 * MAX_ITEMS)
        else:
            n = len(items)
            flat = [v for it in items for v in it]
            flat += [0] * (2 * MAX_ITEMS - len(flat))
        stream = torch.cuda.current_stream(self.st.device).cuda_stream
        ptrs = [t.data_ptr() for t in (*self.planes, self.rows_in,
                                       self.cols, self.ols, self.ors,
                                       self.st, recv, self.index)]
        code = fn(*ptrs, None if self.stats is None
                  else self.stats.data_ptr(), self.R, self.OTS, self.S,
                  self.nsp, self.sidx, n, *flat, stream)
        _kernels.check(_KERNEL, code)
        _kernels.count_launch(_KERNEL)

    def outputs(self, err):
        ordp, lenp, oll, orl, rkl = self.planes
        rows = self.st[ST_ROWS:ST_ROWS + 1].clone()
        return ordp, lenp, rows, oll, orl, rkl, self.ols, self.ors, err


def sp_replay_cuda(ordp, lenp, rows, oll, orl, rkl, cols, *, stats=None):
    """A whole op stream at sp = 1 in one launch of S1: the function of
    ``SpReplay.plain`` on a one-rank mesh, on CUDA tensors (``cols``:
    host int32 ``[9, S]``, ``sp_apply.OP_FIELDS`` order). Returns
    (ordp, lenp, rows, oll, orl, rkl, ols, ors, err), err being this
    rank's error bits (the caller ORs them over the group). ``stats``, an
    int64 ``[SP_STATS]`` tensor on the card, takes the counting build and
    receives its counters (added to what it holds)."""
    run = _Launch(ordp, lenp, rows, oll, orl, rkl, cols, 1, 0, stats)
    run.launch(run.st, None)
    return run.outputs(run.st[ST_ERR].clone())


class KernelSegments:
    """The segments of one rank on S1, for ``sp_apply.drive`` at sp > 1
    (any sp works; sp = 1 takes ``sp_replay_cuda``). ``run`` queues a
    segment; a collective or the loop's flag launches the queue, one
    launch for the work between two collectives."""

    def __init__(self, mesh, ordp, lenp, rows, oll, orl, rkl, cols, *,
                 stats=None):
        self.mesh = mesh
        self.k = _Launch(ordp, lenp, rows, oll, orl, rkl, cols, mesh.sp,
                         mesh.index("sp"), stats)
        self.recv = self.k.st
        self.items = []
        self.last = SEG_INIT

    def run(self, code: int, s: int) -> None:
        self.items.append((code, s))
        self.last = code
        if len(self.items) == MAX_ITEMS:
            self.flush()

    def flush(self) -> None:
        if self.items:
            self.k.launch(self.recv, self.items)
            self.items = []

    def _send(self) -> torch.Tensor:
        self.flush()
        return self.k.st[ST_SEND:ST_SEND + SEND_WIDTH[self.last]]

    def gather(self) -> None:
        self.recv = self.mesh.all_gather(self._send())

    def sum(self) -> None:
        self.recv = self.mesh.sum(self._send())

    def more(self) -> bool:
        self.flush()
        return bool(self.k.st[ST_MORE].item())

    def result(self):
        err = self.mesh.bor(self._send())[0]
        return self.k.outputs(err)


# -- a plain model of S1's index rules (the tests hold it to _Shard) -------


def _i32(x) -> int:
    """x wrapped to int32."""
    return int((int(x) + (1 << 31)) % (1 << 32)) - (1 << 31)


def tile_index(ordp, lenp, E: int):
    """S1's tile index of rows [0, E) of int32 planes: for each 32-row
    tile the wrapping sums of the live and of the raw lengths (uint32),
    and the sane bit (every length in [0, SANE_LEN))."""
    R = len(ordp)
    nt = -(-E // TILE)
    n = min(nt * TILE, R)
    o = np.zeros(nt * TILE, np.int64)
    ln = np.zeros(nt * TILE, np.int64)
    o[:n] = np.asarray(ordp, np.int64)[:n]
    ln[:n] = np.asarray(lenp, np.int64)[:n]
    o, ln = o.reshape(nt, TILE), ln.reshape(nt, TILE)
    live = np.where(o > 0, ln, 0).sum(1) % (1 << 32)
    raw = ln.sum(1) % (1 << 32)
    sane = ((ln >= 0) & (ln < SANE_LEN)).all(1)
    return live.astype(np.uint64), raw.astype(np.uint64), sane


def _lengths(ordp, lenp, live: bool) -> np.ndarray:
    o, ln = np.asarray(ordp, np.int64), np.asarray(lenp, np.int64)
    return np.where(o > 0, ln, 0) if live else ln


def _excl(sums, v, i: int) -> int:
    """Row i's exclusive wrapping prefix, as S1 takes it from the index:
    the tiles before its tile, then its tile's rows before it."""
    t = i // TILE
    return _i32(int(sums[:t].sum()) + int(v[t * TILE:i].sum()))


def _locate(sums, v, X: int, strict: bool):
    """The first row whose exact inclusive prefix reaches X (> X when
    strict, else >= X) through the index: the first tile whose end
    reaches it, then that tile's rows; None when no row does."""
    def reach(x):
        return x > X if strict else x >= X
    pre = 0
    for t, s in enumerate(sums.tolist()):
        if reach(pre + s):
            acc = pre
            for j in range(t * TILE, min((t + 1) * TILE, len(v))):
                acc += int(v[j])
                if reach(acc):
                    return j
        pre += s
    return None


def index_rank(ordp, lenp, rows: int, E: int, X: int, live: bool,
               strict: bool):
    """S1's answer to the plain version's ``min(#{j < rows : incl_j < X},
    R - 1)`` (``<= X`` when strict; incl the inclusive wrapping prefix of
    the live or raw lengths) and that row's exclusive prefix: a locate
    through the index where every tile of [0, E) is sane and the total is
    at most INT_MAX, else the full pass's row-level count. Returns
    (row, exclusive prefix, fast)."""
    R = len(ordp)
    lv, raw, sane = tile_index(ordp, lenp, E)
    sums = lv if live else raw
    v = _lengths(ordp, lenp, live)
    fast = bool(sane.all()) and int(sums.sum()) <= INT_MAX
    rows_c = min(max(rows, 0), R)
    if fast:
        k = _locate(sums, v, X, strict)
        cnt = min(rows_c, R if k is None else k)
    else:
        incl = [_i32(x) for x in np.cumsum(v[:E])]
        cnt = sum(1 for j, x in enumerate(incl)
                  if j < rows and (x <= X if strict else x < X))
    i_r = min(cnt, R - 1)
    return i_r, _excl(sums, v, i_r), fast


def _clip(p: int, pe: int, b: int, lv: int):
    cs = min(max(_i32(p - b), 0), lv)
    ce = min(max(_i32(pe - b), 0), lv)
    return cs, ce


def index_delete(ordp, lenp, E: int, carry: int, p: int, d: int):
    """S1's local delete of the live span [p, p + d) on a shard whose live
    characters start at ``carry``: the covered count, the rows wholly
    covered (a bool mask over [0, R)) and the partial rows with their
    clips ``{row: (cs, ce)}``, as the plain version's row-level clips give
    them. Where every tile of [0, E) is sane and the carry, the span and
    the shard's end lie in [0, INT_MAX]: the count is the overlap of two
    intervals and the rows come from two locates (the first row ending
    past p, the first reaching p + d), the live rows between them wholly
    covered; else the full pass clips every row. Returns (covered, full,
    partial, fast)."""
    R = len(ordp)
    lv_t, _, sane = tile_index(ordp, lenp, E)
    o, ln = np.asarray(ordp, np.int64), np.asarray(lenp, np.int64)
    v = _lengths(ordp, lenp, True)
    pe = _i32(p + d)
    total = int(lv_t.sum())
    full = np.zeros(R, bool)
    partial = {}
    fast = (bool(sane.all()) and carry >= 0 and p >= 0 and d > 0
            and p + d <= INT_MAX and carry + total <= INT_MAX)
    if fast:
        covered = max(0, min(p + d, carry + total) - max(p, carry))
        ja = _locate(lv_t, v, p - carry, True)
        ke = _locate(lv_t, v, pe - carry, False)
        if ja is not None:
            kx = E if ke is None else ke
            for j in range(ja + 1, kx):
                full[j] = o[j] > 0 and ln[j] > 0
            for j in sorted({ja} | ({ke} if ke is not None else set())):
                cs, ce = _clip(p, pe, _i32(carry + _excl(lv_t, v, j)),
                               int(v[j]))
                cov = ce - cs
                full[j] = cov > 0 and cov == ln[j]
                if cov > 0 and not full[j]:
                    partial[j] = (cs, ce)
        return covered, full, partial, True
    covered = 0
    for j in range(min(E, R)):
        cs, ce = _clip(p, pe, _i32(carry + _excl(lv_t, v, j)), int(v[j]))
        cov = _i32(ce - cs)
        covered = _i32(covered + cov)
        full[j] = cov > 0 and cov == ln[j]
        if cov > 0 and not full[j]:
            partial[j] = (cs, ce)
    return covered, full, partial, False


def extent(ext: int, rows: int, R: int) -> int:
    """S1's extent: rows [0, E) hold every nonzero row, E = max(ext, rows
    + 2) within [1, R]."""
    return max(1, min(R, max(ext, rows + 2)))


__all__ = ["KernelSegments", "SEND_WIDTH", "SP_STATS", "SP_STAT_NAMES",
           "check_geometry", "describe_stats", "extent", "index_delete",
           "index_rank", "index_words", "sp_replay_cuda", "tile_index"]
