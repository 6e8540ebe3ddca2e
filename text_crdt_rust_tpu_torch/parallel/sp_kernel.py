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
version (``SpReplay.plain``) is the CPU's.
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
_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 14 + [ctypes.c_void_p]


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


class _Launch:
    """One stream's buffers on the card: copies of the state (the inputs
    are not written), the op columns, the logs and the state struct."""

    def __init__(self, ordp, lenp, rows, oll, orl, rkl, cols, nsp, sidx):
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
        self.planes = [t.clone() for t in (ordp, lenp, oll, orl, rkl)]
        self.rows_in = rows
        self.cols = torch.from_numpy(cols).to(dev)
        self.ols = torch.zeros(S, dtype=I32, device=dev)
        self.ors = torch.zeros(S, dtype=I32, device=dev)
        self.st = torch.zeros(ST_WORDS, dtype=I32, device=dev)

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
                                       self.st, recv)]
        code = fn(*ptrs, self.R, self.OTS, self.S, self.nsp, self.sidx, n,
                  *flat, stream)
        _kernels.check(_KERNEL, code)
        _kernels.count_launch(_KERNEL)

    def outputs(self, err):
        ordp, lenp, oll, orl, rkl = self.planes
        rows = self.st[ST_ROWS:ST_ROWS + 1].clone()
        return ordp, lenp, rows, oll, orl, rkl, self.ols, self.ors, err


def sp_replay_cuda(ordp, lenp, rows, oll, orl, rkl, cols):
    """A whole op stream at sp = 1 in one launch of S1: the function of
    ``SpReplay.plain`` on a one-rank mesh, on CUDA tensors (``cols``:
    host int32 ``[9, S]``, ``sp_apply.OP_FIELDS`` order). Returns
    (ordp, lenp, rows, oll, orl, rkl, ols, ors, err), err being this
    rank's error bits (the caller ORs them over the group)."""
    run = _Launch(ordp, lenp, rows, oll, orl, rkl, cols, 1, 0)
    run.launch(run.st, None)
    return run.outputs(run.st[ST_ERR].clone())


class KernelSegments:
    """The segments of one rank on S1, for ``sp_apply.drive`` at sp > 1
    (any sp works; sp = 1 takes ``sp_replay_cuda``). ``run`` queues a
    segment; a collective or the loop's flag launches the queue, one
    launch for the work between two collectives."""

    def __init__(self, mesh, ordp, lenp, rows, oll, orl, rkl, cols):
        self.mesh = mesh
        self.k = _Launch(ordp, lenp, rows, oll, orl, rkl, cols, mesh.sp,
                         mesh.index("sp"))
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


__all__ = ["KernelSegments", "SEND_WIDTH", "check_geometry",
           "sp_replay_cuda"]
