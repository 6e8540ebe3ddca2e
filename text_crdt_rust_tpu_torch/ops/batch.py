"""Host-side op compiler, local-edit subset (counterpart of
``text_crdt_rust_tpu/ops/batch.py``): numpy on the host; only
``prefill_logs`` touches a document's tensors.

The replay kernels consume pre-compiled, fixed-shape op tensors: one row
per device step, everything an op needs resolved to dense integers on the
host. This module carries the local-edit path of the north-star replay:
``merge_patches`` (RLE-coalescing of the patch stream),
``compile_local_patches`` (order allocation, insert chunking at ``lmax``,
W-row backwards-burst fusion), the generalized step fuser
``fuse_steps`` and the by-order log prefill; and the remote path of the
storm: ``AgentTable`` (name ranks for the YATA tiebreak),
``OrderAssigner`` (per-agent seq -> order maps) and
``compile_remote_txns``; for the per-document streams,
``row_growth_bound``, ``pad_ops`` and ``stack_ops``; and for the serve
batcher, ``rank_remap`` (agent-onboarding epochs),
``OrderAssigner.from_oracle`` (resume after a checkpoint restore),
``empty_ops`` and ``concat_ops``; for the flat engine's serve backend,
``prefill_delta``/``concat_deltas`` (the device-resident log prefill),
``stack_ticks`` (tick trains) and ``tile_ops``. Every function returns the
same arrays, field for field, as its JAX-package counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import (
    CLIENT_INVALID,
    ROOT_ORDER,
    RemoteId,
    RemoteIns,
    RemoteTxn,
    txn_len,
)
from ..utils.rle import KOrderSpan, Rle
from ..utils.testdata import TestData, TestPatch, flatten_patches

# Op kinds (shared with the JAX package's device dispatch).
KIND_LOCAL = 0        # delete del_len live chars at pos, then insert at pos
KIND_REMOTE_INS = 1   # YATA-integrate an insert run at resolved origins
KIND_REMOTE_DEL = 2   # tombstone an order-contiguous target range

#: Engines of the port whose insert splice accepts W-row fused steps
#: (the port's stand-in for the JAX package's registry ``fused_steps``).
FUSED_ENGINES: Tuple[str, ...] = ("rle", "rle-hbm")


@dataclasses.dataclass
class OpTensors:
    """One device step per row; all u32 numpy arrays. Batched streams
    stack a trailing doc axis *after* the step axis."""

    kind: np.ndarray             # u32[S, ...]
    pos: np.ndarray              # u32[S, ...]   KIND_LOCAL: content position
    del_len: np.ndarray          # u32[S, ...]   local del span / remote target len
    del_target: np.ndarray       # u32[S, ...]   KIND_REMOTE_DEL: first target order
    origin_left: np.ndarray      # u32[S, ...]   KIND_REMOTE_INS
    origin_right: np.ndarray     # u32[S, ...]   KIND_REMOTE_INS
    ins_len: np.ndarray          # u32[S, ...]
    ins_order_start: np.ndarray  # u32[S, ...]   first order of the insert run
    order_advance: np.ndarray    # u32[S, ...]   orders consumed by this step
    rank: np.ndarray             # u32[S, ...]   author agent's name rank
    rows_per_step: np.ndarray    # u32[S, ...]   W: run rows this step splices
    #   (1 = plain op; W > 1 = a FUSED backwards-contiguous insert burst:
    #   W same-length runs spliced in one step, orders DESCENDING in doc
    #   order with stride L = ins_len/W. 0 only on no-op padding rows.)
    chars: np.ndarray            # u32[S, ..., LMAX]

    @property
    def num_steps(self) -> int:
        return self.kind.shape[0]

    @property
    def lmax(self) -> int:
        return self.chars.shape[-1]


class AgentTable:
    """Agent name <-> dense id + *name rank* table.

    The device tiebreak compares ranks; ranks are the index of each name in
    the sorted name list, so rank order == name order (`doc.rs:206-209`).
    Within ONE compiled stream the table must not change (the steps bake
    ranks in). ACROSS compiled epochs peers may join freely: agent IDS are
    append-only (``OrderAssigner`` state stays valid), and persisted rank
    tables are re-based through ``rank_remap`` at the epoch boundary.
    """

    def __init__(self, names: Iterable[str] = ()):
        self.names: List[str] = []
        self._ids: Dict[str, int] = {}
        for n in names:
            self.add(n)

    def add(self, name: str) -> int:
        if name == "ROOT":
            return CLIENT_INVALID
        if name not in self._ids:
            self._ids[name] = len(self.names)
            self.names.append(name)
        return self._ids[name]

    def id_of(self, name: str) -> int:
        if name == "ROOT":
            return CLIENT_INVALID
        return self._ids[name]

    def __contains__(self, name: str) -> bool:
        return name in self._ids

    def rank_of_agent(self) -> np.ndarray:
        """rank_of_agent[dense agent id] -> name rank (u32)."""
        order = sorted(range(len(self.names)), key=lambda i: self.names[i])
        ranks = np.zeros(len(self.names), dtype=np.uint32)
        for r, i in enumerate(order):
            ranks[i] = r
        return ranks

    def rank_of(self, name: str) -> int:
        return int(self.rank_of_agent()[self.id_of(name)])


def rank_remap(old_names: Sequence[str], table: AgentTable) -> np.ndarray:
    """old-epoch rank -> new-epoch rank (u32[len(old_names)]).

    When a peer joins between compiled epochs, the sorted-name ranks of
    existing agents shift; device state that PERSISTED ranks (the by-order
    rank table a serve lane carries for the Yjs tiebreak) must be re-based
    before applying steps compiled against the new table
    (``serve.lanes_backend.remap_lane_ranks``).
    """
    for n in old_names:
        if n not in table:
            raise ValueError(f"agent {n!r} missing from the new table")
    old_sorted = sorted(old_names)
    out = np.zeros(len(old_names), dtype=np.uint32)
    for old_rank, name in enumerate(old_sorted):
        out[old_rank] = table.rank_of(name)
    return out


class OrderAssigner:
    """Host twin of the order-allocation metadata (`doc.rs:155-165`):
    per-agent seq->order RLE maps (`list/mod.rs:33-43`) + the dense
    ``next_order`` counter. Shared by the compiler and the causal layer."""

    def __init__(self, table: AgentTable):
        self.table = table
        self.item_orders: List[Rle[KOrderSpan]] = [
            Rle() for _ in table.names
        ]
        self.next_order = 0

    @classmethod
    def from_oracle(cls, doc, table: "AgentTable") -> "OrderAssigner":
        """Rebuild the compiler's order metadata from a live (or
        checkpoint-restored) oracle document, so compilation can resume
        mid-history — the serve layer's restore path
        (`serve/residency.py`): a doc evicted to a checkpoint loses its
        in-memory assigner, and the restored oracle's per-agent
        ``item_orders`` are exactly the state to resume from.

        ``table`` must list the oracle's agents in dense-id order (the
        checkpoint meta's ``agents`` list) so agent ids align."""
        if table.names != [cd.name for cd in doc.client_data]:
            raise ValueError(
                "agent table order must match the oracle's dense agent ids")
        out = cls(table)
        for aid, cd in enumerate(doc.client_data):
            io = out._orders_of(aid)
            for e in cd.item_orders:
                io.append(KOrderSpan(e.seq, e.order, e.length))
        out.next_order = doc.get_next_order()
        return out

    def _orders_of(self, agent_id: int) -> Rle:
        while agent_id >= len(self.item_orders):
            self.item_orders.append(Rle())
        return self.item_orders[agent_id]

    def next_seq(self, agent_id: int) -> int:
        io = self._orders_of(agent_id)
        last = io.last()
        return last.seq + last.length if last is not None else 0

    def assign(self, agent_id: int, seq: int, length: int) -> int:
        """Allocate ``length`` dense orders to (agent, seq..) and return the
        first (`doc.rs:155-165`)."""
        first = self.next_order
        self._orders_of(agent_id).append(KOrderSpan(seq, first, length))
        self.next_order += length
        return first

    def seq_to_order(self, agent_id: int, seq: int) -> int:
        found = self._orders_of(agent_id).find(seq)
        if found is None:
            raise ValueError(f"unknown seq {seq} for agent {agent_id}")
        entry, off = found
        return entry.order + off

    def resolve(self, rid: RemoteId) -> int:
        if rid.agent == "ROOT":
            return ROOT_ORDER
        return self.seq_to_order(self.table.id_of(rid.agent), rid.seq)

    def target_runs(self, agent_id: int, seq: int,
                    length: int) -> List[Tuple[int, int]]:
        """Split a (agent, seq, len) delete target into order-contiguous
        (first_order, len) runs (the `doc.rs:311-334` fragmentation walk,
        done in seq space like the oracle)."""
        runs: List[Tuple[int, int]] = []
        io = self._orders_of(agent_id)
        remaining = length
        while remaining > 0:
            found = io.find(seq)
            if found is None:
                raise ValueError(f"delete target seq {seq} unknown")
            entry, off = found
            take = min(entry.length - off, remaining)
            runs.append((entry.order + off, take))
            seq += take
            remaining -= take
        return runs


class _Rows:
    """Column accumulator for compiled steps."""

    def __init__(self, lmax: int):
        self.lmax = lmax
        self.cols: Dict[str, list] = {
            f.name: [] for f in dataclasses.fields(OpTensors)
        }

    def emit(self, *, kind=0, pos=0, del_len=0, del_target=0,
             origin_left=ROOT_ORDER, origin_right=ROOT_ORDER, ins_len=0,
             ins_order_start=0, order_advance=0, rank=0, rows=1,
             content="") -> None:
        # ``content``: str, or a uint32 codepoint array (``fuse_steps``
        # re-emits rows it already holds as codepoints).
        if ins_len > self.lmax:
            raise ValueError(f"insert of {ins_len} exceeds lmax {self.lmax}")
        if rows < 1 or (rows != 1 and ins_len % rows != 0):
            raise ValueError(f"bad fused width {rows} for ins_len {ins_len}")
        cps = np.zeros(self.lmax, dtype=np.uint32)
        if len(content):
            if len(content) != ins_len:
                raise ValueError("content length differs from ins_len")
            if isinstance(content, str):
                cps[:ins_len] = np.frombuffer(
                    content.encode("utf-32-le"), dtype=np.uint32)
            else:
                cps[:ins_len] = content
        c = self.cols
        c["kind"].append(kind)
        c["pos"].append(pos)
        c["del_len"].append(del_len)
        c["del_target"].append(del_target)
        c["origin_left"].append(origin_left)
        c["origin_right"].append(origin_right)
        c["ins_len"].append(ins_len)
        c["ins_order_start"].append(ins_order_start)
        c["order_advance"].append(order_advance)
        c["rank"].append(rank)
        c["rows_per_step"].append(rows)
        c["chars"].append(cps)

    def to_tensors(self) -> OpTensors:
        c = self.cols
        return OpTensors(
            **{k: np.asarray(v, dtype=np.uint32) for k, v in c.items()
               if k != "chars"},
            chars=(np.stack(c["chars"]) if c["chars"]
                   else np.zeros((0, self.lmax), dtype=np.uint32)),
        )


def merge_patches(patches: Sequence[TestPatch]) -> List[TestPatch]:
    """RLE-coalesce adjacent same-kind, position-contiguous patches: a
    typing run, a forward-delete run (same ``pos``) or a backspace run
    collapses to ONE op. The merged stream gives the same final state,
    per-char orders and origins as the per-keystroke stream (the JAX
    package's docstring carries the proof and the backspace caveat).

    automerge-paper: 259,778 patches -> 10,712 merged ops."""
    out: List[TestPatch] = []
    for p in patches:
        if out:
            q = out[-1]
            if (q.del_len == 0 and p.del_len == 0 and p.ins_content
                    and q.ins_content
                    and p.pos == q.pos + len(q.ins_content)):
                q.ins_content += p.ins_content
                continue
            if (not q.ins_content and not p.ins_content
                    and q.del_len and p.del_len):
                if p.pos == q.pos:               # forward-delete run
                    q.del_len += p.del_len
                    continue
                if p.pos + p.del_len == q.pos:   # backspace run
                    q.pos = p.pos
                    q.del_len += p.del_len
                    continue
        out.append(TestPatch(p.pos, p.del_len, p.ins_content))
    return out


def fused_width(ops: OpTensors) -> int:
    """Max ``rows_per_step`` of a compiled stream (1 for empty streams)."""
    r = np.asarray(ops.rows_per_step)
    return max(int(r.max()) if r.size else 1, 1)


def fused_engine_names() -> Tuple[str, ...]:
    """Engines of the port whose insert splice accepts W-row fused steps."""
    return FUSED_ENGINES


def require_unfused(ops: OpTensors, engine: str) -> None:
    """Reject a fused stream on an engine without the W-row splice."""
    if fused_width(ops) > 1:
        raise ValueError(
            f"{engine} has no fused multi-row splice; compile with "
            f"fuse_w=1 (fused streams run on the fused-step engines: "
            f"{', '.join(fused_engine_names())})")


def fused_width_checked(streams, block_k: int) -> int:
    """WMAX of a stream set, validated against the fused engines' rule
    ``WMAX <= K//2 - 1``: a freshly split block holds up to ceil(K/2)
    rows and must fit W new rows + one split tail."""
    wmax = max(fused_width(st) for st in streams)
    if wmax > 1 and wmax > block_k // 2 - 1:
        raise ValueError(
            f"fused rows_per_step {wmax} exceeds the one-split headroom "
            f"of block_k {block_k} (need WMAX <= K//2 - 1: a freshly "
            f"split block holds up to ceil(K/2) rows and must fit W+1 "
            f"more)")
    return wmax


def _burst_len(patches: Sequence[TestPatch], i: int) -> int:
    """Length of the maximal backwards-contiguous insert burst starting
    at patch ``i``: consecutive insert-only patches at the SAME position
    with EQUAL insert lengths (the kevin prepend shape)."""
    p0 = patches[i]
    if p0.del_len or not p0.ins_content:
        return 1
    L = len(p0.ins_content)
    j = i + 1
    while (j < len(patches) and not patches[j].del_len
           and len(patches[j].ins_content) == L
           and patches[j].pos == p0.pos):
        j += 1
    return j - i


def compile_local_patches(
    patches: Sequence[TestPatch],
    rank: int = 0,
    lmax: int = 16,
    start_order: int = 0,
    dmax: Optional[int] = None,
    fuse_w: int = 1,
    fuse_shapes: str = "burst",
) -> Tuple[OpTensors, int]:
    """Single-author local edit stream -> op tensors; returns
    ``(ops, next_order)``.

    Each patch deletes then inserts at ``pos`` (delete ops take the
    earlier order numbers, then the insert run). Inserts longer than
    ``lmax`` are chunked; ``dmax`` additionally chunks deletes. ``fuse_w
    > 1`` compiles backwards-contiguous insert bursts into W-row fused
    steps; ``fuse_shapes="all"`` also runs ``fuse_steps`` on the result.
    """
    if dmax is not None and dmax < 1:
        raise ValueError(f"dmax must be >= 1, got {dmax}")
    if fuse_w < 1:
        raise ValueError(f"fuse_w must be >= 1, got {fuse_w}")
    if fuse_shapes not in ("burst", "all"):
        raise ValueError(f"unknown fuse_shapes {fuse_shapes!r}")
    rows = _Rows(lmax)
    next_order = start_order
    patches = list(patches)
    i = 0
    while i < len(patches):
        p = patches[i]
        L = len(p.ins_content)
        w_cap = min(fuse_w, lmax // L) if L else 1
        # Scan for a burst only when one could fuse (an unfusable shape
        # must not re-walk the remaining run from every index).
        burst = _burst_len(patches, i) if (fuse_w > 1 and w_cap >= 2) \
            else 1
        if burst >= 2 and w_cap >= 2:
            while burst > 0:
                w = min(w_cap, burst)
                group = patches[i:i + w]
                # Chars are ORDER-major (patch k at [k*L, (k+1)*L)); the
                # device splices the rows in reverse patch order.
                rows.emit(
                    kind=KIND_LOCAL, pos=p.pos, ins_len=w * L,
                    ins_order_start=next_order, order_advance=w * L,
                    rank=rank, rows=w,
                    content="".join(g.ins_content for g in group),
                )
                next_order += w * L
                burst -= w
                i += w
            continue
        i += 1
        ins = p.ins_content
        first_chunk = ins[:lmax]
        dfirst = p.del_len if dmax is None else min(p.del_len, dmax)
        # First step: (a chunk of) the delete + the first insert chunk.
        rows.emit(
            kind=KIND_LOCAL, pos=p.pos, del_len=dfirst,
            ins_len=len(first_chunk),
            ins_order_start=next_order + p.del_len,
            order_advance=dfirst + len(first_chunk),
            rank=rank, content=first_chunk,
        )
        next_order += p.del_len + len(first_chunk)
        # Remaining delete chunks run after the first insert chunk landed
        # at pos, so the chars still to delete sit after it.
        doff = dfirst
        while doff < p.del_len:
            chunk_len = min(p.del_len - doff, dmax)
            rows.emit(
                kind=KIND_LOCAL, pos=p.pos + len(first_chunk),
                del_len=chunk_len, order_advance=chunk_len, rank=rank,
            )
            doff += chunk_len
        off = len(first_chunk)
        while off < len(ins):
            chunk = ins[off:off + lmax]
            rows.emit(
                kind=KIND_LOCAL, pos=p.pos + off, ins_len=len(chunk),
                ins_order_start=next_order, order_advance=len(chunk),
                rank=rank, content=chunk,
            )
            next_order += len(chunk)
            off += len(chunk)
    ops = rows.to_tensors()
    if fuse_shapes == "all":
        ops, _ = fuse_steps(ops, fuse_w=fuse_w, dmax=dmax)
    return ops, next_order


def compile_trace(data: TestData, rank: int = 0, lmax: int = 16
                  ) -> Tuple[OpTensors, int]:
    """The whole trace's local patches compiled as one stream (the
    ``benches/yjs.rs`` replay): ``compile_local_patches`` of
    ``flatten_patches(data)``."""
    return compile_local_patches(flatten_patches(data), rank=rank, lmax=lmax)


# -- generalized step fusion --------------------------------------------------

# Fusable shapes, named for the histogram.  Each entry counts ROWS
# ELIMINATED (ops that piggybacked on an earlier step's row).
FUSE_SHAPES = ("typing", "sweep", "replace", "burst",
               "remote_ins_run", "remote_del_run")


@dataclasses.dataclass
class FuseStats:
    """Per-shape accounting of one ``fuse_steps`` pass. ``step_map`` maps
    each INPUT step index to the OUTPUT step that absorbed it."""

    steps_in: int = 0
    steps_out: int = 0
    fused: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {s: 0 for s in FUSE_SHAPES})
    step_map: Optional[List[int]] = None

    @property
    def rows_saved(self) -> int:
        return self.steps_in - self.steps_out

    @property
    def reduction_x(self) -> float:
        return self.steps_in / self.steps_out if self.steps_out else 1.0

    def to_dict(self) -> Dict[str, object]:
        return {"steps_in": self.steps_in, "steps_out": self.steps_out,
                "rows_saved": self.rows_saved,
                "reduction_x": round(self.reduction_x, 3),
                "fused": dict(self.fused)}

    def merge(self, other: "FuseStats") -> None:
        """Fold another pass's counts in (the serve batcher's run total);
        ``step_map`` is per stream and is dropped."""
        self.steps_in += other.steps_in
        self.steps_out += other.steps_out
        self.step_map = None
        for k, v in other.fused.items():
            self.fused[k] = self.fused.get(k, 0) + v


class _FRow:
    """One mutable step row while the fuser walks the stream."""

    __slots__ = ("kind", "pos", "del_len", "del_target", "origin_left",
                 "origin_right", "ins_len", "st", "order_advance", "rank",
                 "w", "chars")

    def __init__(self, kind, pos, del_len, del_target, origin_left,
                 origin_right, ins_len, st, order_advance, rank, w,
                 chars):
        self.kind = kind
        self.pos = pos
        self.del_len = del_len
        self.del_target = del_target
        self.origin_left = origin_left
        self.origin_right = origin_right
        self.ins_len = ins_len
        self.st = st
        self.order_advance = order_advance
        self.rank = rank
        self.w = w
        self.chars = chars  # logical content only (ins_len entries)

    @property
    def stride(self) -> int:
        return self.ins_len // self.w if self.w else self.ins_len

    def is_noop(self) -> bool:
        return self.del_len == 0 and self.ins_len == 0


def _try_fuse(cur: _FRow, nxt: _FRow, lmax: int, fuse_w: int,
              dmax=None):
    """Try to fold step ``nxt`` into ``cur`` (adjacent in the stream).
    Returns the shape name on success (``cur`` mutated), else None. Every
    rule preserves the device-visible state bit-exactly; the JAX
    package's ``_try_fuse`` carries the per-rule proofs."""
    if nxt.w != 1 or nxt.is_noop() or cur.is_noop():
        return None
    loc = KIND_LOCAL
    del_fits = (dmax is None
                or cur.del_len + nxt.del_len <= dmax)

    # Backwards-contiguous insert burst -> one W-row step.
    if (fuse_w > 1 and cur.kind == loc and nxt.kind == loc
            and cur.del_len == 0 and nxt.del_len == 0
            and cur.ins_len > 0 and nxt.ins_len > 0
            and nxt.pos == cur.pos and cur.rank == nxt.rank
            and nxt.ins_len == cur.stride
            and nxt.st == cur.st + cur.ins_len
            and cur.w + 1 <= fuse_w
            and cur.ins_len + nxt.ins_len <= lmax):
        cur.w += 1
        cur.ins_len += nxt.ins_len
        cur.order_advance += nxt.order_advance
        cur.chars = np.concatenate([cur.chars, nxt.chars])
        return "burst"

    if cur.w != 1:
        return None

    # Forward typing run -> ONE coalesced row.
    if (cur.kind == loc and nxt.kind == loc and nxt.del_len == 0
            and cur.ins_len > 0 and nxt.ins_len > 0
            and cur.rank == nxt.rank
            and nxt.pos == cur.pos + cur.ins_len
            and nxt.st == cur.st + cur.ins_len
            and cur.ins_len + nxt.ins_len <= lmax):
        cur.ins_len += nxt.ins_len
        cur.order_advance += nxt.order_advance
        cur.chars = np.concatenate([cur.chars, nxt.chars])
        return "typing"

    # Local delete sweep: forward-delete or backspace.
    if (cur.kind == loc and nxt.kind == loc and cur.ins_len == 0
            and nxt.ins_len == 0 and cur.del_len > 0 and nxt.del_len > 0
            and del_fits):
        if nxt.pos == cur.pos:                     # forward-delete run
            cur.del_len += nxt.del_len
            cur.order_advance += nxt.order_advance
            return "sweep"
        if nxt.pos + nxt.del_len == cur.pos:       # backspace run
            cur.pos = nxt.pos
            cur.del_len += nxt.del_len
            cur.order_advance += nxt.order_advance
            return "sweep"
        return None

    # Replace: a pure delete then a pure insert at the SAME position is
    # the delete+insert pair one KIND_LOCAL row already expresses.
    if (cur.kind == loc and nxt.kind == loc and cur.ins_len == 0
            and cur.del_len > 0 and nxt.del_len == 0 and nxt.ins_len > 0
            and nxt.pos == cur.pos):
        cur.ins_len = nxt.ins_len
        cur.st = nxt.st
        cur.rank = nxt.rank
        cur.order_advance += nxt.order_advance
        cur.chars = nxt.chars
        return "replace"

    # Remote insert run continuing the previous one.
    if (cur.kind == KIND_REMOTE_INS and nxt.kind == KIND_REMOTE_INS
            and cur.ins_len > 0 and nxt.ins_len > 0
            and cur.rank == nxt.rank
            and nxt.origin_left == cur.st + cur.ins_len - 1
            and nxt.origin_right == cur.origin_right
            and nxt.st == cur.st + cur.ins_len
            and cur.ins_len + nxt.ins_len <= lmax):
        cur.ins_len += nxt.ins_len
        cur.order_advance += nxt.order_advance
        cur.chars = np.concatenate([cur.chars, nxt.chars])
        return "remote_ins_run"

    # Remote delete run over order-contiguous target ranges.
    if (cur.kind == KIND_REMOTE_DEL and nxt.kind == KIND_REMOTE_DEL
            and cur.del_len > 0 and nxt.del_len > 0
            and del_fits):
        if nxt.del_target == cur.del_target + cur.del_len:
            cur.del_len += nxt.del_len
            cur.order_advance += nxt.order_advance
            return "remote_del_run"
        if nxt.del_target + nxt.del_len == cur.del_target:
            cur.del_target = nxt.del_target
            cur.del_len += nxt.del_len
            cur.order_advance += nxt.order_advance
            return "remote_del_run"
        return None

    return None


def fuse_steps(ops: OpTensors, lmax: Optional[int] = None,
               fuse_w: int = 1, dmax: Optional[int] = None
               ) -> Tuple[OpTensors, FuseStats]:
    """Generalized step fusion: one greedy adjacent pass over a compiled
    stream, folding the fusable shapes (``FUSE_SHAPES``) into multi-op
    device steps. ``fuse_w`` > 1 additionally emits W-row backwards-burst
    steps; ``lmax`` caps merged insert lengths (default: the stream's
    chars width); ``dmax`` caps merged delete spans. Returns
    ``(fused_ops, FuseStats)``."""
    kinds = np.asarray(ops.kind)
    if kinds.ndim != 1:
        raise ValueError("fuse_steps takes one unbatched [S] stream")
    if fuse_w < 1:
        raise ValueError(f"fuse_w must be >= 1, got {fuse_w}")
    lmax = ops.lmax if lmax is None else min(lmax, ops.lmax)
    stats = FuseStats(steps_in=int(kinds.shape[0]))
    if kinds.shape[0] == 0:
        return ops, stats

    names = ("kind", "pos", "del_len", "del_target", "origin_left",
             "origin_right", "ins_len", "st", "order_advance", "rank")
    cols = {f: np.asarray(getattr(ops, "ins_order_start" if f == "st"
                                  else f)).tolist() for f in names}
    w_col = np.asarray(ops.rows_per_step).tolist()
    chars = np.asarray(ops.chars)

    def row(i) -> _FRow:
        il = cols["ins_len"][i]
        return _FRow(*(cols[f][i] for f in names),
                     max(w_col[i], 1), chars[i, :il].copy())

    out = _Rows(ops.lmax)

    def emit(r: _FRow) -> None:
        content = r.chars if r.ins_len else ""
        out.emit(kind=r.kind, pos=r.pos, del_len=r.del_len,
                 del_target=r.del_target, origin_left=r.origin_left,
                 origin_right=r.origin_right, ins_len=r.ins_len,
                 ins_order_start=r.st, order_advance=r.order_advance,
                 rank=r.rank, rows=r.w, content=content)

    step_map = [0] * stats.steps_in
    cur_inputs = [0]
    emitted_n = 0
    cur = row(0)
    for i in range(1, stats.steps_in):
        nxt = row(i)
        shape = _try_fuse(cur, nxt, lmax, fuse_w, dmax)
        if shape is None:
            for j in cur_inputs:
                step_map[j] = emitted_n
            emitted_n += 1
            emit(cur)
            cur = nxt
            cur_inputs = [i]
        else:
            stats.fused[shape] += 1
            cur_inputs.append(i)
    for j in cur_inputs:
        step_map[j] = emitted_n
    emit(cur)
    stats.step_map = step_map
    fused = out.to_tensors()
    stats.steps_out = fused.num_steps
    if (int(np.asarray(fused.order_advance, dtype=np.int64).sum())
            != int(np.asarray(ops.order_advance, dtype=np.int64).sum())):
        raise AssertionError("fusion changed the stream's order consumption")
    return fused, stats


def merge_fused_origins(ol_log, or_log, ops: OpTensors,
                        ol_np, or_np) -> None:
    """Merge a replay's per-step origins into numpy by-order logs in
    place, expanding fused W-row steps: a fused step's origins are patch
    0's — left is SHARED by every sub-run head (orders st + k*L), and
    rights chain statically (patch k's raw successor at insert time is
    patch k-1's head, order st + (k-1)*L)."""
    starts = np.asarray(ops.ins_order_start, dtype=np.int64)
    ilens = np.asarray(ops.ins_len, dtype=np.int64)
    ws = np.maximum(np.asarray(ops.rows_per_step, dtype=np.int64), 1)
    for st, il, w, left, right in zip(starts, ilens, ws, ol_np, or_np):
        if il > 0:
            L = il // w
            for k in range(w):
                ol_log[st + k * L] = left
                or_log[st + k * L: st + (k + 1) * L] = (
                    right if k == 0 else st + (k - 1) * L)


def compile_remote_txns(
    txns: Sequence[RemoteTxn],
    table: AgentTable,
    assigner: Optional[OrderAssigner] = None,
    lmax: int = 16,
    dmax: Optional[int] = None,
) -> Tuple[OpTensors, OrderAssigner]:
    """Causally-ordered RemoteTxn stream -> op tensors (`doc.rs:242-348`).

    The ``assigner`` carries the peer-local order metadata between calls
    (streaming apply); txns must arrive causally ready (buffering
    out-of-order arrivals is the caller's job). ``dmax`` chunks remote
    delete target runs into steps of at most ``dmax`` orders; ``None``
    keeps each order-contiguous run whole (the one-pass interval delete
    of ``ops.rle_mixed`` takes any length).
    """
    if dmax is not None and dmax < 1:
        raise ValueError(f"dmax must be >= 1, got {dmax}")
    if assigner is None:
        assigner = OrderAssigner(table)
    ranks = table.rank_of_agent()
    rows = _Rows(lmax)
    for txn in txns:
        agent = table.id_of(txn.id.agent)
        if assigner.next_seq(agent) != txn.id.seq:
            raise ValueError(
                f"remote txn out of order: expected seq "
                f"{assigner.next_seq(agent)}, got {txn.id.seq} "
                f"(buffer out-of-order txns before compiling)")
        length = txn_len(txn)
        if length <= 0:
            raise ValueError("empty remote txn")
        # Orders for the whole txn are allocated up front (`doc.rs:265-269`)
        # so intra-txn origin references resolve.
        cursor = assigner.assign(agent, txn.id.seq, length)
        for op in txn.ops:
            if isinstance(op, RemoteIns):
                ins = op.ins_content
                if not ins:
                    continue
                origin_left = assigner.resolve(op.origin_left)
                origin_right = assigner.resolve(op.origin_right)
                off = 0
                while off < len(ins):
                    chunk = ins[off:off + lmax]
                    rows.emit(
                        kind=KIND_REMOTE_INS,
                        origin_left=origin_left,
                        origin_right=origin_right,
                        ins_len=len(chunk), ins_order_start=cursor,
                        order_advance=len(chunk),
                        rank=int(ranks[agent]), content=chunk,
                    )
                    origin_left = cursor + len(chunk) - 1
                    cursor += len(chunk)
                    off += len(chunk)
            else:
                target_agent = table.id_of(op.id.agent)
                for first, run_len in assigner.target_runs(
                        target_agent, op.id.seq, op.len):
                    off = 0
                    while off < run_len:
                        take = (run_len - off if dmax is None
                                else min(run_len - off, dmax))
                        rows.emit(
                            kind=KIND_REMOTE_DEL, del_target=first + off,
                            del_len=take, order_advance=take,
                            rank=int(ranks[agent]),
                        )
                        off += take
                    cursor += run_len
    return rows.to_tensors(), assigner


# -- log prefill ----------------------------------------------------------------


def _prefill_scatter(ops: OpTensors):
    """The compile-time-known log writes of one unbatched op stream, as
    (positions, values) pairs. See ``prefill_logs``."""
    ins_len = np.asarray(ops.ins_len, dtype=np.int64)
    starts = np.asarray(ops.ins_order_start, dtype=np.int64)
    kinds = np.asarray(ops.kind)
    op_chars = np.asarray(ops.chars)
    ranks = np.asarray(ops.rank)
    ol_ops = np.asarray(ops.origin_left)
    or_ops = np.asarray(ops.origin_right)
    wsteps = np.maximum(np.asarray(ops.rows_per_step, dtype=np.int64), 1)

    sel = ins_len > 0
    if not sel.any():
        return None
    reps = ins_len[sel]
    total = int(reps.sum())
    step_idx = np.repeat(np.nonzero(sel)[0], reps)
    within = np.arange(total) - np.repeat(
        np.cumsum(reps) - reps, reps)
    pos = starts[sel].repeat(reps) + within

    # Within-run implicit origin chain (`span.rs:9-13,24-28`): item k's
    # origin_left is order+k-1. A FUSED step's chain breaks at every
    # sub-run head of stride L = il/W.
    stride = np.repeat(ins_len[sel] // wsteps[sel], reps)
    chain = (within % stride) != 0
    remote = kinds[step_idx] == KIND_REMOTE_INS
    head = ~chain & remote
    return {
        "chars": (pos, op_chars[step_idx, within]),
        "rank": (pos, ranks[step_idx]),
        "ol": (np.concatenate([pos[chain], pos[head]]),
               np.concatenate([(pos[chain] - 1).astype(np.uint32),
                               ol_ops[step_idx[head]]])),
        "or": (pos[remote], or_ops[step_idx[remote]]),
    }


def _apply_scatter(ol, orr, rank, chars, sc) -> None:
    """Apply a scatter to ``[OCAP]`` numpy u32 logs."""
    if sc is None:
        return
    chars[..., sc["chars"][0]] = sc["chars"][1]
    rank[..., sc["rank"][0]] = sc["rank"][1]
    ol[..., sc["ol"][0]] = sc["ol"][1]
    orr[..., sc["or"][0]] = sc["or"][1]


def prefill_logs(doc, ops: OpTensors):
    """Fill a ``FlatDoc``'s by-order logs with everything the compiler
    already knows about ``ops``: chars, author ranks, remote origins and
    every insert run's implicit origin chain. The replay then writes only
    the two origins a local insert discovers (`doc.rs:447-453`).

    ``ops`` may be unbatched ``[S, ...]`` (doc unbatched, or one stream
    shared by every doc of a batched doc) or batched ``[S, B, ...]`` (doc
    batched ``[B, ...]``). Tiled batches (every doc's column identical,
    the ``tile_ops`` output) are prefilled with one scatter broadcast
    across the doc axis. Returns a new doc on the doc's device; the
    scatter runs in host numpy."""
    ops_batched = np.asarray(ops.kind).ndim == 2
    if doc.ol_log.ndim == 1 and ops_batched:
        raise ValueError("batched ops need a batched doc")

    def host(t):
        return t.cpu().numpy().view(np.uint32).copy()

    def dev_t(a):
        return torch.from_numpy(a.view(np.int32)).to(doc.ol_log.device)

    ol, orr, rank, chars = (host(doc.ol_log), host(doc.or_log),
                            host(doc.rank_log), host(doc.chars_log))
    if not ops_batched:
        _apply_scatter(ol, orr, rank, chars, _prefill_scatter(ops))
    else:
        def tiled(a):
            a = np.asarray(a)
            return bool((a == a[:, :1] if a.ndim == 2
                         else a == a[:, :1, ...]).all())

        if all(tiled(c) for c in
               (ops.kind, ops.ins_len, ops.ins_order_start, ops.rank,
                ops.origin_left, ops.origin_right, ops.chars)):
            one = _map_fields(lambda a: np.asarray(a)[:, 0], ops)
            _apply_scatter(ol, orr, rank, chars, _prefill_scatter(one))
        else:
            for b in range(ol.shape[0]):
                per_doc = _map_fields(lambda a: np.asarray(a)[:, b], ops)
                _apply_scatter(ol[b], orr[b], rank[b], chars[b],
                               _prefill_scatter(per_doc))
    return dataclasses.replace(
        doc, ol_log=dev_t(ol), or_log=dev_t(orr),
        rank_log=dev_t(rank), chars_log=dev_t(chars))


# -- device-resident prefill ----------------------------------------------------
# ``prefill_delta`` ships only the scatter — fixed-shape padded (positions,
# values) arrays — and ``ops.flat.apply_prefill_delta`` applies it to the
# device-resident logs, so a serve tick moves O(ops) bytes instead of the
# four full [B, OCAP] logs. Scatter lengths are padded to a small
# geometric bucket set (``scatter_bucket``).

#: Padding position for scatter arrays: positive, out of range for any
#: real order capacity (< 2^31), so the device scatter drops it. The
#: value columns pad with 0 (never read — the position is dropped).
PREFILL_PAD = np.uint32(0x7FFFFFFF)

#: Smallest scatter bucket; buckets grow geometrically (x4) from here.
PREFILL_BUCKET_BASE = 32


def scatter_bucket(n: int) -> int:
    """Smallest bucket (PREFILL_BUCKET_BASE * 4^k) holding ``n`` scatter
    entries (a serve tick's scatter is capped at S_bucket * lmax
    entries anyway)."""
    b = PREFILL_BUCKET_BASE
    while b < n:
        b *= 4
    return b


_DELTA_FIELDS = ("ins_pos", "chars_val", "rank_val", "ol_pos", "ol_val",
                 "or_pos", "or_val")


@dataclasses.dataclass
class PrefillDelta:
    """The compile-time-known by-order log writes of an op stream as
    fixed-shape padded scatter arrays (``[L]`` for one stream, ``[B, L]``
    for a stacked batch; ``L = bucket``), u32 numpy.

    ``chars_log`` and ``rank_log`` share one position column (every
    inserted char gets both); ``ol``/``or`` carry their own (the chain
    subset / the remote subset). Padding rows hold ``PREFILL_PAD``
    positions, which the device scatter drops."""

    ins_pos: np.ndarray    # u32[..., L] chars/rank write positions
    chars_val: np.ndarray  # u32[..., L]
    rank_val: np.ndarray   # u32[..., L]
    ol_pos: np.ndarray     # u32[..., L] origin_left writes (chain + heads)
    ol_val: np.ndarray     # u32[..., L]
    or_pos: np.ndarray     # u32[..., L] origin_right writes (remote runs)
    or_val: np.ndarray     # u32[..., L]
    bucket: int

    def nbytes(self) -> int:
        """Bytes this delta moves host->device (the whole cost of a
        device-resident prefill; compare 2 * 4 * OCAP * B * 4 for the
        full-log round trip)."""
        return sum(np.asarray(getattr(self, f)).nbytes
                   for f in _DELTA_FIELDS)


def _delta_rows(sc, L: int):
    """One lane's scatter dict -> seven padded length-L u32 rows."""
    ins_pos = np.full(L, PREFILL_PAD, np.uint32)
    chars_val = np.zeros(L, np.uint32)
    rank_val = np.zeros(L, np.uint32)
    ol_pos = np.full(L, PREFILL_PAD, np.uint32)
    ol_val = np.zeros(L, np.uint32)
    or_pos = np.full(L, PREFILL_PAD, np.uint32)
    or_val = np.zeros(L, np.uint32)
    if sc is not None:
        p, v = sc["chars"]
        ins_pos[:len(p)] = p
        chars_val[:len(p)] = v
        rank_val[:len(p)] = sc["rank"][1]
        p, v = sc["ol"]
        ol_pos[:len(p)] = p
        ol_val[:len(p)] = v
        p, v = sc["or"]
        or_pos[:len(p)] = p
        or_val[:len(p)] = v
    return ins_pos, chars_val, rank_val, ol_pos, ol_val, or_pos, or_val


def prefill_delta(ops: OpTensors) -> Optional[PrefillDelta]:
    """``_prefill_scatter`` as fixed-shape padded arrays: the
    delta-prefill twin of ``prefill_logs``. ``ops`` may be unbatched
    ``[S, ...]`` or batched ``[S, B, ...]`` (one scatter row per lane).
    Returns ``None`` when the stream inserts nothing (callers then skip
    the device scatter). Applying the delta
    (``ops.flat.apply_prefill_delta``) is bit-identical to
    ``prefill_logs``: both are projections of the same
    ``_prefill_scatter``."""
    batched = np.asarray(ops.kind).ndim == 2
    if not batched:
        scs = [_prefill_scatter(ops)]
    else:
        host = _map_fields(np.asarray, ops)
        scs = [_prefill_scatter(_map_fields(lambda a: a[:, b], host))
               for b in range(np.asarray(ops.kind).shape[1])]
    if all(sc is None for sc in scs):
        return None
    need = max(len(sc["chars"][0]) for sc in scs if sc is not None)
    L = scatter_bucket(need)
    cols = [np.stack(rows) if batched else rows[0]
            for rows in zip(*(_delta_rows(sc, L) for sc in scs))]
    return PrefillDelta(*cols, bucket=L)


def concat_deltas(deltas) -> Optional[PrefillDelta]:
    """Concatenate T per-tick ``PrefillDelta``s (same batch shape) into
    one padded delta for a tick train. Per-tick scatter positions land
    in disjoint fresh order ranges (orders are allocated uniquely and
    monotonically per lane), so applying the concatenation once before
    the train is bit-identical to applying each delta before its tick.
    ``None`` entries contribute nothing; returns ``None`` when every
    tick was insert-free. The result is re-padded to the
    ``scatter_bucket`` series."""
    live = [d for d in deltas if d is not None]
    if not live:
        return None
    if len(live) == 1:
        return live[0]
    total = sum(d.bucket for d in live)
    L = scatter_bucket(total)
    pads = {"ins_pos": PREFILL_PAD, "ol_pos": PREFILL_PAD,
            "or_pos": PREFILL_PAD}
    cols = []
    for f in _DELTA_FIELDS:
        col = np.concatenate(
            [np.asarray(getattr(d, f)) for d in live], axis=-1)
        if col.shape[-1] < L:
            width = [(0, 0)] * (col.ndim - 1) + [(0, L - col.shape[-1])]
            col = np.pad(col, width,
                         constant_values=pads.get(f, np.uint32(0)))
        cols.append(col)
    return PrefillDelta(*cols, bucket=L)


# -- row bounds and batching --------------------------------------------------


def row_growth_bound(num_steps: int) -> int:
    """Sound per-lane run-row bound after ``num_steps`` compiled device
    steps: every step splices at most 2 new rows (insert splice, delete
    boundary splits, remote-delete endpoint retires), so a stream of S
    steps never needs more than ``1 + 2*S`` rows. The growing per-chunk
    capacities of the streaming configs derive from it."""
    return 1 + 2 * num_steps


def row_growth_bound_ops(ops: OpTensors) -> int:
    """Fused-aware sound row bound of ONE compiled stream: a plain step
    splices at most 2 new rows (``row_growth_bound``), a fused W-row step
    at most W + 1 (W new runs and one split tail). Equals
    ``row_growth_bound(num_steps)`` on an unfused stream."""
    w = np.maximum(
        np.asarray(ops.rows_per_step, dtype=np.int64).reshape(-1), 1)
    return 1 + int(np.maximum(2, w + 1).sum())


def _map_fields(fn, *streams: OpTensors) -> OpTensors:
    """``OpTensors`` whose every field is ``fn`` of the streams' fields."""
    return OpTensors(**{
        f.name: fn(*(getattr(s, f.name) for s in streams))
        for f in dataclasses.fields(OpTensors)})


def pad_ops(ops: OpTensors, num_steps: int) -> OpTensors:
    """Pad a step stream with no-ops (KIND_LOCAL with all-zero lengths is
    an exact no-op in every engine)."""
    s = ops.num_steps
    assert s <= num_steps
    if s == num_steps:
        return ops

    def pad(a):
        a = np.asarray(a)
        return np.pad(a, [(0, num_steps - s)] + [(0, 0)] * (a.ndim - 1))

    return _map_fields(pad, ops)


def empty_ops(lmax: int) -> OpTensors:
    """A zero-step stream (idle lanes in a serve batch tick)."""
    return _Rows(lmax).to_tensors()


def concat_ops(streams: Sequence[OpTensors]) -> OpTensors:
    """Concatenate step streams along the step axis (equal lmax).

    The serve batcher compiles one stream per drained event and fuses
    them into the doc's tick stream; orders were threaded through one
    assigner, so plain concatenation preserves the compiled invariants.
    """
    streams = [s for s in streams if s.num_steps > 0]
    if not streams:
        return empty_ops(1)
    lmax = streams[0].lmax
    if any(s.lmax != lmax for s in streams):
        raise ValueError("mixed lmax streams")
    if len(streams) == 1:
        return streams[0]
    return _map_fields(
        lambda *xs: np.concatenate([np.asarray(x) for x in xs], axis=0),
        *streams)


def stack_ops(streams: Sequence[OpTensors]) -> OpTensors:
    """Ragged per-doc streams -> one time-major ``[S, B, ...]`` batch
    (shorter docs run no-op tail steps)."""
    s_max = max(o.num_steps for o in streams)
    padded = [pad_ops(o, s_max) for o in streams]
    return _map_fields(lambda *xs: np.stack(xs, axis=1), *padded)


def stack_ticks(ticks: Sequence[OpTensors]) -> OpTensors:
    """T equal-shape stacked tick streams ([S, B, ...] each) -> one
    train-major [T, S, B, ...] batch for ``ops.flat.apply_train``. The
    caller re-pads every tick to a common step bucket first
    (``pad_ops``) and pads short trains with all-zero no-op ticks."""
    return _map_fields(
        lambda *xs: np.stack([np.asarray(x) for x in xs], axis=0), *ticks)


def tile_ops(ops: OpTensors, batch: int) -> OpTensors:
    """One stream -> B identical docs (``[S, B, ...]``)."""
    return _map_fields(
        lambda a: np.broadcast_to(
            np.asarray(a)[:, None, ...],
            (np.asarray(a).shape[0], batch) + np.asarray(a).shape[1:]),
        ops)
