"""Serve lane backend over the BLOCKED streaming-lanes mixed engine
(counterpart of ``text_crdt_rust_tpu/serve/lanes_backend.py``): the whole
``serve/`` stack on A7 (``ops/csrc/rle_lanes_mixed_blocked.cu`` through
``ops/rle_lanes_mixed.make_replayer_lanes_mixed_blocked``), O(NB+K)
touched rows per step.

Three things make this a backend rather than a replay driver:

1. **Persistent per-tick state.** The replayer's 11-tuple ``state()``
   (block planes, logical tables, by-order origin tables, the
   order->block hint + split forward pointers) is carried ACROSS ticks as
   the lanes' device state, with each tick's stacked ``[S, B]`` stream
   applied as one warm-started launch. Tick step counts are padded to the
   batcher's static buckets (``chunk=S``), so a steady state launches one
   shape per bucket and its state tensors keep their shapes (the growth
   pads are no-ops). Author ranks are a read-only kernel input, so the
   backend accumulates the full by-order rank table host-side across
   ticks (the chunk-chaining ``rkl`` contract) — which is also what
   agent-onboarding rank remaps rewrite.

2. **Per-lane residency writes.** ``upload_lane`` synthesizes one lane's
   columns from a restored oracle — runs via ``lane_blocks.oracle_runs``,
   half-full K-row blocks via ``lane_blocks.pack_lane_blocks``, by-order
   origin/rank tables and the order->block hint from the oracle's columns
   — and writes them into column ``b`` of the carried state in place,
   every other lane untouched; ``clear_lane`` writes the empty column.
   The writes are queued on the card's stream behind the launches that
   produced the state, so they need no sync.

3. **Run-row capacity semantics.** The blocked planes hold RUN rows, and
   leaf splits need free blocks, so the backend tracks per-lane run-row
   occupancy host-side (upper-bounded by +2 rows per ACTIVE op branch)
   and bounds it by ``row_budget``, below which the kernel's
   out-of-blocks flag is unreachable: overflow degrades host-side
   (``tick_fits``/``fits_doc`` refuse, residency frees the lane) before
   the device could ever flag.

   The bound is a HOST MIRROR on a fixed logical schedule: ``apply(t)``
   re-bases ``_lane_rows`` from tick t-1's exact device counts (whose
   staged sync has completed at every pipeline depth; the batcher syncs
   a shard's in-flight tick before dispatching to it) plus tick t's
   conservative growth — so every capacity probe reads a pure function
   of the tick index, identical at pipeline depths 1 and 2. Lanes
   touched by residency writes since the previous apply keep their exact
   seeded counts. ``max_pipeline_ticks`` is 2. The device state and its
   mirrors (``_lane_rows``, ``_rkl``, ``_resident_fresh``) change
   together in every method that writes either.

On a CUDA device every tick launches A7 (or raises); on the CPU it runs
the kernel's plain version (``lanes_mixed_blocked_replay_plain``).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..config import lane_block_geometry
from ..ops import batch as B
from ..ops import rle_lanes_mixed as RLM
from ..ops.lane_blocks import oracle_runs, pack_lane_blocks
from ..ops.rle_lanes import upload


class LanesMixedLaneBackend:
    """The blocked per-lane MIXED engine as a serve lane backend: one
    persistent blocked state 11-tuple per shard, applied with one
    warm-started launch per ``[S, B]`` tick.

    Surface the batcher and residency layers consume: ``apply`` /
    ``clear_lane`` / ``upload_lane`` / ``remap_lane_ranks`` /
    ``lane_signed`` / ``fits`` / ``fits_doc`` / ``tick_fits`` /
    ``barrier`` / ``sync_token``.  ``capacity`` counts RUN rows per lane
    (rounded up to a ``block_k`` multiple); ``order_capacity`` rows of
    by-order table per lane (rounded up to a multiple of 8)."""

    engine = "rle-lanes-mixed"
    # The run-row bound is host-mirrored on a fixed logical schedule, so
    # a tick's launch may stay in flight through the next host tick.
    max_pipeline_ticks = 2
    # No tick trains: the rank table is host-merged per tick and the
    # run-row bound trued up at the dispatch edge.
    max_train_ticks = 1
    train_ticks = 1

    def __init__(self, lanes: int, capacity: int, order_capacity: int,
                 lmax: int, block_k: int = 64, fuse_w: int = 1,
                 device=None, device_prefill: bool = True):
        # device_prefill is the flat backend's surface: this backend's
        # tables are device-resident already and ignore it.
        self.device = resolve_device(device)
        self.lanes = lanes
        self.lmax = lmax
        self.block_k = max(8, min(block_k, capacity))
        self.capacity, self.NB, self.NBT = lane_block_geometry(
            capacity, self.block_k)
        # Widest fused burst step this backend admits: the one-split
        # headroom rule WMAX <= K//2 - 1 (``batch.fused_width_checked``).
        self.max_fuse_w = max(1, min(fuse_w, self.block_k // 2 - 1))
        self.order_capacity = ((order_capacity + 7) // 8) * 8
        self._state = RLM._empty_mixed_blocked_state(
            self.capacity, self.NBT, self.order_capacity, lanes, self.device)
        # One cached empty column per plane for clear_lane (an eviction
        # hot spot: hundreds of clears a loadgen run).
        self._empty_cols = tuple(
            e[:, 0] for e in RLM._empty_mixed_blocked_state(
                self.capacity, self.NBT, self.order_capacity, 1,
                self.device))
        # Host-accumulated full by-order rank table (the kernel's rkl is
        # a read-only input).
        self._rkl = np.zeros((self.order_capacity, lanes), np.int32)
        # Host-mirrored per-lane run-row bound (see the module header).
        self._lane_rows = np.zeros(lanes, np.int64)
        self._prev_res = None      # last apply's result
        self._prev_rows = None     # its per-lane row counts [1, B]
        self._prev_token = None    # what blocks through its launch
        self._prev_checked = False  # its kernel flags already verified
        # Lanes written by clear/upload since the last apply: their
        # _lane_rows value is fresher than the device counts.
        self._resident_fresh = np.zeros(lanes, bool)
        self.shapes_seen: set = set()   # launched (S,) tick shapes
        self.lane_writes = 0    # upload/clear/remap calls (column writes)

    # -- capacity probes ----------------------------------------------------

    @property
    def row_budget(self) -> int:
        """Max run rows a lane may hold such that the kernel can never
        run out of blocks: out-of-blocks requires every block allocated,
        and all but one block (seeded or split-born) holds at least
        ``(K - WMAX) // 2`` rows — a fused W-row splice fires its leaf
        split at ``r0 + W + 1 > K``. Staying below
        ``(NB-1) * (K-WMAX)//2`` rows (minus 2 rows of slack; the probes
        bound each stream's FULL growth before it applies) keeps the
        device capacity flag unreachable."""
        min_fill = (self.block_k - self.max_fuse_w) // 2
        return max(0, (self.NB - 1) * min_fill - 2)

    def _orders_fit(self, next_order: int) -> bool:
        return next_order <= self.order_capacity - self.lmax

    def fits(self, n: int, next_order: int) -> bool:
        """Shape-only probe: ``n`` body rows taken as the (worst-case)
        run count. Callers holding the oracle get the exact answer from
        ``fits_doc``."""
        return n + 2 <= self.row_budget and self._orders_fit(next_order)

    def fits_doc(self, oracle) -> bool:
        """Exact upload-path probe: the oracle's true run count (what
        ``upload_lane`` will seed) against the row budget."""
        runs = len(oracle_runs(oracle)[0])
        return (runs + 2 <= self.row_budget
                and self._orders_fit(oracle.get_next_order()))

    @staticmethod
    def _stream_growth(del_len, ins_len, rows_per_step=None) -> np.ndarray:
        """Sound run-row growth bound of a stream, per trailing lane axis:
        each ACTIVE branch of a step splices at most +2 rows (a 3-way
        delete split, or an insert split), and a compiled local REPLACE
        step fires both branches — so 2 rows per active branch, not per
        step. A FUSED insert branch (``rows_per_step`` W > 1) splices up
        to W + 1 rows (W new runs + one split tail)."""
        d = np.asarray(del_len) > 0
        i = np.asarray(ins_len) > 0
        w = (np.maximum(np.asarray(rows_per_step, dtype=np.int64), 1)
             if rows_per_step is not None else np.int64(1))
        ins_growth = np.maximum(w + 1, 2) * i.astype(np.int64)
        return (2 * d.astype(np.int64) + ins_growth).sum(axis=0)

    def tick_fits(self, b: int, oracle, stream) -> bool:
        """Pre-apply probe for lane ``b``'s compiled tick stream: the
        lane's tracked run rows plus the stream's sound growth bound must
        stay inside the budget."""
        growth = int(self._stream_growth(stream.del_len, stream.ins_len,
                                         stream.rows_per_step))
        return (int(self._lane_rows[b]) + growth <= self.row_budget
                and self._orders_fit(oracle.get_next_order()))

    # -- residency writes ---------------------------------------------------

    def _write_lane(self, b: int, cols) -> None:
        """Column ``b`` of every state plane from host columns, in one
        upload."""
        flat = upload(np.concatenate(
            [np.asarray(c, np.int32).ravel() for c in cols]), self.device)
        at = 0
        for s in self._state:
            n = s.shape[0]
            s[:, b].copy_(flat[at:at + n])
            at += n

    def clear_lane(self, b: int) -> None:
        for s, e in zip(self._state, self._empty_cols):
            s[:, b].copy_(e)
        self._rkl[:, b] = 0
        self._lane_rows[b] = 0
        self._resident_fresh[b] = True
        self.lane_writes += 1

    def upload_lane(self, b: int, oracle, rank_of_agent) -> None:
        """Seed lane ``b`` wholesale from a (restored) oracle: packed
        half-full blocks, by-order origin tables, author ranks, and a
        fully-warm order->block hint — other lanes' carried state is
        untouched."""
        starts, lens = oracle_runs(oracle)
        packed, run_block = pack_lane_blocks(
            starts, lens, K=self.block_k, NB=self.NB, NBT=self.NBT,
            capacity=self.capacity)
        cols = list(packed)
        ocap = self.order_capacity
        n = oracle.n
        order = oracle.order[:n].astype(np.int64)
        if oracle.get_next_order() > ocap:
            raise ValueError(
                f"doc ({oracle.get_next_order()} orders) exceeds order "
                f"capacity {ocap}")

        def table_from(items):
            # u32 view -> i32 turns ROOT (0xFFFFFFFF) into the kernels'
            # -1 root sentinel; absent orders stay TAB_UNKNOWN.
            out = np.full(ocap, RLM.TAB_UNKNOWN, np.int32)
            out[order] = items[:n].astype(np.uint32).view(np.int32)
            return out

        oll = table_from(oracle.origin_left)
        orl = table_from(oracle.origin_right)
        # order -> physical block hint: run r's whole span points at the
        # block pack_lane_blocks placed it in.
        ordblk = np.full(ocap, -1, np.int32)
        if len(starts):
            ordblk[np.repeat(np.abs(starts) - 1, lens)
                   + _within(lens)] = np.repeat(run_block, lens)
        fwd = np.full(self.NBT, -1, np.int32)
        cols.extend([oll, orl, ordblk, fwd])
        self._write_lane(b, cols)

        # Per-item author rank by order (a searchsorted over the
        # client_with_order runs).
        rkl = np.zeros(ocap, np.int32)
        if n:
            run_starts = np.asarray(
                [e.order for e in oracle.client_with_order], np.int64)
            run_agents = np.asarray(
                [e.agent for e in oracle.client_with_order], np.int64)
            run_idx = np.searchsorted(run_starts, order,
                                      side="right") - 1
            rkl[order] = np.asarray(rank_of_agent)[
                run_agents[run_idx]].astype(np.int32)
        self._rkl[:, b] = rkl
        self._lane_rows[b] = len(starts)
        self._resident_fresh[b] = True
        self.lane_writes += 1

    def remap_lane_ranks(self, b: int, mapping: np.ndarray) -> None:
        """Agent-onboarding epoch re-base: rewrite lane ``b``'s column of
        the accumulated rank table through the old->new rank map (entries
        at or past ``len(mapping)`` — never written by the old epoch —
        pass through)."""
        m = np.asarray(mapping, dtype=np.int64)
        col = self._rkl[:, b].astype(np.int64)
        safe = np.minimum(col, len(m) - 1)
        self._rkl[:, b] = np.where(col < len(m), m[safe],
                                   col).astype(np.int32)
        self.lane_writes += 1

    # -- the tick -----------------------------------------------------------

    def apply(self, stacked: B.OpTensors) -> None:
        """One [S, B] tick as a warm-started launch (``chunk=S``: the
        batcher pads S to a static bucket).

        Run-row true-up rides the FIXED logical schedule of the module
        header: re-base from the PREVIOUS tick's exact device counts
        (already synced — the batcher blocks this shard's in-flight work
        at the dispatch edge), then add this tick's conservative growth.
        The previous tick's kernel flags are verified here, one tick
        late, still before any state built on them is read back."""
        growth = self._stream_growth(stacked.del_len, stacked.ins_len,
                                     stacked.rows_per_step)
        if self._prev_rows is not None:
            exact = self._prev_rows.cpu().numpy()[0].astype(np.int64)
            if self._prev_res is not None and not self._prev_checked:
                self._prev_res.check()
            base = np.where(self._resident_fresh, self._lane_rows, exact)
        else:
            base = self._lane_rows
        self._lane_rows = base + growth
        self._resident_fresh[:] = False
        S = int(stacked.num_steps)
        self._merge_rank_prefill(stacked)
        run = RLM.make_replayer_lanes_mixed_blocked(
            stacked, self.capacity, block_k=self.block_k,
            order_capacity=self.order_capacity, chunk=S,
            init=self._state, rkl=self._rkl, device=self.device)
        res = run()
        self.shapes_seen.add(S)
        self._state = res.state()
        self._prev_res = res
        # The row counts are taken now: residency writes later edit the
        # state planes in place.
        self._prev_rows = res.rows
        self._prev_token = self._prev_rows
        if self.device.type == "cuda":
            self._prev_token = torch.cuda.Event()
            self._prev_token.record()
        self._prev_checked = False

    def _merge_rank_prefill(self, stacked: B.OpTensors) -> None:
        """Fold this tick's compile-known author ranks into the
        host-accumulated full table (earlier ticks' ranks must stay
        visible to later YATA tiebreaks). Lanes without inserts scatter
        nothing."""
        ins = np.asarray(stacked.ins_len)
        for b in np.nonzero((ins > 0).any(axis=0))[0]:
            per = B._map_fields(lambda a: np.asarray(a)[:, b], stacked)
            sc = B._prefill_scatter(per)
            if sc is not None:
                self._rkl[sc["rank"][0], b] = sc["rank"][1].astype(
                    np.int32)

    def barrier(self) -> None:
        """Materialize the newest tick's outputs and surface any kernel
        flag loudly (the host-side probes make every flag unreachable, so
        a raise here is a backend bug, not load). No row true-up: the
        run-row bound follows the fixed logical schedule in ``apply``."""
        if self._prev_res is not None and not self._prev_checked:
            self._prev_res.check()
            self._prev_checked = True

    def sync_token(self):
        """What blocks through this backend's newest launch without
        serializing later ones: a CUDA event recorded right after it (on
        the CPU, its already-computed row counts). None before the first
        apply (the batcher then falls back to ``barrier``)."""
        return self._prev_token if self._prev_res is not None else None

    # -- readback -----------------------------------------------------------

    def lane_signed(self, b: int) -> np.ndarray:
        """±(order+1) body column of lane ``b`` in document order (walk
        the logical block table; the bit-identity comparison target).
        Readback implies a device sync, so the newest tick's kernel flags
        are verified here too (at depth 2 no barrier ever runs)."""
        self.barrier()
        ordp, lenp, nlogt, blkord, rws = (
            self._state[i][:, b].cpu().numpy() for i in range(5))
        nlog = int(nlogt[0])
        K = self.block_k
        o_parts: List[np.ndarray] = []
        l_parts: List[np.ndarray] = []
        for sl in range(nlog):
            blk, r = int(blkord[sl]), int(rws[sl])
            o_parts.append(ordp[blk * K: blk * K + r])
            l_parts.append(lenp[blk * K: blk * K + r])
        o = (np.concatenate(o_parts) if o_parts
             else np.zeros(0, np.int32)).astype(np.int64)
        ln = (np.concatenate(l_parts) if l_parts
              else np.zeros(0, np.int32)).astype(np.int64)
        if len(o) == 0:
            return np.zeros(0, np.int32)
        base = np.repeat(np.abs(o), ln)
        return (np.repeat(np.sign(o), ln)
                * (base + _within(ln))).astype(np.int32)


def _within(lens: np.ndarray) -> np.ndarray:
    """0..len-1 counters concatenated across runs."""
    total = int(lens.sum())
    return np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
