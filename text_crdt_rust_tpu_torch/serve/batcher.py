"""The continuous batcher: per-doc causal queues -> one device step/tick
(counterpart of ``text_crdt_rust_tpu/serve/batcher.py``), and the flat
engine's lane backend ``FlatLaneBackend`` (``ServeConfig()``'s default).

Each tick the batcher drains causally-ready events across every
lane-resident document of a shard, applies them to the per-doc host
oracles (the source of truth), compiles them into the fixed-shape
columnar op tensors ``ops/batch.py`` defines, stacks them time-major
``[S, B]`` across the shard's B lanes, and applies the whole shard in
ONE launch of the registry-selected lane engine — the
continuous-batching shape of LLM inference serving (ragged requests
coalesced into fixed-shape device steps), with YATA's delivery-order
freedom (Nicolaescu et al.) guaranteeing that any causally valid drain
order converges bit-identically.

Fixed shapes keep steady-state serving on a fixed set of launch shapes:
tick step counts are padded up to a small static set of **step
buckets**, and the lane count B and per-lane capacities are static
(``LaneBackend.shapes_seen`` records the buckets launched).

Per-event cost is bounded before compilation (``estimate_steps`` walks
the same run boundaries the compiler will) so one oversized edit can
never blow the tick's bucket; admission's ``max_txn_len`` makes the
bound a protocol guarantee. Capacity overflow inside a lane *degrades
the doc to the host oracle* (lane freed, truth preserved) — never an
assert on the serving path.

Walls come only from the caller's clock (``clock``, a
``Callable[[], float]`` in seconds): with one, the batcher stamps tick
walls, dispatch walls, pipeline stall/overlap and admission->applied
latency into the trace's ``"w"`` fields and its summaries; without one
they are absent, and the logical stream is the same.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import LocalOp, RemoteDel, RemoteIns, RemoteTxn
from ..models.sync import agent_watermarks
from ..net.session import txn_refs_known
from ..obs.registry import observe
from ..ops import batch as B
from ..ops import flat as F
from ..ops import span_arrays as SA
from ..utils.metrics import Counters
from ..utils.testdata import TestPatch
from .router import EV_LOCAL, DocState, Event, ShardRouter


class PipelineAliasingError(RuntimeError):
    """A host write raced an in-flight device step: an op tensor
    referenced by a dispatched-but-unsynced tick changed between dispatch
    and its staged sync — the loud version of silent device-state
    corruption, naming the tick, shard and array so the post-mortem
    starts at the writer."""


def _op_fingerprints(stacked: "B.OpTensors") -> Dict[str, int]:
    """CRC32 per op-tensor column — the dispatch-time fingerprint the
    staged sync re-checks.  Columns are small host arrays ([S, B] u32
    plus the [S, B, LMAX] char block), so this is tens-of-µs cheap at
    serve shapes."""
    import dataclasses
    import zlib

    out: Dict[str, int] = {}
    for f in dataclasses.fields(stacked):
        arr = np.ascontiguousarray(np.asarray(getattr(stacked, f.name)))
        out[f.name] = zlib.crc32(arr.tobytes())
    return out


class FlatLaneBackend:
    """The flat engine (``ops/flat.py``) as a serve lane backend: one
    batched ``FlatDoc`` ``[B, CAP]`` per shard on the device, a ``[S, B]``
    tick applied by one launch of the flat kernel (the plain version on
    the CPU), a tick train of T ticks by one launch over ``[T, S, B]``.

    Surface the batcher and residency layers consume: ``apply`` /
    ``clear_lane`` / ``upload_lane`` / ``remap_lane_ranks`` /
    ``lane_signed`` / ``fits`` / ``fits_doc`` / ``tick_fits`` /
    ``barrier`` / ``sync_token`` / ``flush_train``.

    Device writes (launches, prefill scatters, residency column writes)
    are queued on the device's stream in program order and need no host
    sync; host uploads go through pinned memory without blocking. The
    capacity gate reads host mirrors of every lane's ``n``/``next_order``
    (``_n_host``/``_next_order_host``, exact: a tick advances them by its
    column sums, residency writes set them), so the dispatch edge reads
    no device state (``dispatch_reads_device`` False with device
    prefill) and a launch may stay in flight through the next host ticks.
    """

    engine = "flat"
    # The flat engine has no W-row splice (``require_unfused``).
    max_fuse_w = 1
    # Every host probe reads the host oracle or the host mirrors, and
    # ``barrier`` performs no true-up, so a tick's launch may stay in
    # flight through the next host ticks, synced at the staged sync.
    max_pipeline_ticks = 8

    def __init__(self, lanes: int, capacity: int, order_capacity: int,
                 lmax: int, block_k: Optional[int] = None, fuse_w: int = 1,
                 device=None, device_prefill: bool = True):
        # block_k / fuse_w are lane-backend-constructor surface (the
        # blocked backend consumes them); the flat engine has no blocks
        # and no W-row splice.
        from .. import resolve_device

        self.device = resolve_device(device)
        self.lanes = lanes
        self.capacity = capacity
        self.order_capacity = order_capacity
        self.lmax = lmax
        base = SA.make_flat_doc(capacity, order_capacity, device=self.device)
        self.docs = SA.stack_docs(base, lanes)
        self._empty = base
        self.shapes_seen: set = set()   # launched (S,) tick shapes
        # Device-resident prefill: ship only the per-tick scatter delta,
        # keep the [B, OCAP] logs on the device, and check capacity
        # against the host mirrors.
        self.device_prefill = device_prefill
        self.dispatch_reads_device = not device_prefill
        self.scatter_shapes_seen: set = set()  # scatter buckets applied
        self._n_host = np.zeros(lanes, np.int64)
        self._next_order_host = np.zeros(lanes, np.int64)
        # Prefill cost accounting: bytes the chosen path moved vs what
        # the full-log round trip would move, and the un-padded scatter
        # volume. All logical (seed-deterministic).
        self.prefill_stats = {"ticks": 0, "moved_bytes": 0,
                              "full_bytes_equiv": 0, "scatter_len": 0}
        # Tick trains: with train_ticks > 1 ``apply`` buffers ticks
        # host-side (op tensors + prefill deltas) and ``_dispatch_train``
        # applies T of them in one launch (``ops.flat.apply_train``
        # semantics), the concatenated scatter applied first. Only the
        # device-prefill path can defer: host prefill writes the logs per
        # tick from host numpy. The host mirrors advance at the TRAIN
        # boundary by the buffered column sums (``_pending_n``/
        # ``_pending_o``), in the method that launches.
        self.max_train_ticks = 8 if device_prefill else 1
        self.train_ticks = 1
        self._train_buf: list = []      # [(stacked, delta), ...]
        self._pending_n = np.zeros(lanes, np.int64)
        self._pending_o = np.zeros(lanes, np.int64)
        # Lanes with real (non-padding) steps buffered: a single-lane
        # residency write only forces a flush when THAT lane has
        # buffered work.
        self._pending_active = np.zeros(lanes, bool)
        self._train_flags: list = []    # [(flags, event or None), ...]
        self.train_shapes_seen: set = set()  # launched (T, S) train keys
        self.train_stats = {"trains": 0, "ticks_sum": 0,
                            "dispatches": 0, "serial_equiv": 0}
        self.lane_writes = 0    # upload/clear/remap calls (column writes)

    def set_train_ticks(self, t: int) -> None:
        """Clamp-and-set the effective train length (the batcher calls
        this at construction with ``ServeConfig.train_ticks``)."""
        self.train_ticks = max(1, min(int(t), self.max_train_ticks))

    def fits(self, n: int, next_order: int) -> bool:
        """Would a doc of ``n`` rows / ``next_order`` orders fit a lane
        (with the engine's lmax log-write headroom)?"""
        return (n <= self.capacity
                and next_order <= self.order_capacity - self.lmax)

    def fits_doc(self, oracle) -> bool:
        """Residency-path probe: the doc's char count IS its device
        occupancy, so this is ``fits``."""
        return self.fits(oracle.n, oracle.get_next_order())

    def tick_fits(self, b: int, oracle, stream) -> bool:
        """Pre-apply probe for lane ``b``'s compiled tick ``stream``: the
        oracle already applied it, so its counts are exactly the
        post-tick device occupancy."""
        return self.fits(oracle.n, oracle.get_next_order())

    # -- residency writes ---------------------------------------------------

    def _flush_train_for_lane(self, b: int) -> None:
        """Flush the open train iff lane ``b`` has buffered steps: a
        residency write to a lane with NO buffered work commutes with the
        rest of the train (its steps are all no-ops on that lane)."""
        if self._pending_active[b]:
            self.flush_train()

    def _remap_buffered_lane(self, b: int, m: np.ndarray) -> None:
        """Re-base lane ``b``'s buffered rank values through the old->new
        rank map (values outside the map — padding, sentinels — pass
        through). Copies the touched arrays: the originals may be
        CRC-fingerprinted by the pipeline sanitizer."""
        if not self._pending_active[b]:
            return
        import dataclasses
        mlen = m.shape[0]

        def rebase(col):
            safe = np.minimum(col, mlen - 1)
            return np.where(col < mlen, m[safe], col)

        for i, (stacked, delta) in enumerate(self._train_buf):
            r = np.asarray(stacked.rank).copy()
            r[:, b] = rebase(r[:, b])
            stacked = dataclasses.replace(stacked, rank=r)
            if delta is not None:
                rv = np.asarray(delta.rank_val).copy()
                rv[b] = rebase(rv[b])
                delta = dataclasses.replace(delta, rank_val=rv)
            self._train_buf[i] = (stacked, delta)

    def _cancel_buffered_lane(self, b: int) -> None:
        """Erase lane ``b``'s columns from every buffered tick: zero op
        rows (an exact no-op step) and padding delta positions (dropped
        by the scatter). Used by ``clear_lane``: eviction checkpoints
        from the ORACLE, so apply-then-wipe and never-apply are
        indistinguishable — nothing reads the lane in between."""
        if not self._pending_active[b]:
            return
        import dataclasses
        for i, (stacked, delta) in enumerate(self._train_buf):
            cols = {}
            for f in ("kind", "pos", "del_len", "del_target",
                      "origin_left", "origin_right", "ins_len",
                      "ins_order_start", "order_advance", "rank",
                      "rows_per_step", "chars"):
                a = np.asarray(getattr(stacked, f)).copy()
                a[:, b] = 0
                cols[f] = a
            stacked = dataclasses.replace(stacked, **cols)
            if delta is not None:
                dcols = {}
                for f in ("ins_pos", "ol_pos", "or_pos"):
                    a = np.asarray(getattr(delta, f)).copy()
                    a[b] = B.PREFILL_PAD
                    dcols[f] = a
                for f in ("chars_val", "rank_val", "ol_val", "or_val"):
                    a = np.asarray(getattr(delta, f)).copy()
                    a[b] = 0
                    dcols[f] = a
                delta = dataclasses.replace(delta, **dcols)
            self._train_buf[i] = (stacked, delta)
        self._pending_n[b] = 0
        self._pending_o[b] = 0
        self._pending_active[b] = False

    def _write_lane(self, b: int, one: SA.FlatDoc) -> None:
        """Column ``b`` of every device column from a single doc on the
        same device (queued behind earlier launches)."""
        d = self.docs
        for f in ("signed", "ol_log", "or_log", "rank_log", "chars_log"):
            getattr(d, f)[b].copy_(getattr(one, f))
        d.n[b] = int(one.n)
        d.next_order[b] = SA.u32_bits(int(one.next_order))

    def clear_lane(self, b: int) -> None:
        self._cancel_buffered_lane(b)
        self._write_lane(b, self._empty)
        self._n_host[b] = 0
        self._next_order_host[b] = 0
        self.lane_writes += 1

    def upload_lane(self, b: int, oracle, rank_of_agent) -> None:
        self._flush_train_for_lane(b)
        flat = SA.upload_oracle(oracle, self.capacity, rank_of_agent,
                                self.order_capacity, device=self.device)
        self._write_lane(b, flat)
        self._n_host[b] = oracle.n
        self._next_order_host[b] = oracle.get_next_order()
        self.lane_writes += 1

    def remap_lane_ranks(self, b: int, mapping: np.ndarray) -> None:
        """Agent-onboarding epoch re-base of lane ``b``'s rank log. Work
        buffered for THIS lane carries rank values of the PRE-remap table
        (the op tensors' ``rank`` and the deltas' ``rank_val``); it is
        re-based through the same old->new map instead of flushed (the
        map is strictly monotone on old ranks, so every tiebreak the
        buffered steps make is preserved)."""
        m = np.asarray(mapping, dtype=np.uint32)
        self._remap_buffered_lane(b, m)
        lane = self.docs.rank_log[b]
        lane.copy_(SA.remap_ranks(lane, m))
        self.lane_writes += 1

    # -- the tick -----------------------------------------------------------

    def _check_capacity_host(self, ops: B.OpTensors) -> None:
        """The ONE flat capacity contract (``flat.check_capacity_counts``)
        against the HOST-MIRRORED lane counts, pending train sums
        included — a train can never carry a tick the serial loop would
        have refused."""
        F.check_capacity_counts(self._n_host + self._pending_n,
                                self._next_order_host + self._pending_o,
                                self.capacity, self.order_capacity, ops)

    def apply(self, stacked: B.OpTensors) -> None:
        """One [S, B] tick: prefill the by-order logs — on the device from
        the scatter delta (``device_prefill``, the default) or host-side
        via ``batch.prefill_logs`` — then one launch over all lanes. The
        two paths are bit-identical in device state and logical counters;
        they differ in bytes moved and in whether the dispatch edge reads
        device state."""
        st = self.prefill_stats
        st["ticks"] += 1
        # What the full-log round trip would move for this tick: the
        # four [B, OCAP] u32 logs, host-materialized AND re-uploaded.
        st["full_bytes_equiv"] += 2 * 4 * self.lanes \
            * self.order_capacity * 4
        st["scatter_len"] += int(np.asarray(
            stacked.ins_len, dtype=np.int64).sum())
        self.shapes_seen.add(int(stacked.num_steps))
        if self.train_ticks > 1:
            # Tick-train path (device_prefill guaranteed): gate against
            # the pending-aware host mirrors NOW, buffer the tick, and
            # launch once train_ticks are queued.
            self._check_capacity_host(stacked)
            delta = B.prefill_delta(stacked)
            self._train_buf.append((stacked, delta))
            self._pending_n += np.asarray(
                stacked.ins_len, dtype=np.int64).sum(axis=0)
            self._pending_o += np.asarray(
                stacked.order_advance, dtype=np.int64).sum(axis=0)
            self._pending_active |= (np.asarray(
                stacked.rows_per_step, dtype=np.int64).sum(axis=0) > 0)
            self.train_stats["serial_equiv"] += 1 + (delta is not None)
            self._drain_train_flags()
            if len(self._train_buf) >= self.train_ticks:
                self._dispatch_train()
            return
        n_disp = 1
        if self.device_prefill:
            self._check_capacity_host(stacked)
            delta = B.prefill_delta(stacked)
            if delta is not None:
                self.scatter_shapes_seen.add(delta.bucket)
                st["moved_bytes"] += delta.nbytes()
                F.scatter_delta_(self.docs, delta)
                n_disp = 2
        else:
            F._check_capacity(self.docs, stacked)
            self.docs = B.prefill_logs(self.docs, stacked)
            st["moved_bytes"] += 2 * 4 * self.lanes \
                * self.order_capacity * 4
        F.flat_replay(self.docs, stacked, skip_idle=False)
        self._n_host += np.asarray(
            stacked.ins_len, dtype=np.int64).sum(axis=0)
        self._next_order_host += np.asarray(
            stacked.order_advance, dtype=np.int64).sum(axis=0)
        ts = self.train_stats
        ts["trains"] += 1
        ts["ticks_sum"] += 1
        ts["dispatches"] += n_disp
        ts["serial_equiv"] += n_disp

    @staticmethod
    def _train_bucket(t: int) -> int:
        """Smallest power of two >= ``t`` — the train-length pad series
        ({1, 2, 4, 8}) the JAX package compiles one program for each."""
        b = 1
        while b < t:
            b *= 2
        return b

    def _dispatch_train(self) -> None:
        """Apply the buffered ticks as ONE train: (1) the concatenated
        prefill scatter (per-tick scatters land in disjoint fresh order
        ranges, so hoisting them is bit-identical to interleaving), (2)
        one launch over the ``[T, S, B]`` stack, T padded to the
        power-of-two bucket with no-op ticks and every tick re-padded to
        the train's largest step count. Host mirrors true up by the
        buffered column sums here, in the method that launches."""
        buf, self._train_buf = self._train_buf, []
        if not buf:
            return
        st = self.prefill_stats
        ts = self.train_stats
        t_bkt = self._train_bucket(len(buf))
        s_max = max(s.num_steps for s, _ in buf)
        ticks = [B.pad_ops(s, s_max) for s, _ in buf]
        if len(ticks) < t_bkt:
            noop = B._map_fields(lambda a: np.zeros_like(np.asarray(a)),
                                 ticks[0])
            ticks = ticks + [noop] * (t_bkt - len(ticks))
        train = B.stack_ticks(ticks)
        delta = B.concat_deltas([d for _, d in buf])
        docs = self.docs
        n_disp = 1
        if delta is not None:
            self.scatter_shapes_seen.add(delta.bucket)
            st["moved_bytes"] += delta.nbytes()
            F.scatter_delta_(docs, delta)
            n_disp = 2
        flags = F.flat_replay(docs, train, skip_idle=True)
        # The scatter and the launch edit the carried columns in place;
        # rebinding them here keeps the train's device write and the
        # mirror true-up below in this one method (the train contract).
        self.docs = docs
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._train_flags.append((flags, event))
        self.train_shapes_seen.add((t_bkt, s_max))
        ts["trains"] += 1
        ts["ticks_sum"] += len(buf)
        ts["dispatches"] += n_disp
        self._n_host = self._n_host + self._pending_n
        self._next_order_host = self._next_order_host + self._pending_o
        self._pending_n = np.zeros(self.lanes, np.int64)
        self._pending_o = np.zeros(self.lanes, np.int64)
        self._pending_active = np.zeros(self.lanes, bool)

    def _drain_train_flags(self, block: bool = False) -> None:
        """Check finished trains' overflow flags. Non-blocking by default
        (a train whose event has not completed is kept — reading its flag
        would block the host); ``block=True`` waits for every one. A set
        flag means a tick exceeded the static capacities mid-train —
        unreachable through the serve path (the pending-aware host check
        refuses such ticks at enqueue), so it raises: the docs are
        corrupt, not merely full."""
        keep = []
        for flags, event in self._train_flags:
            if not block and event is not None and not event.query():
                keep.append((flags, event))
                continue
            if bool(flags.any()):
                raise RuntimeError(
                    "tick-train overflow flag set: a train exceeded the "
                    "lane capacity/order budget on the device; the host-"
                    "mirror capacity check should have refused it at "
                    "enqueue")
        self._train_flags = keep

    def flush_train(self) -> None:
        """Launch any partial train and settle its overflow flags — the
        pre-read / pre-residency-write sync point. NOT called from
        ``barrier``: at pipeline depth 1 the batcher barriers every tick,
        which would stop trains from ever forming."""
        if self._train_buf:
            self._dispatch_train()
        self._drain_train_flags(block=True)

    def train_summary(self) -> Dict[str, float]:
        """Per-train dispatch economy (logical, seed-deterministic): device
        dispatches issued vs the serial loop's, and the distinct (T, S)
        train shapes launched (the JAX package's train compiles)."""
        ts = self.train_stats
        return {
            "train_ticks": self.train_ticks,
            "device_dispatches": ts["dispatches"],
            "dispatch_serial_equiv": ts["serial_equiv"],
            "dispatch_cut_x": round(
                ts["serial_equiv"] / max(ts["dispatches"], 1), 2),
            "train_len": round(
                ts["ticks_sum"] / max(ts["trains"], 1), 2),
            "train_compiles": len(self.train_shapes_seen),
        }

    def prefill_summary(self) -> Dict[str, float]:
        """Per-tick prefill byte economy (logical, seed-deterministic):
        what moved host->device for log prefill vs the full-log
        baseline, the un-padded scatter volume, and the distinct scatter
        buckets (the JAX package's scatter compiles)."""
        st = self.prefill_stats
        ticks = max(st["ticks"], 1)
        return {
            "device_prefill": self.device_prefill,
            "prefill_bytes_per_tick": round(st["moved_bytes"] / ticks, 1),
            "prefill_bytes_full_per_tick": round(
                st["full_bytes_equiv"] / ticks, 1),
            "prefill_bytes_cut_x": round(
                st["full_bytes_equiv"] / max(st["moved_bytes"], 1), 2),
            "prefill_scatter_len": st["scatter_len"],
            "prefill_scatter_compiles": len(self.scatter_shapes_seen),
        }

    def barrier(self) -> None:
        """Block on launched work (and settle its overflow flags). Does
        NOT flush an open train (see ``flush_train``)."""
        self._drain_train_flags(block=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def sync_token(self):
        """The completion handle for everything enqueued so far: a CUDA
        event recorded now, after the newest launch and residency write
        (blocking on it does not serialize against later launches); on
        the CPU the already-computed counts."""
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            return event
        return self.docs.n

    def lane_doc(self, b: int) -> SA.FlatDoc:
        self.flush_train()
        return SA.lane(self.docs, b)

    def lane_signed(self, b: int) -> np.ndarray:
        """±(order+1) body column of lane ``b`` (occupied rows only)."""
        lane = self.lane_doc(b)
        return lane.signed[:int(lane.n)].cpu().numpy()

    def lane_to_string(self, b: int) -> str:
        return SA.to_string(self.lane_doc(b))


def make_lane_backend(engine: str, *, lanes: int, capacity: int,
                      order_capacity: int, lmax: int,
                      block_k: int = 32,
                      fuse_w: int = 1,
                      device=None,
                      device_prefill: bool = True):
    """Registry-driven lane-backend construction: ``engine`` must be
    registered for the ``serve`` config in ``config.ENGINE_REGISTRY``
    AND carry a ``serve_backend`` entry naming its backend class —
    unknown or serve-less engines raise a precise ``ValueError`` at
    construction time (config-time strictness — runtime failures degrade,
    construction failures explain). ``device`` as ``resolve_device``."""
    import importlib

    from ..config import ENGINE_REGISTRY, engines_for

    serve_engines = engines_for("serve")
    if engine not in ENGINE_REGISTRY:
        raise ValueError(
            f"unknown engine {engine!r} (registry: "
            f"{tuple(ENGINE_REGISTRY)})")
    target = ENGINE_REGISTRY[engine].get("serve_backend")
    if engine not in serve_engines or not target:
        raise ValueError(
            f"engine {engine!r} has no serve lane backend; registered "
            f"serve engines: {serve_engines}")
    mod_path, cls_name = target.split(":")
    cls = getattr(importlib.import_module(
        f"{__package__.rsplit('.', 1)[0]}.{mod_path}"), cls_name)
    return cls(lanes=lanes, capacity=capacity,
               order_capacity=order_capacity, lmax=lmax,
               block_k=block_k, fuse_w=fuse_w, device=device,
               device_prefill=device_prefill)


def oracle_signed(oracle) -> np.ndarray:
    """The oracle body as the device's ±(order+1) encoding — the
    bit-identity comparison target for a lane."""
    n = oracle.n
    order = oracle.order[:n].astype(np.int64)
    sign = np.where(oracle.deleted[:n], -1, 1)
    return (sign * (order + 1)).astype(np.int32)


def estimate_steps(doc: DocState, event: Event, lmax: int) -> int:
    """Compiled step count of ``event`` against the doc's CURRENT
    assigner state (events estimate in FIFO order, so every earlier
    event's orders are already assigned). Mirrors the compiler's
    chunking: insert runs split at ``lmax``; remote delete targets split
    at the target agent's order-run boundaries (``dmax=None``).

    A delete targeting this txn's OWN fresh inserts (seqs at or past the
    agent's watermark) costs one step: the compiler allocates the whole
    txn as one contiguous order span before walking its ops. An unknown
    target agent costs one step too — that txn fails the apply-time
    reference validation and is dropped without compiling."""
    if event.kind == EV_LOCAL:
        _agent, _pos, _del_len, ins = event.payload
        return max(1, -(-len(ins) // lmax))
    steps = 0
    txn: RemoteTxn = event.payload
    for op in txn.ops:
        if isinstance(op, RemoteIns):
            steps += -(-len(op.ins_content) // lmax)
        else:
            assert isinstance(op, RemoteDel)
            if op.id.agent not in doc.table:
                steps += 1  # rejected at apply (refs unknown)
                continue
            aid = doc.table.id_of(op.id.agent)
            known = doc.assigner.next_seq(aid)
            end = op.id.seq + op.len
            if op.id.seq >= known:
                steps += 1  # entirely in-txn fresh range: one span
                continue
            steps += len(doc.assigner.target_runs(
                aid, op.id.seq, min(end, known) - op.id.seq))
            if end > known:
                steps += 1  # tail lands in the txn's own fresh span
    return max(steps, 1)


def _wait(token) -> None:
    """Block on a backend's sync token: a CUDA event waits for the launch
    it was recorded after; anything else (CPU results) is already done."""
    if isinstance(token, torch.cuda.Event):
        token.synchronize()


class ContinuousBatcher:
    """Drains per-doc event queues into one bucketed device pass per
    shard per tick. Owns nothing long-lived; doc state lives in the
    router, lane ownership in residency.
    """

    def __init__(self, router: ShardRouter, residency, *,
                 step_buckets: Tuple[int, ...], lmax: int,
                 counters: Optional[Counters] = None,
                 fuse_steps: bool = False, fuse_w: int = 1,
                 tracer=None, recorder=None, flow=None,
                 pipeline_ticks: int = 1,
                 sanitize_pipeline: bool = False,
                 train_ticks: int = 1,
                 clock: Optional[Callable[[], float]] = None):
        assert tuple(sorted(step_buckets)) == tuple(step_buckets)
        # The caller's wall clock (seconds); None = no wall accounting.
        self.clock = clock
        self.router = router
        self.residency = residency
        self.step_buckets = tuple(step_buckets)
        self.lmax = lmax
        self.counters = counters if counters is not None else Counters()
        self.tracer = tracer
        self.recorder = recorder
        self.flow = flow  # obs/flow.FlowTracker (None = provenance off)
        # Generalized tick-stream fusion (``ops.batch.fuse_steps``):
        # each lane doc's drained tick stream is fused before
        # the capacity probe and stacking — typing runs / sweeps /
        # replaces / remote runs coalesce into plain rows every backend
        # accepts; backwards bursts additionally fuse into W-row steps
        # up to the backend's ``max_fuse_w`` (1 on backends without the
        # W-row splice).  Fewer steps per doc-tick -> more docs fit a
        # fixed [S, B] bucket, the batching win ``fuse_stats`` tracks.
        self.fuse_steps = fuse_steps
        self.fuse_w = max(1, fuse_w)
        self.fuse_stats = B.FuseStats()
        self.latency_samples: List[float] = []
        self.tick_wall_samples: List[float] = []  # per-tick wall seconds
        # Pipelined tick: with depth D, up to D-1 ticks' launches stay in
        # flight while the host stages the next tick (a CUDA launch
        # returns before the card finishes).  Each tick appends one
        # entry carrying the per-shard sync tokens and the tick's
        # applied events; the staged sync pops entries past the depth
        # at the barrier slot — the SAME logical stream position in
        # every mode, so pipelining moves only wall time (logical
        # streams are byte-identical at any depth).  The effective
        # depth is capped by the backends' ``max_pipeline_ticks``.
        self.pipeline_ticks = max(1, pipeline_ticks)
        # Pipeline aliasing sanitizer: when on, every
        # dispatched tick's stacked op tensors are CRC-fingerprinted at
        # the dispatch edge and re-checked at that entry's staged sync;
        # any host write that raced the in-flight device step raises
        # PipelineAliasingError naming tick/shard/array.  Detection
        # only — it emits no trace events, so sanitized runs stay
        # byte-identical on the logical stream.
        self.sanitize_pipeline = sanitize_pipeline
        # Tick trains: with T > 1, backends that opt in
        # (``max_train_ticks`` > 1 — the flat backend's device-prefill
        # path) buffer T ticks' op tensors + prefill deltas and apply them
        # in one launch; a pure wall-clock knob (trace events, counters and
        # the journal land at their per-tick logical positions, so logical
        # streams are byte-identical at any train length; the lanes
        # backend stays at 1).
        self.train_ticks = max(1, train_ticks)
        for b in residency.backends:
            if hasattr(b, "set_train_ticks"):
                b.set_train_ticks(self.train_ticks)
        self._inflight: List[dict] = []
        # Per-shard stall/win not yet attributed to a trace event: a
        # deferred entry's sync may pay stall for a shard that has no
        # device work — hence no tick.barrier event — THIS tick; the
        # wall carries to that shard's next emitted barrier event so
        # the trace totals match the in-memory accounting (end-of-run
        # flush leftovers stay in-memory only).
        self._pending_stall: Dict[int, float] = {}
        self._pending_win: Dict[int, float] = {}
        # End of the last staged sync: a later entry's overlap window
        # opens at max(its dispatch, this) — time spent BLOCKING on an
        # older entry is not window the host earned for the next one
        # (same-shard device work is queued behind the older tick's
        # anyway), and without the clamp that stall would double-count
        # as both stall and win, flooring overlap_frac near 0.5 on a
        # fully device-bound run.
        self._last_sync_end = 0.0
        # Overlap accounting: window = host wall an in-flight device
        # step had to hide under (dispatch -> staged sync start), stall
        # = what blocking still cost at the sync.  overlap_frac =
        # window / (window + stall) — 0 in the serial loop, -> 1 as
        # the pipeline fully hides device time.
        self.overlap_window_s = 0.0
        self.sync_stall_s = 0.0
        # Optional per-doc compiled-stream tap: called as
        # (doc_id, OpTensors) for every lane doc's tick stream BEFORE
        # padding/stacking.
        self.step_trace = None

    def bucket(self, steps: int) -> int:
        for b in self.step_buckets:
            if steps <= b:
                return b
        raise AssertionError(
            f"tick stream of {steps} steps exceeds the largest bucket "
            f"{self.step_buckets[-1]} (drain budget bug)")

    # -- pipelined staged sync ----------------------------------------------

    def effective_pipeline_ticks(self) -> int:
        """Configured depth capped by every backend's opt-in: one
        backend that trues up probe state at its barrier serializes the
        whole server (backends are homogeneous per server, so in
        practice this is all-or-nothing)."""
        return min([self.pipeline_ticks]
                   + [getattr(b, "max_pipeline_ticks", 1)
                      for b in self.residency.backends])

    def _now(self) -> Optional[float]:
        return self.clock() if self.clock is not None else None

    def effective_train_ticks(self) -> int:
        """Configured train length capped by every backend's opt-in
        (``max_train_ticks``; 1 on backends without a deferrable
        dispatch path, the blocked lanes backend among them)."""
        return min([self.train_ticks]
                   + [getattr(b, "train_ticks", 1)
                      for b in self.residency.backends])

    def _sync_entry(self, entry: dict) -> None:
        """Block until one in-flight tick's device work is done: the
        per-shard sync tokens when the entry was deferred (pipelined —
        a token blocks through ITS tick's work without serializing
        against later dispatches), ``backend.barrier()`` otherwise.
        Stamps the entry's applied events' admission->applied latency
        (device completion included, exactly as the serial loop's
        post-barrier stamp did); per-token window/stall accounting
        lives in ``_block_token``."""
        for tok in entry["tokens"]:
            self._block_token(entry, tok)
        now = self._now()
        if now is None:
            return
        for event in entry["events"]:
            if event.t_submit is not None:
                self.latency_samples.append(now - event.t_submit)

    def _block_token(self, entry: dict, tok: dict) -> None:
        """Block one shard's device work for one in-flight entry and
        account it.  Window = host wall since the entry's dispatch (or
        since the last block — time already spent BLOCKING is not
        overlap the host earned: same-shard device work queues behind
        what we were waiting for, and without the clamp a device-bound
        pipelined run would floor near frac 0.5).  Only DEFERRED
        entries (real sync tokens) accrue window: the serial loop's
        immediate sync accrues stall only, so its µs-scale bookkeeping
        gaps can't manufacture overlap and the documented contract —
        frac == 0.0 at depth 1 — holds."""
        if tok["done"]:
            return
        shard = tok["shard"]
        t0 = self._now()
        win = 0.0
        if tok["token"] is not None:
            if t0 is not None:
                win = max(0.0, t0 - max(entry["t_dispatched"],
                                        self._last_sync_end))
            _wait(tok["token"])
        else:
            self.residency.backends[shard].barrier()
        stall = 0.0 if t0 is None else self.clock() - t0
        tok["done"] = True
        self._check_guards(entry, shard)
        if t0 is not None:
            self._last_sync_end = self.clock()
        self.overlap_window_s += win
        self.sync_stall_s += stall
        self._pending_stall[shard] = (
            self._pending_stall.get(shard, 0.0) + stall)
        self._pending_win[shard] = (
            self._pending_win.get(shard, 0.0) + win)

    def _check_guards(self, entry: dict, shard: int) -> None:
        """Sanitizer re-check at the staged sync: the op tensors this
        shard's in-flight tick dispatched must CRC-match their
        dispatch-edge fingerprints — a mismatch means host code wrote
        into arrays the device step may have been reading (the hazard
        class the double-buffered tick opened)."""
        for guard in entry.get("guards", ()):
            if guard["shard"] != shard:
                continue
            self.counters.incr("sanitize_checks")
            fresh = _op_fingerprints(guard["arrays"])
            for name, crc in guard["crcs"].items():
                if fresh[name] != crc:
                    raise PipelineAliasingError(
                        f"pipeline aliasing: tick {entry['tick']} shard "
                        f"{shard} array {name!r} changed between "
                        f"dispatch and its staged sync (crc "
                        f"{crc:#010x} -> {fresh[name]:#010x}) — host "
                        f"code wrote into an op tensor an in-flight "
                        f"device step reads")

    def _sync_shard_inflight(self, shard: int) -> None:
        """Complete SHARD's older in-flight device work right before a
        new dispatch to it.  The lanes backend's dispatch path reads the
        previous tick's row counts and kernel flags host-side, which
        would otherwise block on that work INSIDE the dispatch-wall
        measurement — hiding any device time the host window failed to
        cover from the stall accounting.  Syncing here keeps the
        dispatch wall enqueue-only and charges un-hidden device time to
        the pipeline stall it actually is."""
        for entry in self._inflight:
            for tok in entry["tokens"]:
                if tok["shard"] == shard:
                    self._block_token(entry, tok)

    def flush_pipeline(self) -> None:
        """Drain every in-flight tick (end of run / before reading
        latency percentiles).  Emits no trace events, so a flushed
        pipelined stream stays byte-identical to the serial one;
        idempotent and a no-op in the serial loop (depth 1 never leaves
        an entry behind).  Open tick trains dispatch first: their device
        work must be enqueued before the entries' sync tokens can cover
        it."""
        for b in self.residency.backends:
            if hasattr(b, "flush_train"):
                b.flush_train()
        while self._inflight:
            self._sync_entry(self._inflight.pop(0))

    def pipeline_overlap_frac(self) -> float:
        """Fraction of the measured device-sync demand the pipeline hid
        under host work: window / (window + stall).  0.0 in the serial
        loop (no window), -> 1.0 when the staged sync never blocks."""
        denom = self.overlap_window_s + self.sync_stall_s
        return self.overlap_window_s / denom if denom > 0 else 0.0

    # -- per-event processing ----------------------------------------------

    def _grow_table(self, doc: DocState, names) -> None:
        """Register new agent names; if the doc holds a lane, re-base its
        persisted rank log through the old->new rank map (the epoch
        boundary of ``ops.batch.rank_remap`` — mid-stream onboarding)."""
        new = [n for n in names if n != "ROOT" and n not in doc.table]
        if not new:
            return
        old_names = list(doc.table.names)
        for n in new:
            doc.table.add(n)
        if doc.in_lane and old_names:
            mapping = B.rank_remap(old_names, doc.table)
            backend = self.residency.backends[doc.shard]
            backend.remap_lane_ranks(doc.lane, mapping)
            self.counters.incr("lane_rank_remaps")

    def _apply_local(self, doc: DocState, event: Event,
                     compile_device: bool):
        """Oracle-apply (+ compile when the doc serves from a lane) one
        local edit. Returns (applied, ops-or-None); an invalid position
        is counted and dropped — (False, None)."""
        agent, pos, del_len, ins = event.payload
        oracle = doc.oracle
        live = len(oracle)
        if pos > live or pos + del_len > live:
            self.counters.incr("events_invalid")
            if self.flow is not None and event.lk is not None:
                # Terminal typed refusal for the span: the edit raced a
                # position the server never reached (deterministically
                # dropped — the loadgen's twin-sourced positions).
                self.flow.rejected(doc.doc_id, agent, "invalid-position",
                                   lk=event.lk)
            return False, None
        self._grow_table(doc, [agent])
        aid = oracle.get_or_create_agent_id(agent)
        seq0 = oracle.client_data[aid].get_next_seq()
        o0 = oracle.get_next_order()
        oracle.apply_local_txn(aid, [LocalOp(pos=pos, ins_content=ins,
                                             del_span=del_len)])
        doc.assigner.assign(doc.table.id_of(agent), seq0, event.items)
        # Realize the span for the tick's terminal flow.apply stamp
        # (mode — device vs host — is only known after the lane-
        # capacity probe, so the batcher stamps it there).
        event.span = (agent, seq0, event.items)
        if self.tracer is not None:
            # The event-level audit log the divergence post-mortem
            # joins against: WHICH (agent, seq) span landed on WHICH
            # logical tick.
            self.tracer.event("apply", doc=doc.doc_id, ev="local",
                              agent=agent, seq=seq0, n=event.items)
        if not compile_device:
            return True, None
        ops, next_o = B.compile_local_patches(
            [TestPatch(pos, del_len, ins)], rank=doc.table.rank_of(agent),
            lmax=self.lmax, start_order=o0, dmax=None)
        assert next_o == oracle.get_next_order()
        return True, ops

    def _apply_txn(self, doc: DocState, event: Event,
                   compile_device: bool):
        """Oracle-apply (+ compile) one released remote txn. A txn whose
        references don't resolve (buggy/malicious peer beyond what the
        causal buffer can see) is rejected typed-and-counted and the
        buffer watermark rolled back so an honest redelivery lands."""
        txn: RemoteTxn = event.payload
        if not txn_refs_known(doc.oracle, txn):
            self.counters.incr("txns_rejected")
            doc.buffer.rollback_watermark(txn.id.agent, txn.id.seq)
            if self.flow is not None:
                # Non-terminal when honest redelivery lands later (the
                # rollback re-opens the watermark for it); terminal for
                # a genuinely bogus peer txn.
                self.flow.rejected(doc.doc_id, txn.id.agent,
                                   "refs-unknown", seq=txn.id.seq,
                                   n=event.items)
            return False, None
        self._grow_table(doc, ShardRouter.txn_agent_names(txn))
        doc.oracle.apply_remote_txn(txn)
        event.span = (txn.id.agent, txn.id.seq, event.items)
        if self.tracer is not None:
            self.tracer.event("apply", doc=doc.doc_id, ev="txn",
                              agent=txn.id.agent, seq=txn.id.seq,
                              n=event.items)
        if not compile_device:
            # Host-only doc: advance the compiler's order metadata the
            # exact way compile_remote_txns would (whole-txn span) but
            # skip the tensor emission nothing will consume — with most
            # docs host-only under lane pressure this is the bulk of a
            # tick's host work.
            agent = doc.table.id_of(txn.id.agent)
            assert doc.assigner.next_seq(agent) == txn.id.seq
            doc.assigner.assign(agent, txn.id.seq, event.items)
            return True, None
        ops, doc.assigner = B.compile_remote_txns(
            [txn], doc.table, assigner=doc.assigner, lmax=self.lmax,
            dmax=None)
        return True, ops

    @staticmethod
    def _new_agent_names(doc: DocState, event: Event) -> List[str]:
        """Agent names this event would onboard into the doc's table."""
        if event.kind == EV_LOCAL:
            agent = event.payload[0]
            return [] if (agent == "ROOT" or agent in doc.table) \
                else [agent]
        return [n for n in ShardRouter.txn_agent_names(event.payload)
                if n not in doc.table]

    def _drain_doc(self, doc: DocState, budget: int, compile_device: bool
                   ) -> Tuple[Optional[B.OpTensors], List[Event], int,
                              List[Optional[Tuple[int, int]]]]:
        """Drain up to ``budget`` compiled steps of FIFO events from one
        doc: oracle-apply each, compile each (lane docs only), concat.
        Returns (tick stream or None, APPLIED events, steps, per-event
        compiled step ranges) — rejected or invalid events are dequeued
        but excluded from ``applied`` so they feed neither the
        ops-applied stats nor latency samples.  ``ranges[i]`` is applied
        event i's [s0, s1) row span in the concatenated tick stream
        (None for host-only drains), the pre-fusion coordinates the
        fuser's ``step_map`` translates to fused super-steps."""
        streams: List[B.OpTensors] = []
        applied: List[Event] = []
        ranges: List[Optional[Tuple[int, int]]] = []
        steps = 0
        while doc.events:
            event = doc.events[0]
            est = estimate_steps(doc, event, self.lmax)
            if steps + est > budget:
                break
            if applied and self._new_agent_names(doc, event):
                # Agent onboarding is an EPOCH BOUNDARY: the rank remap
                # rewrites the lane's persisted by-order ranks, but the
                # steps already compiled this tick baked the OLD ranks
                # in — applying both in one stream would prefill stale
                # ranks over the re-based log and diverge later
                # same-origin tiebreaks.  Defer the onboarding event to
                # the next tick so every compiled tick stream is
                # single-epoch (FIFO preserved; one tick of latency).
                # Gated on APPLIED (not compiled streams): host-only
                # docs must defer on the same schedule, or the apply
                # timing — and with it the interleaving of tick-end
                # causal releases vs later local edits — would depend
                # on the doc's lane status, which differs across lane
                # backends (degradation thresholds differ) and would
                # break the cross-backend bit-identity contract.  For
                # lane docs the two conditions coincide (every applied
                # event compiles >= 1 step).
                self.counters.incr("epoch_boundary_deferrals")
                break
            doc.events.popleft()
            self.router.admission.dequeued()
            ok, ops = (self._apply_local(doc, event, compile_device)
                       if event.kind == EV_LOCAL
                       else self._apply_txn(doc, event, compile_device))
            if event.kind == EV_LOCAL and event.ordinal is not None:
                # The local-edit durability watermark advances on
                # PROCESSING, not success: a validity-dropped local
                # consumed its ordinal too.  Checkpointed as an audit
                # stamp.
                doc.local_applied = max(doc.local_applied,
                                        event.ordinal + 1)
            if not ok:
                continue
            applied.append(event)
            if compile_device and ops is not None and ops.num_steps > 0:
                ranges.append((steps, steps + ops.num_steps))
                streams.append(ops)
                steps += ops.num_steps
            else:
                ranges.append(None)
                if not compile_device:
                    steps += est  # budget proxy: bounds host drain too
        if not streams:
            return None, applied, steps if compile_device else 0, ranges
        return B.concat_ops(streams), applied, steps, ranges

    def _flow_applies(self, doc: DocState, applied: List[Event],
                      ranges, fs, device: bool) -> None:
        """Stamp the terminal ``flow.apply`` for every span a doc's
        tick drain applied: realized ``(agent, seq, n)`` from the
        event, device-vs-host mode from the probe outcome, and — when
        the tick stream fused — the fused super-step that absorbed the
        span's compiled rows (``FuseStats.step_map`` translated through
        the event's pre-fusion row range)."""
        mode = "device" if device else "host"
        fmap = fs.step_map if fs is not None else None
        for event, rng in zip(applied, ranges):
            if event.span is None:
                continue
            agent, seq, n = event.span
            fstep = fn = None
            if fmap is not None and rng is not None:
                fstep = fmap[rng[0]]
                fn = fmap[rng[1] - 1] - fstep + 1
            self.flow.applied(doc.doc_id, agent, seq, n, mode,
                              lk=event.lk, fstep=fstep, fn_steps=fn)

    # -- the tick -----------------------------------------------------------

    def tick(self, tick_no: int) -> Dict[str, float]:
        """One serving tick across all shards; returns tick stats.

        A typed error escaping mid-tick (aliasing sanitizer, capacity
        assert, an injected fault) must not strand dispatched-but-
        unsynced pipeline entries: their staged syncs would never run,
        leaking device work, latency stamps and flow spans — and a
        later ``flush_pipeline`` after partial host mutations could
        sync against torn state.  So the in-flight queue is drained
        before the error propagates."""
        try:
            return self._tick_inner(tick_no)
        except BaseException as tick_exc:
            try:
                self.flush_pipeline()
            except Exception as flush_exc:
                # The original error is the story; the flush failure is
                # recorded, not raised over it.
                if self.recorder is not None:
                    self.recorder.on_failure(
                        "pipeline-flush",
                        f"flush_pipeline failed while unwinding "
                        f"tick {tick_no}: {flush_exc} "
                        f"(original: {tick_exc})")
            raise

    def _tick_inner(self, tick_no: int) -> Dict[str, float]:
        t0 = self._now()
        tr = self.tracer
        if tr is not None:
            tr.set_tick(tick_no)
        stats = {"ops_applied": 0, "events_applied": 0, "steps": 0,
                 "lanes_active": 0}

        # 1. Residency: restore evicted docs with traffic, find lanes
        #    for host-only docs (both may LRU-evict colder docs; both
        #    stamp the doc's touch tick so a doc granted residency this
        #    tick is never stolen later in the same pass).
        for doc in self.router.docs.values():
            if doc.events and not doc.resident:
                self.residency.restore(doc, tick_no)
            if (doc.events and doc.resident and not doc.in_lane
                    and not doc.degraded):
                self.residency.try_assign_lane(doc, tick_no)

        # 2. Drain + compile per shard, apply in one device pass each.
        #    Host-only docs drain without tensor emission (nothing would
        #    consume the streams — the oracle apply is the whole serve).
        applied_events: List[Event] = []
        tick_guards: List[dict] = []
        active_shards: set = set()
        for shard, backend in enumerate(self.residency.backends):
            t_drain = self._now()
            lane_streams: Dict[int, B.OpTensors] = {}
            host_only_applies = 0
            shard_events = 0
            shard_steps = 0
            probed = degraded = 0
            budget = self.step_buckets[-1]
            for doc in self.router.docs.values():
                if doc.shard != shard or not doc.events:
                    continue
                if not doc.resident:
                    continue  # restore deferred (no lane, no memory)
                stream, applied, steps, ev_ranges = self._drain_doc(
                    doc, budget, compile_device=doc.in_lane)
                applied_events.extend(applied)
                stats["events_applied"] += len(applied)
                stats["ops_applied"] += sum(e.items for e in applied)
                shard_events += len(applied)
                shard_steps += steps
                fs = None
                if (self.fuse_steps and doc.in_lane
                        and stream is not None):
                    if stream.num_steps > 1:
                        # Fuse the doc's tick stream BEFORE the
                        # capacity probe and stacking: per-event
                        # compilation never sees adjacent events, so
                        # this is where typing runs / sweeps / replaces
                        # / same-tick remote runs collapse
                        # (bit-identical stream, fewer rows).
                        stream, fs = B.fuse_steps(
                            stream,
                            fuse_w=min(self.fuse_w,
                                       getattr(backend, "max_fuse_w",
                                               1)))
                    else:
                        # Single-step streams can't fuse but ARE device
                        # steps: count them so steps_total/ops_per_step
                        # measure the whole run, not the fused subset.
                        fs = B.FuseStats(steps_in=stream.num_steps,
                                         steps_out=stream.num_steps)
                scheduled = False
                if doc.in_lane and stream is not None:
                    # Lane-capacity probe AFTER the oracle applied (the
                    # oracle is truth): overflow degrades to host-only,
                    # frees the lane, skips the device — never asserts.
                    # Backends define their own unit (chars for flat,
                    # run rows + split headroom for the blocked lanes).
                    probed += 1
                    if backend.tick_fits(doc.lane, doc.oracle, stream):
                        scheduled = True
                        if self.step_trace is not None:
                            self.step_trace(doc.doc_id, stream)
                        lane_streams[doc.lane] = stream
                        stats["steps"] += stream.num_steps
                        if fs is not None:
                            # Count fusion only for streams that WILL
                            # run as device steps: a probe failure
                            # degrades to host-only, and its rows must
                            # not inflate the exported device-step
                            # counters.
                            self.fuse_stats.merge(fs)
                            if tr is not None and fs.rows_saved > 0:
                                tr.event("tick.fuse", doc=doc.doc_id,
                                         steps_in=fs.steps_in,
                                         steps_out=fs.steps_out)
                            observe(self.counters, "ops_per_step",
                                    fs.reduction_x)
                            observe(self.counters, "fused_rows_saved",
                                    fs.rows_saved)
                        if self.recorder is not None:
                            self.recorder.record_stream(doc.doc_id, {
                                "tick": tick_no,
                                "num_steps": int(stream.num_steps),
                                "steps_prefuse": (fs.steps_in if fs
                                                  else int(stream.num_steps)),
                            })
                    else:
                        degraded += 1
                        self.residency.degrade(
                            doc, f"lane capacity overflow: {doc.oracle.n} "
                                 f"rows / {doc.oracle.get_next_order()} "
                                 f"orders vs {backend.capacity}/"
                                 f"{backend.order_capacity}")
                elif not doc.in_lane and applied:
                    host_only_applies += 1
                if self.flow is not None and applied:
                    # Terminal flow.apply per span, stamped AFTER the
                    # capacity probe so the mode is truthful: a probe
                    # failure means the oracle applied but no device
                    # step ran — "host", exactly like host-only docs.
                    self._flow_applies(doc, applied, ev_ranges,
                                       fs if scheduled else None,
                                       scheduled)

            if tr is not None and (shard_events or shard_steps):
                # Drain wall = the whole host-side doc loop (oracle
                # apply + compile + fuse + capacity probes) — the phase
                # the pipelined tick overlaps with the previous tick's
                # in-flight device step.
                tr.event("tick.drain", shard=shard, events=shard_events,
                         steps=shard_steps,
                         wall=self._wall_ms(t_drain))
            if tr is not None and probed:
                tr.event("tick.capacity", shard=shard, probed=probed,
                         degraded=degraded)
            if lane_streams:
                active_shards.add(shard)
                s_max = max(s.num_steps for s in lane_streams.values())
                s_bkt = self.bucket(s_max)
                # First launch at a bucket shape (a compile in the JAX
                # package, hence the names): steady state must stop
                # emitting these.
                seen = getattr(backend, "shapes_seen", None)
                fresh_shape = seen is not None and s_bkt not in seen
                per_lane = [
                    B.pad_ops(lane_streams.get(b, B.empty_ops(self.lmax)),
                              s_bkt)
                    for b in range(backend.lanes)
                ]
                stacked = B.stack_ops(per_lane)
                # Finish this shard's older in-flight work FIRST (the
                # staged sync, pulled forward to the dispatch edge):
                # apply()'s host-side device reads would block on it
                # anyway, but inside the dispatch-wall window — this
                # keeps disp_ms enqueue-only and charges un-hidden
                # device time to the pipeline stall accounting.
                # Backends whose dispatch path reads NO device state
                # (``dispatch_reads_device`` False) skip the forced sync.
                if getattr(backend, "dispatch_reads_device", True):
                    self._sync_shard_inflight(shard)
                t_dev = self._now()
                backend.apply(stacked)
                disp = self._wall_ms(t_dev)
                if self.sanitize_pipeline:
                    # Dispatch-edge fingerprint: these exact array
                    # objects are what the in-flight device step may
                    # still read; the staged sync re-checks them.
                    tick_guards.append({
                        "shard": shard, "arrays": stacked,
                        "crcs": _op_fingerprints(stacked)})
                real = sum(s.num_steps for s in lane_streams.values())
                if fresh_shape:
                    self.counters.incr("device_compiles")
                    if tr is not None:
                        tr.event("device.compile", shard=shard,
                                 bucket=s_bkt)
                if tr is not None:
                    # Dispatch wall (host prefill + enqueue; the device
                    # sync lands in tick.barrier) — segregated under
                    # "w" so the logical stream stays seed-determined.
                    tr.event("tick.device", shard=shard, bucket=s_bkt,
                             lanes=len(lane_streams), steps=real,
                             wall=disp)
                if disp is not None:
                    observe(self.counters,
                            f"device_step_wall_ms_b{s_bkt}", disp["ms"])
                stats["lanes_active"] += len(lane_streams)
                self.counters.sample(
                    "batch_fill_ratio",
                    real / float(s_bkt * backend.lanes))
                self.counters.incr("device_ticks")
                self.counters.incr("device_steps", s_bkt)
            self.counters.incr("host_only_applies", host_only_applies)

        # 3. The barrier slot.  The per-shard ``tick.barrier`` events
        #    are emitted at the SAME logical stream position in every
        #    mode (the pipelined-vs-serial byte-identity contract), but
        #    the actual block on the card is staged behind the pipeline
        #    depth: with depth D this tick's device pass stays in
        #    flight while the next D-1 host ticks (drain, compile,
        #    oracle applies, residency checkpoint I/O) run, and the
        #    stall paid here is only the device time that host work
        #    could not hide.  Admission->applied latency stamps ride
        #    the staged sync, so they still include device completion.
        depth = self.effective_pipeline_ticks()
        tokens = []
        for shard, backend in enumerate(self.residency.backends):
            tok = backend.sync_token() if depth > 1 else None
            tokens.append({"shard": shard, "token": tok, "done": False})
        self._inflight.append({"tick": tick_no, "tokens": tokens,
                               "t_dispatched": self._now(),
                               "events": applied_events,
                               "guards": tick_guards})
        while len(self._inflight) > depth - 1:
            self._sync_entry(self._inflight.pop(0))
        if tr is not None:
            for shard in sorted(active_shards):
                # Wall names the shard's accumulated unreported sync
                # cost: the residual stall ("ms") and the host window
                # the in-flight step got to hide under ("win").  Once
                # the pipeline is primed the sync paid here belongs to
                # the PREVIOUS tick's entry — and a shard with no
                # device work this tick gets no event, so its numbers
                # carry to its next emitted barrier (the trace totals
                # stay equal to the in-memory accounting).  Logical
                # content is mode-invariant; only wall numbers move.
                stall = self._pending_stall.pop(shard, 0.0)
                win = self._pending_win.pop(shard, 0.0)
                tr.event("tick.barrier", shard=shard, wall=(
                    None if self.clock is None else {
                        "ms": round(stall * 1e3, 3),
                        "win": round(win * 1e3, 3)}))
        now = self._now()
        for doc in self.router.docs.values():
            if doc.resident:
                released = doc.buffer.advance_watermarks(
                    agent_watermarks(doc.oracle))
                if released:
                    self.router.enqueue_released(doc, released)
        if now is not None:
            stats["tick_wall_s"] = now - t0
            self.tick_wall_samples.append(stats["tick_wall_s"])
            observe(self.counters, "tick_wall_ms",
                    stats["tick_wall_s"] * 1e3)
        return stats

    def _wall_ms(self, t0: Optional[float]) -> Optional[dict]:
        """A trace event's ``"w"`` dict for the wall since ``t0`` on the
        caller's clock; None without one."""
        if t0 is None:
            return None
        return {"ms": round((self.clock() - t0) * 1e3, 3)}
