"""Doc lifecycle: admit -> resident-in-lane -> evicted-to-checkpoint
(counterpart of ``text_crdt_rust_tpu/serve/residency.py``), with the
crash recovery's spool audit (``rediscover``).

An LRU policy over the shards' device lanes. The working set of hot
documents lives in lanes (device-accelerated); colder documents fall
back in two graceful stages, neither of which is ever an assert:

- **host-only** — oracle in memory, no lane (all lanes hotter, or the
  doc outgrew the lane capacity and is permanently ``degraded``). Ticks
  still apply its events to the oracle; the next lane acquisition
  re-seeds device state wholesale via ``upload_lane``.
- **evicted** — the oracle is serialized through ``utils/checkpoint.py``
  (FORMAT_VERSION 3, CRC-guarded: a restore is bit-perfect or refuses)
  and dropped from memory. ``ckpt_format="delta"`` (the default via
  ``ServeConfig``) writes a ``CheckpointChain`` link — the
  columnar-encoded ops since the last save, O(new ops) instead of
  O(doc) — with periodic base compaction; ``"full"`` writes one
  snapshot per evict. The doc's ``CausalBuffer`` and event queue
  stay live, so peer traffic keeps accumulating causally while the doc
  is out. A later touch restores: ``load_doc`` (or the chain's
  base + replay) rebuilds the oracle, ``OrderAssigner.from_oracle``
  rebuilds the compiler state, and the queued events replay through
  the normal tick path, bit-identical to an always-resident twin.

Eviction preference: least-recently-touched lane doc without pending
events; a victim touched in the current tick is never stolen (the
restored doc serves host-only for a tick instead — bounded, no
livelock). The analog of paged-out KV cache + prompt re-upload in LLM
serving: restore costs O(doc), correctness costs nothing.
"""
from __future__ import annotations

import os
import tempfile
from typing import Callable, Dict, List, Optional

from ..ops import batch as B
from ..utils import checkpoint
from ..utils.metrics import Counters
from .batcher import oracle_signed
from .router import DocState, ShardRouter


class LaneResidency:
    """Lane ownership + the evict/restore state machine."""

    def __init__(self, backends: List, router: ShardRouter, *,
                 spool_dir: Optional[str] = None,
                 counters: Optional[Counters] = None,
                 ckpt_format: str = "full",
                 ckpt_compact_ops: int = 4096,
                 ckpt_compact_links: int = 16,
                 tracer=None,
                 clock: Optional[Callable[[], float]] = None):
        assert ckpt_format in ("full", "delta"), ckpt_format
        self.backends = backends
        # The caller's wall clock (seconds): checkpoint I/O walls ride the
        # trace's "w" fields; None = no walls.
        self.clock = clock
        self.router = router
        self.counters = counters if counters is not None else Counters()
        self.tracer = tracer
        self.recorder = None  # set by DocServer after construction
        self.spool_dir = spool_dir or tempfile.mkdtemp(prefix="tcr_serve_")
        os.makedirs(self.spool_dir, exist_ok=True)
        # "full" = one O(doc) snapshot per evict;
        # "delta" = CRC-chained incremental saves, O(ops since the last
        # save) for a warm evict, with periodic base compaction.
        self.ckpt_format = ckpt_format
        self.ckpt_compact_ops = ckpt_compact_ops
        self.ckpt_compact_links = ckpt_compact_links
        self._chains: Dict[str, checkpoint.CheckpointChain] = {}
        # lane_owner[shard][lane] -> doc_id | None
        self.lane_owner: List[List[Optional[str]]] = [
            [None] * b.lanes for b in backends
        ]
        self._ckpt_ids: Dict[str, int] = {}
        # Monotonic file-number allocator, NOT len(_ckpt_ids): a refused
        # file's number must stay burned or a new doc would collide
        # with a surviving doc's files.
        self._next_ckpt_id = 0

    # -- introspection -------------------------------------------------------

    def resident_counts(self) -> Dict[str, int]:
        in_lane = sum(1 for s in self.lane_owner for d in s if d)
        docs = self.router.docs.values()
        return {
            "docs_total": len(self.router.docs),
            "docs_in_lane": in_lane,
            "docs_host_only": sum(1 for d in docs
                                  if d.resident and not d.in_lane),
            "docs_evicted": sum(1 for d in docs if d.evicted),
            "docs_degraded": sum(1 for d in docs if d.degraded),
        }

    def _ckpt_path(self, doc_id: str) -> str:
        # Stable, filesystem-safe name per doc (ids are arbitrary strings).
        if doc_id not in self._ckpt_ids:
            self._ckpt_ids[doc_id] = self._next_ckpt_id
            self._next_ckpt_id += 1
        return os.path.join(self.spool_dir,
                            f"doc_{self._ckpt_ids[doc_id]:06d}.npz")

    # -- lane allocation -----------------------------------------------------

    def _free_lane(self, shard: int) -> Optional[int]:
        for lane, owner in enumerate(self.lane_owner[shard]):
            if owner is None:
                return lane
        return None

    def _lru_victim(self, shard: int, tick_no: int) -> Optional[DocState]:
        """Least-recently-touched lane doc of ``shard`` that is safe to
        steal from: prefer docs with no pending events; never one
        touched this tick."""
        docs = [self.router.docs[d] for d in self.lane_owner[shard] if d]
        docs = [d for d in docs if d.last_touch_tick < tick_no]
        if not docs:
            return None
        idle = [d for d in docs if not d.events]
        pool = idle or docs
        return min(pool, key=lambda d: d.last_touch_tick)

    def try_assign_lane(self, doc: DocState, tick_no: int) -> bool:
        """Find ``doc`` a lane on its shard (evicting the LRU victim if
        none is free). False = stay host-only this tick (every lane is
        hotter) — a deferral, not a failure."""
        assert doc.resident and not doc.in_lane
        backend = self.backends[doc.shard]
        # fits_doc is the backend's EXACT occupancy probe (chars for the
        # flat engine, RLE run rows for the blocked lanes engine).
        if not backend.fits_doc(doc.oracle):
            self.degrade(doc, f"doc ({doc.oracle.n} rows, "
                              f"{doc.oracle.get_next_order()} orders) "
                              f"exceeds lane capacity "
                              f"{backend.capacity}/{backend.order_capacity}")
            return False
        lane = self._free_lane(doc.shard)
        if lane is None:
            victim = self._lru_victim(doc.shard, tick_no)
            if victim is None:
                self.counters.incr("lane_acquire_deferred")
                return False
            self.evict(victim)
            lane = self._free_lane(doc.shard)
            assert lane is not None
        doc.lane = lane
        # Granting a lane IS a touch: without the stamp, every doc's
        # last_touch_tick predates this tick (submissions happen between
        # ticks) and the LRU's touched-this-tick guard would be vacuous
        # — a doc restored early in the residency pass could be stolen
        # again later in the SAME pass, stalling its queued events.
        doc.last_touch_tick = tick_no
        self.lane_owner[doc.shard][lane] = doc.doc_id
        backend.upload_lane(lane, doc.oracle, doc.table.rank_of_agent())
        self.counters.incr("lane_uploads")
        return True

    def release_lane(self, doc: DocState) -> None:
        if not doc.in_lane:
            return
        self.backends[doc.shard].clear_lane(doc.lane)
        self.lane_owner[doc.shard][doc.lane] = None
        doc.lane = None

    def degrade(self, doc: DocState, reason: str) -> None:
        """Capacity overflow: host-oracle-only from here on (the
        ``DeviceMirror`` degrade contract — never an assert)."""
        self.release_lane(doc)
        doc.degraded = True
        doc.degrade_reason = reason
        self.counters.incr("lane_overflow_degraded")
        if self.tracer is not None:
            self.tracer.event("residency.degrade", doc=doc.doc_id,
                              reason=reason)
        if self.recorder is not None:
            self.recorder.on_failure("degrade", reason, doc_id=doc.doc_id,
                                     shard=doc.shard, oracle=doc.oracle)

    # -- evict / restore -----------------------------------------------------

    def evict(self, doc: DocState) -> str:
        """Serialize the oracle to its CRC-guarded checkpoint, drop the
        in-memory state, free the lane. The causal buffer and event
        queue survive in memory (peers keep editing the doc while it is
        out). Returns the checkpoint path."""
        assert doc.resident, "evicting an already-evicted doc"
        path = self._ckpt_path(doc.doc_id)
        # Snapshot the oracle's per-agent watermarks first: REQUEST
        # emission must keep seeing the persisted history's extent
        # (router.poll_request_frame reads known_marks).
        doc.absorb_oracle_marks()
        t_io = self.clock() if self.clock is not None else None
        # Extra meta rides every save: the doc id maps files back to
        # docs when recovery rediscovers checkpoints from disk, and
        # ``local_applied`` is an audit stamp written atomically with
        # the oracle state it describes.
        extra = {"doc_id": doc.doc_id,
                 "local_applied": doc.local_applied}
        if self.ckpt_format == "delta":
            chain = self._chains.get(doc.doc_id)
            if chain is None:
                chain = self._chains[doc.doc_id] = checkpoint.CheckpointChain(
                    path[:-len(".npz")],
                    compact_ops=self.ckpt_compact_ops,
                    compact_links=self.ckpt_compact_links)
            info = chain.save(doc.oracle, extra_meta=extra)
            path = chain.base_path
        else:
            info = checkpoint.save_doc(doc.oracle, path, extra_meta=extra)
            info = {"kind": "full", "bytes": info["bytes"]}
        wall = (None if t_io is None
                else {"ms": round((self.clock() - t_io) * 1e3, 3)})
        self.counters.incr(f"ckpt_saves_{info['kind']}")
        if info["kind"] != "noop":
            # "noop" = the chain tip already covers this state (zero
            # new ops since the last save) — nothing written, and a
            # 0-byte sample would flatter the per-evict means.
            self.counters.incr("ckpt_bytes_written", info["bytes"])
            self.counters.incr(f"ckpt_bytes_{info['kind']}", info["bytes"])
            self.counters.sample("ckpt_bytes_per_evict", info["bytes"])
            # Split by kind: the warm-evict claim compares the mean
            # DELTA link against the mean FULL snapshot, not the
            # blended mean.
            self.counters.sample(f"ckpt_{info['kind']}_bytes_per_evict",
                                 info["bytes"])
        # Conservation checkpoint: the doc's item/order
        # counts at the eviction boundary.  The flow audit pairs these
        # with the restore's — a checkpoint replay that re-APPLIED
        # history (instead of re-creating state) would inflate them.
        n_items = doc.oracle.n
        n_orders = doc.oracle.get_next_order()
        doc.ckpt_path = path
        doc.oracle = None
        doc.table = None
        doc.assigner = None
        doc.evicted = True
        self.release_lane(doc)
        self.counters.incr("evictions")
        if self.tracer is not None:
            # The checkpoint-write wall rides the event (segregated
            # under "w"): residency evictions run in the tick's host
            # phase, so with the pipelined tick this I/O overlaps the
            # previous tick's in-flight device step.
            self.tracer.event("residency.evict", doc=doc.doc_id,
                              ckpt=info["kind"], bytes=info.get("bytes", 0),
                              n=n_items, orders=n_orders, wall=wall)
        return path

    def restore(self, doc: DocState, tick_no: Optional[int] = None) -> None:
        """Rebuild the full in-memory state from the checkpoint. Raises
        ``CheckpointError`` on a corrupt file (refusing beats silently
        serving garbage); queued events then replay via the normal tick
        path, so 'restored + replayed' is bit-identical to
        never-evicted. ``tick_no`` stamps the touch so the same tick's
        LRU pass cannot immediately re-evict the doc it just restored."""
        assert doc.evicted and doc.ckpt_path
        t_io = self.clock() if self.clock is not None else None
        try:
            if self.ckpt_format == "delta":
                oracle = self._chains[doc.doc_id].load()
            else:
                oracle = checkpoint.load_doc(doc.ckpt_path)
        except checkpoint.CheckpointError as e:
            # Refusal is the contract (bit-perfect or nothing) — but it
            # must leave a post-mortem behind: WHICH doc, which tick,
            # what the server did to that checkpoint beforehand.
            if self.tracer is not None:
                self.tracer.event("residency.restore", doc=doc.doc_id,
                                  error=str(e))
            if self.recorder is not None:
                self.recorder.on_failure("checkpoint", str(e),
                                         doc_id=doc.doc_id,
                                         shard=doc.shard, tick=tick_no)
            raise
        doc.oracle = oracle
        doc.table = B.AgentTable([cd.name for cd in oracle.client_data])
        doc.assigner = B.OrderAssigner.from_oracle(oracle, doc.table)
        doc.evicted = False
        if tick_no is not None:
            doc.last_touch_tick = tick_no
        self.counters.incr("restores")
        if self.tracer is not None:
            # The restore side of the conservation pair: queued events
            # replay AFTER this through normal ticks, so these counts
            # must equal the eviction snapshot's exactly.  The I/O wall
            # rides the event only for IN-LOOP restores (tick_no set):
            # end-of-run verification restores happen outside any tick,
            # and counting their wall would inflate the overlap
            # report's final-tick host occupancy with work no pipeline
            # could ever hide.
            wall = None
            if tick_no is not None and t_io is not None:
                wall = {"ms": round((self.clock() - t_io) * 1e3, 3)}
            self.tracer.event("residency.restore", doc=doc.doc_id,
                              n=oracle.n,
                              orders=oracle.get_next_order(),
                              wall=wall)

    # -- verification --------------------------------------------------------

    def verify_lane(self, doc: DocState) -> bool:
        """Device lane state bit-identical to the host oracle: the same
        ±(order+1) body column, row for row."""
        if not doc.in_lane:
            return True
        import numpy as np

        got = self.backends[doc.shard].lane_signed(doc.lane)
        want = oracle_signed(doc.oracle)
        ok = got.shape == want.shape and bool(np.array_equal(got, want))
        if not ok:
            if self.tracer is not None:
                self.tracer.event("divergence", doc=doc.doc_id,
                                  via="lane")
            if self.recorder is not None:
                self.recorder.on_failure(
                    "divergence",
                    f"device lane {doc.shard}/{doc.lane} != host oracle "
                    f"({got.shape} vs {want.shape} rows)",
                    doc_id=doc.doc_id, shard=doc.shard, oracle=doc.oracle)
        return ok

    # -- crash recovery -------------------------------------------------------

    def rediscover(self) -> Dict[str, dict]:
        """Audit the spool directory after a crash and advance the
        checkpoint-file allocator past everything on disk.

        Returns ``doc_id -> {"path", "local_applied"}`` for every doc
        with a LOADABLE checkpoint (chains validated link by link: a
        corrupt tail link truncates its chain, a corrupt BASE or full
        snapshot refuses the whole doc's checkpoint — each counted,
        traced, recorded).  Nothing is REGISTERED: recovery re-executes
        the journal from genesis, so replayed evictions lay down fresh
        checkpoint files — registering a crash-time chain here would
        hand a replayed (earlier-order) evict a tip from its own
        future.  (``local_applied`` is surfaced for that future
        incremental path; genesis replay does not read it.)  Pre-crash
        files survive untouched for forensics; the
        advanced ``_next_ckpt_id`` keeps fresh files clear of them,
        refused numbers included."""
        found: Dict[str, dict] = {}
        names = sorted(os.listdir(self.spool_dir))
        for name in names:
            if not (name.startswith("doc_") and name.endswith(".npz")):
                continue
            is_base = name.endswith(".base.npz")
            if self.ckpt_format == "delta":
                if not is_base:
                    continue  # delta links walk with their base
                file_no = int(name[len("doc_"):-len(".base.npz")])
                stem = os.path.join(self.spool_dir,
                                    name[:-len(".base.npz")])
                path = stem + ".base.npz"
            else:
                if is_base or ".d" in name:
                    continue  # stale delta files under full format
                file_no = int(name[len("doc_"):-len(".npz")])
                path = os.path.join(self.spool_dir, name)
            self._next_ckpt_id = max(self._next_ckpt_id, file_no + 1)
            try:
                if self.ckpt_format == "delta":
                    _chain, dropped, tip_meta = \
                        checkpoint.CheckpointChain.from_disk(
                            stem, compact_ops=self.ckpt_compact_ops,
                            compact_links=self.ckpt_compact_links)
                    for link_path in dropped:
                        self.counters.incr("recovery_ckpt_links_refused")
                        if self.tracer is not None:
                            self.tracer.event(
                                "residency.restore", doc=None,
                                error=f"refused chain link {link_path}")
                else:
                    tip_meta, _ = checkpoint._load_npz(
                        path, expect_kind="oracle")
            except checkpoint.CheckpointError as e:
                self.counters.incr("recovery_ckpt_refused")
                if self.tracer is not None:
                    self.tracer.event("residency.restore", doc=None,
                                      error=str(e))
                if self.recorder is not None:
                    self.recorder.on_failure("checkpoint", str(e),
                                             doc_id=None)
                continue
            doc_id = tip_meta.get("doc_id")
            if not isinstance(doc_id, str):
                # Pre-durability checkpoint without the doc-id meta:
                # unmappable, refuse it loudly rather than guess.
                self.counters.incr("recovery_ckpt_refused")
                if self.tracer is not None:
                    self.tracer.event(
                        "residency.restore", doc=None,
                        error=f"checkpoint {path} carries no doc_id meta")
                continue
            found[doc_id] = {
                "path": path,
                "local_applied": int(tip_meta.get("local_applied", 0)),
            }
        return found

    # -- verification --------------------------------------------------------

    def verify_lane(self, doc: DocState) -> bool:
        """Device lane state bit-identical to the host oracle: the same
        ±(order+1) body column, row for row."""
        if not doc.in_lane:
            return True
        import numpy as np

        got = self.backends[doc.shard].lane_signed(doc.lane)
        want = oracle_signed(doc.oracle)
        ok = got.shape == want.shape and bool(np.array_equal(got, want))
        if not ok:
            if self.tracer is not None:
                self.tracer.event("divergence", doc=doc.doc_id,
                                  via="lane")
            if self.recorder is not None:
                self.recorder.on_failure(
                    "divergence",
                    f"device lane {doc.shard}/{doc.lane} != host oracle "
                    f"({got.shape} vs {want.shape} rows)",
                    doc_id=doc.doc_id, shard=doc.shard, oracle=doc.oracle)
        return ok
