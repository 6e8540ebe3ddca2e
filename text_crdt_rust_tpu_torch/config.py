"""Configuration (counterpart of ``text_crdt_rust_tpu/config.py``): the
blocked-lanes geometry rule, the serve entries of the engine registry and
the document server's ``ServeConfig``."""
from __future__ import annotations

import dataclasses
from typing import Optional

# The serve entries of the JAX package's engine registry: the public
# engine name -> its implementing module (relative to this package), the
# configs that exercise it, and ``serve_backend``, the lane backend class
# ``serve.batcher.make_lane_backend`` builds.
ENGINE_REGISTRY = {
    "rle-lanes-mixed": {"module": "ops.rle_lanes_mixed",
                        "configs": ("5r", "serve", "serve-lanes"),
                        "fused_steps": True,
                        "serve_backend":
                            "serve.lanes_backend:LanesMixedLaneBackend"},
    "flat":            {"module": "ops.flat", "configs": ("serve",),
                        "serve_backend": "serve.batcher:FlatLaneBackend"},
}
ENGINE_CHOICES = tuple(ENGINE_REGISTRY)


def engines_for(config_key: str) -> tuple:
    """Engine names registered as valid for one config key."""
    return tuple(n for n, spec in ENGINE_REGISTRY.items()
                 if config_key in spec["configs"])


def lane_block_geometry(capacity: int, block_k: int) -> tuple:
    """Blocked-lanes geometry for a requested per-lane row capacity:
    ``(capacity, NB, NBT)`` with capacity rounded UP to a ``block_k``
    multiple (K is fixed across a stream's chunks; the growing per-chunk
    capacities of the streaming configs size NB, not K)."""
    cap = ((capacity + block_k - 1) // block_k) * block_k
    nb = cap // block_k
    return cap, nb, max(8, nb)


@dataclasses.dataclass
class ServeConfig:
    """The continuous-batching document server (``serve/``): the JAX
    package's fields and defaults.

    ``engine`` must be registered for the ``serve`` config in
    ``ENGINE_REGISTRY`` (``serve/batcher.make_lane_backend`` raises a typed
    error otherwise).
    The device is not a field: ``DocServer(cfg, device=...)`` takes it.
    """

    engine: str = "flat"       # registry engine backing the lane batches
    num_shards: int = 2        # device batches (one [rows, B] state each)
    lanes_per_shard: int = 16  # B — docs resident per shard batch
    lane_capacity: int = 512   # CAP — body rows per lane (rle-lanes-mixed:
    #                            RUN rows)
    order_capacity: int = 1536  # OCAP — by-order table rows per lane
    lanes_block_k: int = 32    # K (rows per block) of the blocked
    #                            rle-lanes-mixed backend: serve steps are
    #                            tiny edits and NBT + K is the per-step
    #                            touched-row floor
    interpret: Optional[bool] = None  # the JAX package's Pallas
    #                            interpreter switch; the port picks the
    #                            kernel or its plain version by device
    #                            and ignores it
    lmax: int = 16             # insert-chunk width of compiled serve
    #                            steps, also the cap on fused typing rows
    device_prefill: bool = True  # flat-backend surface (device-resident
    #                            by-order logs); the lanes backend's tables
    #                            are device-resident already and ignore it
    pipeline_ticks: int = 2    # host/device tick pipelining depth: 2 =
    #                            tick N+1's host work runs while tick N's
    #                            device step is in flight, 1 = the serial
    #                            loop; logical streams are byte-identical
    #                            at any depth
    train_ticks: int = 1       # device tick-train length (flat backend
    #                            only; the lanes backend stays at 1)
    sanitize_pipeline: bool = False  # CRC the op tensors each in-flight
    #                            tick references at dispatch and re-check
    #                            them at its staged sync
    step_buckets: tuple = (8, 32, 128)  # padded tick step shapes; a tick
    #                            drains at most step_buckets[-1] compiled
    #                            steps per doc so steady-state serving
    #                            cycles a fixed set of launch shapes
    max_queue_per_doc: int = 256    # admission: pending events per doc
    max_queue_global: int = 8192    # admission: pending events total
    max_txn_len: int = 128          # admission: items per submitted txn
    #                            (must fit step_buckets[-1])
    rate_capacity: int = 0          # token bucket size per agent (0 = off)
    rate_refill: int = 0            # tokens added per tick per agent
    spool_dir: Optional[str] = None  # eviction checkpoint directory
    journal_dir: Optional[str] = None  # write-ahead op journal
    #                            (serve/journal.py); None = durability off
    journal_fsync_ticks: int = 1  # fsync cadence of the journal
    fuse_steps: bool = True    # generalized tick-stream fusion
    fuse_w: int = 8            # burst width cap; effective W is
    #                            min(fuse_w, lanes_block_k // 2 - 1)
    nagle_txns: int = 16       # columnar-wire Nagle window: a peer
    #                            outbox ships once it holds this many
    #                            txns...
    nagle_rounds: int = 4      # ...or has waited this many ticks
    wire_format: str = "columnar"  # TXNS frames the server EMITS: "row"
    #                            (frame version 1) or "columnar" (v2)
    ckpt_format: str = "delta"  # eviction checkpoints: "full" snapshots
    #                            or CRC-chained "delta" links
    ckpt_compact_ops: int = 4096   # delta chain: fold into a fresh base
    #                            once ops-since-base exceed this
    ckpt_compact_links: int = 16   # ... or the chain grows this long
    trace: bool = True         # logical-clock event tracer (obs/trace)
    trace_ring: int = 512      # flight-recorder ring: last-N events
    trace_path: Optional[str] = None  # stream every event to this JSONL
    trace_rotate_bytes: Optional[int] = None  # size cap per segment
    trace_keep: bool = False   # retain the full event list in memory
    #                            (Tracer.logical_bytes reads it back)
    flow_sample_mod: int = 16  # per-op provenance: agents whose
    #                            crc32(name) % mod == 0 get flow.* spans
    #                            (1 = every span, 0 = off)
    obs_dir: Optional[str] = None  # post-mortem bundle directory; None =
    #                            $TCR_TRACE_DIR or <spool_dir>/obs
    profile_dir: Optional[str] = None  # torch.profiler capture of ticks
    #                            1..profile_ticks into this directory
    profile_ticks: int = 3     # ticks per profiler capture window
