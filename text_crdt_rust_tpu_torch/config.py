"""Configuration (counterpart of ``text_crdt_rust_tpu/config.py``): the
engine registry, the compiler and engine knobs, the blocked-lanes geometry
rule, the multi-rank ``MeshConfig``, the document server's ``ServeConfig``
and the examples' ``SoakConfig`` and ``StatsConfig``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

# The engine registry: the public engine name -> its implementing module
# (relative to this package), the configs that exercise it, ``fused_steps``
# (the engine's insert splice takes FUSED W-row steps, so streams compiled
# with ``fuse_w`` > 1 may run on it) and, for the document server's
# backends, ``serve_backend``, the lane backend class
# ``serve.batcher.make_lane_backend`` builds.
ENGINE_REGISTRY = {
    "rle":             {"module": "ops.rle", "configs": ("northstar", "2", "3"),
                        "fused_steps": True},
    "rle-hbm":         {"module": "ops.rle_hbm",
                        "configs": ("northstar", "kevin"),
                        "fused_steps": True},
    "rle-lanes":       {"module": "ops.rle_lanes", "configs": ("5",),
                        "fused_steps": True},
    "rle-mixed":       {"module": "ops.rle_mixed", "configs": ("4",)},
    "rle-lanes-mixed": {"module": "ops.rle_lanes_mixed",
                        "configs": ("5r", "serve", "serve-lanes"),
                        "fused_steps": True,
                        "serve_backend":
                            "serve.lanes_backend:LanesMixedLaneBackend"},
    "blocked":         {"module": "ops.blocked", "configs": ("northstar",)},
    "blocked-mixed":   {"module": "ops.blocked_mixed", "configs": ("4",)},
    "hbm":             {"module": "ops.blocked_hbm", "configs": ("northstar",)},
    "flat":            {"module": "ops.flat", "configs": ("serve",),
                        "serve_backend": "serve.batcher:FlatLaneBackend"},
    # One huge document sharded over the sp axis (config sp, ``sp.py``).
    "sp-apply":        {"module": "parallel.sp_apply", "configs": ("sp",)},
}
ENGINE_CHOICES = tuple(ENGINE_REGISTRY)

# Row labels that are not registry engine names: variants of a registry
# engine, or host baselines (None) with no device module.
ENGINE_ROW_ALIASES = {
    "rle-groups": "rle",       # config 3: rle engine, doc groups
    "rle-hbm-fused": "rle-hbm",  # kevin: fused multi-row steps
    "native-cpp": None,        # the native C++ baseline
    "gap-buffer": None,        # the text-only rope lower bound
}


def engines_for(config_key: str) -> tuple:
    """Engine names registered as valid for one config key."""
    return tuple(n for n, spec in ENGINE_REGISTRY.items()
                 if config_key in spec["configs"])


def supports_fused_steps(engine: str) -> bool:
    """True when ``engine`` (a registry name or a row alias) takes fused
    W-row insert steps: the one source to consult before compiling with
    ``fuse_w`` > 1."""
    name = ENGINE_ROW_ALIASES.get(engine, engine)
    if name is None:
        return False
    return bool(ENGINE_REGISTRY.get(name, {}).get("fused_steps", False))


@dataclasses.dataclass
class BatchConfig:
    """Op-compiler knobs (``ops.batch``), the compile-side twin of
    ``EngineConfig``.

    ``fuse_w`` is the fused insert-burst width: backwards-contiguous insert
    bursts (the kevin prepend shape) compile into steps of
    ``rows_per_step <= fuse_w`` rows. It needs a ``fused_steps`` engine and
    ``fuse_w <= block_k // 2 - 1`` (one leaf split must make room for a
    whole fused step); 1 disables fusion.
    """

    lmax: int = 16             # insert-chunk width of compiled steps
    dmax: Optional[int] = None  # per-step delete-span bound (None = off)
    fuse_w: int = 1            # fused insert-burst width (1 = unfused)


def lane_block_geometry(capacity: int, block_k: int) -> tuple:
    """Blocked-lanes geometry for a requested per-lane row capacity:
    ``(capacity, NB, NBT)`` with capacity rounded UP to a ``block_k``
    multiple (K is fixed across a stream's chunks; the growing per-chunk
    capacities of the streaming configs size NB, not K)."""
    cap = ((capacity + block_k - 1) // block_k) * block_k
    nb = cap // block_k
    return cap, nb, max(8, nb)


@dataclasses.dataclass
class EngineConfig:
    """Replay-engine knobs shared by the entry points. The device is not a
    field: every entry point takes ``device=``."""

    engine: str = "rle"        # one of ENGINE_CHOICES
    batch: int = 128           # documents in the lane dimension
    block_k: int = 256         # rows per block (rle: RUN rows)
    lanes_block_k: int = 64    # K of the blocked per-lane engines
    #                            (configs 5 and 5r)
    chunk: int = 1024          # step-count padding of a staged stream
    capacity: int = 0          # state rows; 0 = the workload's default
    lmax_cap: int = 512        # insert-chunk cap when compiling merged ops

    def add_args(self, ap: argparse.ArgumentParser) -> None:
        ap.add_argument("--engine", default=self.engine,
                        choices=ENGINE_CHOICES)
        ap.add_argument("--batch", type=int, default=self.batch)
        ap.add_argument("--block-k", type=int, default=self.block_k)
        ap.add_argument("--lanes-block-k", type=int,
                        default=self.lanes_block_k)
        ap.add_argument("--chunk", type=int, default=self.chunk)
        ap.add_argument("--capacity", type=int, default=self.capacity)


@dataclasses.dataclass
class MeshConfig:
    """Multi-rank sharding shape (``parallel.make_mesh``)."""

    n_devices: int = 8
    dp: int = 0                # 0 = derive: n_devices // sp
    sp: int = 1                # sequence/span-parallel axis

    def resolved(self) -> tuple:
        dp = self.dp or (self.n_devices // max(self.sp, 1))
        return dp, self.sp


@dataclasses.dataclass
class StreamConfig:
    """The streaming apply loop of configs 5 and 5r (``stream.py``):
    field for field the JAX package's. ``run_stream``/``run_stream_5``
    read ``resync_every``; ``checkpoint_dir`` is kept for parity and read
    nowhere, as in the JAX package."""

    resync_every: int = 1      # chunks between host<->device resyncs
    checkpoint_dir: Optional[str] = None


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


@dataclasses.dataclass
class SoakConfig:
    """``examples.soak``: the `examples/simple.rs:14-49` example."""

    edits: int = 1_000_000
    seed: int = 7
    oracle_steps: int = 2_000  # per-step-checked oracle prefix
    detailed: bool = False

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None) -> "SoakConfig":
        d = cls()
        ap = argparse.ArgumentParser(description=cls.__doc__)
        ap.add_argument("--edits", type=int, default=d.edits)
        ap.add_argument("--seed", type=int, default=d.seed)
        ap.add_argument("--oracle", type=int, default=d.oracle_steps,
                        dest="oracle_steps",
                        help="per-step-checked oracle prefix (0 = skip)")
        ap.add_argument("--detailed", action="store_true")
        a = ap.parse_args(argv)
        return cls(edits=a.edits, seed=a.seed,
                   oracle_steps=a.oracle_steps, detailed=a.detailed)


@dataclasses.dataclass
class StatsConfig:
    """``examples.stats``: the `examples/stats.rs:39-73` example."""

    trace: str = "automerge-paper"
    engine: str = "native"     # native | oracle
    detailed: bool = False

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None) -> "StatsConfig":
        d = cls()
        ap = argparse.ArgumentParser(description=cls.__doc__)
        ap.add_argument("--trace", default=d.trace)
        ap.add_argument("--engine", default=d.engine,
                        choices=("native", "oracle"))
        ap.add_argument("--detailed", action="store_true")
        a = ap.parse_args(argv)
        return cls(trace=a.trace, engine=a.engine, detailed=a.detailed)
