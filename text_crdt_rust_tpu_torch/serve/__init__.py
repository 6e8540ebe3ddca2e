"""serve/ — the continuous-batching document server (counterpart of
``text_crdt_rust_tpu/serve``).

Turns the library (engines, wire codec, causal buffering, checkpoints)
into a single-process server that multiplexes thousands of live
documents onto B-lane device batches:

- ``admission``  — typed backpressure (bounded queues, token buckets);
- ``router``     — doc_id -> (shard, lane) + frames -> causal queues;
- ``batcher``    — per-tick drain -> bucketed [S, B] device pass, and
  the flat engine's lane backend (``flat``, ``ServeConfig()``'s default:
  the flat kernel, tick trains);
- ``lanes_backend`` — the blocked O(NB+K) lane backend
  (``rle-lanes-mixed``, kernel A7);
- ``residency``  — LRU lanes, checkpoint evict / restore;
- ``journal``    — the write-ahead input log crash recovery re-executes;
- ``server``     — the ``DocServer`` facade (``recover()``, the profiler
  hook);
- ``chaos``      — deterministic crash injection against uncrashed twins;
- ``loadgen``    — deterministic closed-loop load generator + checker.
"""
from .admission import (  # noqa: F401
    AdmissionControl,
    AdmissionError,
    TokenBucket,
)
from .batcher import ContinuousBatcher, make_lane_backend  # noqa: F401
from .residency import LaneResidency  # noqa: F401
from .router import DocState, ShardRouter  # noqa: F401
from .server import DocServer  # noqa: F401
