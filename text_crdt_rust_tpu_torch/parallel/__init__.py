"""The port's parallel layer (counterpart of ``text_crdt_rust_tpu/parallel/``)
on ``torch.distributed``:

- ``launch``   — a world of N ranks (spawned processes, one process group,
                 a time limit on every job);
- ``mesh``     — a ``(dp, sp)`` grid of ranks with counted collectives;
                 document-batch data parallelism over ``dp`` with the flat
                 engine (F1) on each rank;
- ``sp_runs``  — the read side of one huge document's run rows sharded
                 over ``sp``: shard-local scans plus one small collective;
- ``sp_apply`` — the write side, ``SpDoc``: local and remote edits on the
                 same layout (config ``sp``'s ``sp-apply`` engine);
- ``sp_kernel`` — S1, its step program as one CUDA kernel
                 (``ops/csrc/sp_replay.cu``), and its wrappers;
- ``dryrun``   — the multi-rank dry run over all of the above;
- ``causal``   — the causal receive buffer for out-of-order remote txns.
"""
from .causal import CausalBuffer
from .mesh import make_mesh, make_sharded_apply, shard_docs, shard_ops
from .sp_apply import SpDoc, make_sp_apply
from .sp_runs import make_sp_ops, shard_runs

__all__ = [
    "CausalBuffer",
    "SpDoc",
    "make_mesh",
    "make_sharded_apply",
    "make_sp_apply",
    "make_sp_ops",
    "shard_docs",
    "shard_ops",
    "shard_runs",
]
