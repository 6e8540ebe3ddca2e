"""Configuration the streaming path needs (counterpart of one piece of
``text_crdt_rust_tpu/config.py``): the blocked-lanes geometry rule."""
from __future__ import annotations


def lane_block_geometry(capacity: int, block_k: int) -> tuple:
    """Blocked-lanes geometry for a requested per-lane row capacity:
    ``(capacity, NB, NBT)`` with capacity rounded UP to a ``block_k``
    multiple (K is fixed across a stream's chunks; the growing per-chunk
    capacities of the streaming configs size NB, not K)."""
    cap = ((capacity + block_k - 1) // block_k) * block_k
    nb = cap // block_k
    return cap, nb, max(8, nb)
