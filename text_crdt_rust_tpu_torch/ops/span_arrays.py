"""Flattened document state on tensors (counterpart of
``text_crdt_rust_tpu/ops/span_arrays.py:56-133``).

Document order lives in ``signed``: position ``i`` holds ``±(order+1)``
(magnitude = dense op id, sign = tombstone, 0 = empty slot). Everything
immutable per item is kept in by-order logs (origins, author rank,
codepoint), so position -> content is a gather at readback.

Dtype convention of the port: the JAX package's u32 columns are carried
as ``torch.int32`` tensors holding the same 32 bits (torch's uint32 has
too few operators to compute with). ``ROOT_ORDER`` therefore reads as -1
in a tensor; ``download`` returns numpy ``uint32`` views, bit for bit the
JAX package's arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..common import ROOT_ORDER

I32 = torch.int32
#: u32 bits carried in an int32 tensor (see the module docstring).
U32_BITS = torch.int32


def u32_bits(value: int) -> int:
    """The int32 whose bits are the u32 ``value`` (``ROOT_ORDER`` -> -1)."""
    value &= 0xFFFF_FFFF
    return value - (1 << 32) if value >= (1 << 31) else value


@dataclasses.dataclass
class FlatDoc:
    """One flattened CRDT document body."""

    signed: torch.Tensor      # i32[CAP]   ±(order+1) in doc order; 0=empty
    ol_log: torch.Tensor      # u32 bits[OCAP]  origin_left by order
    or_log: torch.Tensor      # u32 bits[OCAP]  origin_right by order
    rank_log: torch.Tensor    # u32 bits[OCAP]  author name rank by order
    chars_log: torch.Tensor   # u32 bits[OCAP]  codepoint by order
    n: int                    # occupied rows (live + tombstone)
    next_order: int           # next dense op id (`doc.rs:55-58`)

    @property
    def capacity(self) -> int:
        return self.signed.shape[-1]

    @property
    def order_capacity(self) -> int:
        return self.ol_log.shape[-1]


def make_flat_doc(capacity: int, order_capacity: int | None = None,
                  device=None) -> FlatDoc:
    """Empty document (`doc.rs:51-64` analog).

    ``order_capacity`` bounds total orders consumed (inserts AND deletes
    take order ids, `doc.rs:155-165`); defaults to ``2 * capacity``."""
    dev = resolve_device(device)
    if order_capacity is None:
        order_capacity = 2 * capacity
    root = u32_bits(ROOT_ORDER)
    return FlatDoc(
        signed=torch.zeros(capacity, dtype=I32, device=dev),
        ol_log=torch.full((order_capacity,), root, dtype=U32_BITS, device=dev),
        or_log=torch.full((order_capacity,), root, dtype=U32_BITS, device=dev),
        rank_log=torch.zeros(order_capacity, dtype=U32_BITS, device=dev),
        chars_log=torch.zeros(order_capacity, dtype=U32_BITS, device=dev),
        n=0,
        next_order=0,
    )


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def download(doc: FlatDoc) -> dict:
    """Device -> host: per-item numpy columns in document order (the
    JAX package's ``download`` dict, key for key and dtype for dtype)."""
    n = int(doc.n)
    signed = doc.signed[:n].cpu().numpy().astype(np.int64)
    order = (np.abs(signed) - 1).astype(np.uint32)
    deleted = signed < 0
    return {
        "order": order,
        "origin_left": _u32(doc.ol_log)[order],
        "origin_right": _u32(doc.or_log)[order],
        "rank": _u32(doc.rank_log)[order],
        "chars": _u32(doc.chars_log)[order],
        "deleted": deleted,
        "next_order": int(doc.next_order),
    }


def to_string(doc: FlatDoc) -> str:
    cols = download(doc)
    live = ~cols["deleted"]
    cps = cols["chars"][live]
    return cps.astype("<u4").tobytes().decode("utf-32-le")
