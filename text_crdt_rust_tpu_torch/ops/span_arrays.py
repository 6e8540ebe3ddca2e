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

A batch of documents stacks a leading axis on every column: ``signed``
``[B, CAP]``, the logs ``[B, OCAP]``, and ``n``/``next_order`` become
``[B]`` int32 tensors on the batch's device (``stack_docs``). A single
document keeps ``n`` and ``next_order`` as Python ints.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

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
    """One (or a batch of) flattened CRDT document bodies."""

    signed: torch.Tensor      # i32[..., CAP]   ±(order+1) in doc order
    ol_log: torch.Tensor      # u32 bits[..., OCAP]  origin_left by order
    or_log: torch.Tensor      # u32 bits[..., OCAP]  origin_right by order
    rank_log: torch.Tensor    # u32 bits[..., OCAP]  author rank by order
    chars_log: torch.Tensor   # u32 bits[..., OCAP]  codepoint by order
    n: "int | torch.Tensor"   # occupied rows (live + tombstone); i32[B]
    next_order: "int | torch.Tensor"  # next dense op id; u32 bits[B]

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


def stack_docs(doc: FlatDoc, batch: int) -> FlatDoc:
    """Replicate a single doc into a batch (leading axis), each lane its
    own storage."""
    dev = doc.signed.device

    def rep(t):
        return t.unsqueeze(0).repeat((batch,) + (1,) * t.dim())

    return FlatDoc(
        signed=rep(doc.signed), ol_log=rep(doc.ol_log),
        or_log=rep(doc.or_log), rank_log=rep(doc.rank_log),
        chars_log=rep(doc.chars_log),
        n=torch.full((batch,), int(doc.n), dtype=I32, device=dev),
        next_order=torch.full((batch,), u32_bits(int(doc.next_order)),
                              dtype=I32, device=dev))


def lane(doc: FlatDoc, b: int) -> FlatDoc:
    """Lane ``b`` of a batched doc as a single doc (views of the batch's
    columns; ``n``/``next_order`` read back as ints)."""
    return FlatDoc(
        signed=doc.signed[b], ol_log=doc.ol_log[b], or_log=doc.or_log[b],
        rank_log=doc.rank_log[b], chars_log=doc.chars_log[b],
        n=int(doc.n[b]), next_order=int(doc.next_order[b]) & 0xFFFF_FFFF)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def download(doc: FlatDoc) -> dict:
    """Device -> host: per-item numpy columns in document order (the
    JAX package's ``download`` dict, key for key and dtype for dtype)."""
    n = int(doc.n)
    signed = doc.signed[:n].cpu().numpy().astype(np.int64)
    next_order = int(doc.next_order) & 0xFFFF_FFFF
    order = (np.abs(signed) - 1).astype(np.uint32)
    deleted = signed < 0
    return {
        "order": order,
        "origin_left": _u32(doc.ol_log)[order],
        "origin_right": _u32(doc.or_log)[order],
        "rank": _u32(doc.rank_log)[order],
        "chars": _u32(doc.chars_log)[order],
        "deleted": deleted,
        "next_order": next_order,
    }


def to_string(doc: FlatDoc) -> str:
    cols = download(doc)
    live = ~cols["deleted"]
    cps = cols["chars"][live]
    return cps.astype("<u4").tobytes().decode("utf-32-le")


def doc_spans(doc: FlatDoc) -> List[Tuple[int, int, int, int]]:
    """Document body as maximally RLE-merged YjsSpan tuples — the
    canonical compacted form every engine reports (predicate
    `span.rs:47-53`)."""
    from ..utils.rle import merge_yjs_spans

    cols = download(doc)
    return merge_yjs_spans(
        (int(cols["order"][i]), int(cols["origin_left"][i]),
         int(cols["origin_right"][i]), -1 if cols["deleted"][i] else 1)
        for i in range(len(cols["order"]))
    )


def upload_oracle(oracle, capacity: int, rank_of_agent: np.ndarray,
                  order_capacity: int | None = None,
                  device=None) -> FlatDoc:
    """Host oracle document -> device state (resume/warm-start path).

    ``rank_of_agent`` maps the oracle's dense agent ids to name ranks
    (see ``batch.AgentTable``)."""
    if order_capacity is None:
        order_capacity = 2 * capacity
    n = oracle.n
    next_order = oracle.get_next_order()
    if n > capacity:
        raise ValueError(
            f"doc ({n} rows) exceeds device capacity {capacity}")
    if next_order > order_capacity:
        raise ValueError(f"doc ({next_order} orders) exceeds order "
                         f"capacity {order_capacity}")
    dev = resolve_device(device)
    order = oracle.order[:n].astype(np.int64)
    signed = np.zeros(capacity, dtype=np.int32)
    signed[:n] = np.where(oracle.deleted[:n], -(order + 1), order + 1)

    def log_from(items, fill):
        out = np.full(order_capacity, fill, dtype=np.uint32)
        out[order] = items[:n]
        return out

    # Per-item author rank: one vectorized searchsorted of item orders
    # against the client_with_order run starts (`list/mod.rs:58-63`).
    run_starts = np.asarray(
        [e.order for e in oracle.client_with_order], dtype=np.int64)
    run_agents = np.asarray(
        [e.agent for e in oracle.client_with_order], dtype=np.int64)
    run_idx = np.searchsorted(run_starts, order, side="right") - 1
    ranks = np.asarray(rank_of_agent)[run_agents[run_idx]].astype(np.uint32)
    cols = [signed.view(np.uint32),
            log_from(oracle.origin_left, ROOT_ORDER),
            log_from(oracle.origin_right, ROOT_ORDER),
            log_from(ranks, 0), log_from(oracle.chars, 0)]
    # One upload for the five columns.
    flat = torch.from_numpy(np.concatenate(cols).view(np.int32))
    if dev.type == "cuda":
        flat = flat.pin_memory().to(dev, non_blocking=True)
    signed_t, ol, orr, rank, chars = torch.split(
        flat, [capacity] + [order_capacity] * 4)
    return FlatDoc(signed=signed_t, ol_log=ol, or_log=orr, rank_log=rank,
                   chars_log=chars, n=n, next_order=next_order)


def remap_ranks(rank_log: torch.Tensor, mapping) -> torch.Tensor:
    """``rank_log`` (u32 bits, any shape) through an old->new rank map:
    ranks at or beyond ``len(mapping)`` pass through unchanged (an
    unsigned compare, as the JAX package's ``remap_rank_log``)."""
    m = torch.from_numpy(
        np.asarray(mapping, dtype=np.uint32).view(np.int32).copy()
    ).to(rank_log.device)
    old = rank_log.to(torch.int64) & 0xFFFF_FFFF
    safe = torch.clamp(old, max=m.shape[0] - 1)
    return torch.where(old < m.shape[0], m[safe], rank_log)


def remap_rank_log(doc: FlatDoc, mapping) -> FlatDoc:
    """Re-base the by-order author-rank log through an old->new rank
    mapping (``batch.rank_remap``) at an agent-onboarding epoch boundary.
    Ranks at or beyond ``len(mapping)`` (never written by the old epoch)
    pass through unchanged."""
    return dataclasses.replace(doc,
                               rank_log=remap_ranks(doc.rank_log, mapping))
