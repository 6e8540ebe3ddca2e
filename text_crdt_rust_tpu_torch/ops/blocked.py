"""Block-plane helpers shared by the run replays (counterpart of
``text_crdt_rust_tpu/ops/blocked.py:55-88``), as plain PyTorch.

The archival per-character engine of that module (its Pallas kernel
``_replay_kernel``) is still to be ported; the run replay in
``ops/rle.py`` needs only these helpers.
"""
from __future__ import annotations

import torch


def _require(cond: bool, msg: str) -> None:
    """Config/capacity precheck that must fire even under ``python -O``
    (a violated precondition corrupts device state silently, no crash)."""
    if not cond:
        raise ValueError(msg)


def _lane_scalar(x2d: torch.Tensor) -> int:
    """Row-sum then lane-max: collapse a lane-replicated [rows, B] value
    to one scalar. Valid because every doc (lane) replays the same stream,
    so all lanes hold identical control state."""
    return int(x2d.sum(dim=0).max())


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the row axis, kept in the input's dtype
    (int32 wraps as the JAX roll-add scan does)."""
    return torch.cumsum(x, dim=0, dtype=x.dtype)


def _roll_amount(amount: int, max_amount: int, n: int) -> int:
    """The net roll of the JAX package's one-static-roll-per-bit shift:
    only the low ``bit_length(max_amount)`` bits of ``amount`` are read,
    and the rolls wrap modulo the row count ``n``."""
    bits = max(max_amount, 1).bit_length()
    return (amount & ((1 << bits) - 1)) % n


def _shift_rows(x: torch.Tensor, amount: int, max_amount: int) -> torch.Tensor:
    """Rows shifted toward higher indices by ``amount`` (0..max_amount).

    A CIRCULAR roll, as ``pltpu.roll`` is: the top rows wrap to the
    bottom, and every caller masks what it must not keep."""
    return torch.roll(x, _roll_amount(amount, max_amount, x.shape[0]), 0)
