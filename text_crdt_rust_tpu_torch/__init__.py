"""text_crdt_rust_tpu_torch — the list/text CRDT replay on PyTorch and CUDA.

The PyTorch port of ``text_crdt_rust_tpu``, module for module: the same
names in the same places, so each piece has an obvious counterpart in the
JAX package it is held against. Plain tensor code is PyTorch; every
Pallas kernel of the JAX package becomes a CUDA C++ kernel for Hopper
(``ops/csrc/``), built at first use by ``ops/_kernels.py``.

Layout (this slice — the north-star local-edit replay):

- ``common``            sentinels shared by every module;
- ``utils/testdata``    the editing-trace loader;
- ``ops/batch``         the numpy op compiler (local edits, step fusion);
- ``ops/span_arrays``   ``FlatDoc``, the per-char document on tensors;
- ``ops/rle``           the RLE run-block replay, its plain PyTorch
                        version and its CUDA kernel wrapper;
- ``convert``           numpy bridges to and from the JAX package's state;
- ``northstar``         the slice's entry point (full trace × batch).

Every entry point takes ``device=None``, which means CUDA. Without a card
it raises unless the caller asked for ``device="cpu"``: the port never
falls back to the CPU by itself.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises when CUDA is asked for (explicitly or by default) and absent;
    the CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["__version__", "resolve_device"]
