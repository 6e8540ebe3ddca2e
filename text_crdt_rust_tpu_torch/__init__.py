"""text_crdt_rust_tpu_torch — the list/text CRDT replay on PyTorch and CUDA.

The PyTorch port of ``text_crdt_rust_tpu``, module for module: the same
names in the same places, so each piece has an obvious counterpart in the
JAX package it is held against. Plain tensor code is PyTorch; every
Pallas kernel of the JAX package becomes a CUDA C++ kernel for Hopper
(``ops/csrc/``), built at first use by ``ops/_kernels.py``.

Layout (the north-star local-edit replay on run and character blocks,
kevin, the config-4 storm and the streaming configs 5r and 5):

- ``common``            sentinels and the remote-txn dataclasses;
- ``utils/testdata``    the editing-trace loader;
- ``utils/rle``         flat RLE vectors (the oracle's logs);
- ``utils/randedit``    seeded edit streams and the storm generator;
- ``models/oracle``     the host oracle document (``ListCRDT``);
- ``models/sync``       txn export from an oracle document;
- ``ops/batch``         the numpy op compiler (local edits, step fusion,
                        remote txns);
- ``ops/span_arrays``   ``FlatDoc``, the per-char document on tensors;
- ``ops/rle``           the RLE run-block replay, its plain PyTorch
                        version and its CUDA kernel wrapper;
- ``ops/rle_hbm``       the run-block replay with its planes in device
                        memory and a two-level live index (millions of
                        run rows), plain version and CUDA kernel wrapper;
- ``ops/rle_mixed``     the mixed local/remote run replay (YATA
                        integrate, interval deletes), plain version and
                        CUDA kernel wrapper;
- ``ops/rle_lanes``     per-lane local replays (divergent documents),
                        un-blocked and blocked, plain versions and CUDA
                        kernel wrappers;
- ``ops/rle_lanes_mixed`` per-lane mixed replays, likewise;
- ``ops/blocked``       the per-character block replay (one row per
                        character, the document in shared memory), plain
                        version and CUDA kernel wrapper, and the block
                        helpers every replay shares;
- ``ops/blocked_hbm``   the per-character block replay with the rows in
                        device memory (the full trace), likewise;
- ``ops/blocked_mixed`` the per-character block replay of mixed
                        local/remote streams, likewise;
- ``convert``           numpy bridges to and from the JAX package's state;
- ``northstar``         entry point: a full trace × batch, on ``rle``,
                        ``rle-hbm``, ``blocked`` or ``hbm``;
- ``kevin``             entry point: millions of single-char prepends ×
                        batch on ``rle-hbm``;
- ``storm``             entry point: the config-4 storm × batch, on
                        ``rle-mixed`` or ``blocked-mixed``;
- ``stream``            entry point: configs 5r and 5, thousands of
                        divergent documents chunk after chunk.

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
