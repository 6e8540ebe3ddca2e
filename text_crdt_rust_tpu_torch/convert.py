"""Numpy bridges between the JAX package's state and the port's.

The JAX package's ``OpTensors`` and ``FlatDoc`` are pytrees of arrays;
their fields, each ``np.asarray``'d into a dict, carry them across to the
port without importing anything of JAX here. The replay starts from an
empty document, so the compiled op stream is what crosses: tests feed the
same stream to both packages and compare results through numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from . import resolve_device
from .ops.batch import OpTensors
from .ops.rle import RleResult
from .ops.span_arrays import FlatDoc

#: Result fields holding u32 bits (origins), compared as ``np.uint32``.
_U32_RESULT_FIELDS = ("ol", "orr")


def ops_from_numpy(fields: Dict[str, np.ndarray]) -> OpTensors:
    """An ``OpTensors`` of the port from a dict of the JAX package's
    ``OpTensors`` fields (each ``np.asarray``'d)."""
    names = [f.name for f in dataclasses.fields(OpTensors)]
    missing = set(names) - set(fields)
    if missing:
        raise ValueError(f"missing OpTensors fields: {sorted(missing)}")
    return OpTensors(**{n: np.asarray(fields[n], dtype=np.uint32)
                        for n in names})


def flat_doc_from_numpy(fields: Dict[str, np.ndarray],
                        device=None) -> FlatDoc:
    """A ``FlatDoc`` of the port from a dict of the JAX package's
    ``FlatDoc`` fields (each ``np.asarray``'d); u32 logs become int32
    tensors holding the same bits."""
    dev = resolve_device(device)

    def bits(name):
        a = np.array(fields[name], dtype=np.uint32)  # a writable copy
        return torch.from_numpy(a.view(np.int32)).to(dev)

    return FlatDoc(
        signed=torch.from_numpy(np.array(fields["signed"], np.int32)).to(dev),
        ol_log=bits("ol_log"),
        or_log=bits("or_log"),
        rank_log=bits("rank_log"),
        chars_log=bits("chars_log"),
        n=int(fields["n"]),
        next_order=int(fields["next_order"]),
    )


def rle_result_to_numpy(res: RleResult) -> Dict[str, np.ndarray]:
    """An ``RleResult``'s eight arrays on the host, origins as ``uint32``
    bit views, in the JAX package's field names."""
    out = {}
    for name in ("ordp", "lenp", "blkord", "rows", "meta", "ol", "orr",
                 "err"):
        a = getattr(res, name).cpu().numpy()
        out[name] = a.view(np.uint32) if name in _U32_RESULT_FIELDS else a
    return out
