"""Numpy bridges between the JAX package's state and the port's.

The JAX package's ``OpTensors`` and ``FlatDoc`` are pytrees of arrays;
their fields, each ``np.asarray``'d into a dict, carry them across to the
port without importing anything of JAX here. The replay starts from an
empty document, so the compiled op stream is what crosses: tests feed the
same stream to both packages and compare results through numpy. Remote
transactions cross as ``dataclasses.asdict`` dicts (``txns_from_dicts``).

The per-lane engines carry device state across chunks: the local
engines' 3-tuple ``(ordp, lenp, rows)`` (un-blocked) and 6-tuple
``(ordp, lenp, nlog, blkord, rws, liv)`` (blocked), the mixed engines'
5-tuple ``(ordp, lenp, rows, oll, orl)`` and 11-tuple
(``BlockedLanesMixedResult.STATE_KEYS``). ``lanes_state_to_numpy`` /
``lanes_state_from_numpy`` carry any of them across as a dict of int32
arrays, so a state the JAX package left can warm-start the port's next
chunk, and back. ``lane_backend_to_numpy`` / ``lane_backend_from_numpy``
do the same for a serve ``LanesMixedLaneBackend``: the 11-tuple plus its
host mirrors (the rank table, the run-row bound, the fresh-lane marks)
and the last tick's exact row counts. ``sp_doc_from_numpy`` loads an
``SpDoc``'s gathered planes (the JAX ``SpDoc``'s global arrays) into the
port's shards as they are, so both packages continue one document from the
same mid-stream state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from . import resolve_device
from .common import RemoteDel, RemoteId, RemoteIns, RemoteTxn
from .ops.batch import OpTensors
from .ops.blocked import BlockedResult
from .ops.rle import RleResult
from .ops.rle_lanes import BlockedLanesResult, LanesResult
from .ops.rle_lanes_mixed import BlockedLanesMixedResult
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


def _remote_id(d) -> RemoteId:
    return RemoteId(agent=d["agent"], seq=int(d["seq"]))


def txns_from_dicts(dicts) -> List[RemoteTxn]:
    """The port's ``RemoteTxn``s from ``dataclasses.asdict`` of the JAX
    package's (an insert op carries ``ins_content``, a delete ``len``)."""
    out = []
    for d in dicts:
        ops = []
        for op in d["ops"]:
            if "ins_content" in op:
                ops.append(RemoteIns(
                    origin_left=_remote_id(op["origin_left"]),
                    origin_right=_remote_id(op["origin_right"]),
                    ins_content=op["ins_content"]))
            else:
                ops.append(RemoteDel(id=_remote_id(op["id"]),
                                     len=int(op["len"])))
        out.append(RemoteTxn(id=_remote_id(d["id"]),
                             parents=[_remote_id(p) for p in d["parents"]],
                             ops=ops))
    return out


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
    bit views, in the JAX package's field names. A result replayed with
    ``store_origins=False`` (``ops/rle_hbm.py``) carries ``ol``/``orr`` of
    0 steps, as ``uint32 [0, B]`` arrays like the JAX package's."""
    out = {}
    for name in ("ordp", "lenp", "blkord", "rows", "meta", "ol", "orr",
                 "err"):
        a = getattr(res, name).cpu().numpy()
        out[name] = a.view(np.uint32) if name in _U32_RESULT_FIELDS else a
    return out


#: An ``RleMixedResult`` has the same eight arrays (its ``err`` row 2 is
#: the order-index miss flag).
rle_mixed_result_to_numpy = rle_result_to_numpy


def blocked_result_to_numpy(res: BlockedResult) -> Dict[str, np.ndarray]:
    """A ``BlockedResult``'s five arrays (``signed``, ``rows``, ``ol``,
    ``orr``, ``err``) on the host, origins as ``uint32`` bit views, in the
    JAX package's field names."""
    out = {}
    for name in ("signed", "rows", "ol", "orr", "err"):
        a = getattr(res, name).cpu().numpy()
        out[name] = a.view(np.uint32) if name in _U32_RESULT_FIELDS else a
    return out


#: ``state()`` keys of the per-lane engines, by tuple length.
LANES_STATE_KEYS = {
    3: LanesResult.STATE_KEYS,
    5: ("ordp", "lenp", "rows", "oll", "orl"),
    6: BlockedLanesResult.STATE_KEYS,
    11: BlockedLanesMixedResult.STATE_KEYS,
}


def lanes_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """A per-lane engine's ``state()`` tuple (the port's tensors or the JAX
    package's arrays) as a dict of int32 numpy arrays."""
    keys = LANES_STATE_KEYS[len(state)]
    out = {}
    for k, a in zip(keys, state):
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        out[k] = np.array(a, dtype=np.int32)
    return out


def lanes_state_from_numpy(fields: Dict[str, np.ndarray],
                           device=None) -> tuple:
    """The port's ``state()`` tuple from such a dict (3, 5, 6 or 11
    arrays), as int32 tensors on ``device``: the ``init`` of the next
    chunk."""
    dev = resolve_device(device)
    keys = next(ks for ks in LANES_STATE_KEYS.values()
                if set(ks) == set(fields))
    return tuple(torch.from_numpy(np.array(fields[k], dtype=np.int32))
                 .to(dev) for k in keys)


def lane_backend_to_numpy(backend) -> Dict[str, np.ndarray]:
    """Either package's ``serve.lanes_backend.LanesMixedLaneBackend`` as a
    dict of numpy arrays: its carried 11-tuple, the host mirrors ``rkl``,
    ``lane_rows`` and ``resident_fresh``, and ``prev_rows`` — the last
    tick's exact per-lane row counts, which its next ``apply`` re-bases
    the run-row bound on (absent before the first tick)."""
    out = lanes_state_to_numpy(backend._state)
    out["rkl"] = np.array(backend._rkl, dtype=np.int32)
    out["lane_rows"] = np.array(backend._lane_rows, dtype=np.int64)
    out["resident_fresh"] = np.array(backend._resident_fresh, dtype=bool)
    prev = backend._prev_res
    if prev is not None:
        rows = prev.rows
        if isinstance(rows, torch.Tensor):
            rows = rows.cpu()
        out["prev_rows"] = np.array(rows, dtype=np.int32)
    return out


def lane_backend_from_numpy(backend, fields: Dict[str, np.ndarray]) -> None:
    """Load such a dict into the port's lanes ``backend`` in place, on its
    device: its next tick continues where the dumped backend's would."""
    keys = LANES_STATE_KEYS[11]
    backend._state = lanes_state_from_numpy(
        {k: fields[k] for k in keys}, device=backend.device)
    backend._rkl = np.array(fields["rkl"], dtype=np.int32)
    backend._lane_rows = np.array(fields["lane_rows"], dtype=np.int64)
    backend._resident_fresh = np.array(fields["resident_fresh"], dtype=bool)
    prev = fields.get("prev_rows")
    backend._prev_rows = (None if prev is None else torch.from_numpy(
        np.array(prev, dtype=np.int32)).to(backend.device))
    backend._prev_res = backend._prev_token = None
    backend._prev_checked = True


#: An ``SpDoc``'s gathered planes (``SpDoc.planes()``, the JAX ``SpDoc``'s
#: global arrays) and the rows a shard each holds.
SP_PLANES = {"ordp": "R", "lenp": "R", "rows": 1, "oll": "OTS",
             "orl": "OTS", "rkl": "OTS"}


def sp_doc_from_numpy(doc, planes: Dict[str, np.ndarray], ol_log=None,
                      or_log=None) -> None:
    """Load either package's gathered ``SpDoc`` state (``ordp``/``lenp``
    ``[sp * R]``, ``rows`` ``[sp]``, ``oll``/``orl``/``rkl`` ``[sp * OTS]``,
    int32; the JAX ``SpDoc``'s global arrays) into the port's ``doc``
    exactly: this rank's shard of each, its rows past ``rows`` and its
    table slice as they are (``SpDoc.load`` re-packs evenly instead), on
    the mesh's device; and the origin logs when given. Every rank of the
    group calls it with the same arrays."""
    s = doc.mesh.index("sp")
    sizes = {"R": doc.R, "OTS": doc.OTS, 1: 1}
    for name, size in SP_PLANES.items():
        n = sizes[size]
        a = np.asarray(planes[name]).astype(np.int32).reshape(-1)
        if a.shape != (doc.nsp * n,):
            raise ValueError(f"{name} holds {a.shape[0]} entries, not "
                             f"{doc.nsp} x {n}")
        setattr(doc, name, torch.from_numpy(a[s * n:(s + 1) * n].copy())
                .to(doc.mesh.device))
    if ol_log is not None:
        doc.ol_log = {int(k): int(v) for k, v in ol_log.items()}
    if or_log is not None:
        doc.or_log = {int(k): int(v) for k, v in or_log.items()}
