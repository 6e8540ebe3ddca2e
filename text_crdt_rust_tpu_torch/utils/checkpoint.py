"""Checkpoint / resume: the document state as flat numpy arrays
(counterpart of ``text_crdt_rust_tpu/utils/checkpoint.py``), including
the device ``FlatDoc`` checkpoints (``save_flat_doc``/``load_flat_doc``).

The reference implements no persistence, but its state is fully determined
by the RLE logs (client_with_order + item_orders + deletes + txns
determine the document; the range tree is a cache of their
materialization). This module makes that concrete:

- a checkpoint is one ``.npz`` of flat columns — the same arrays that are
  the host↔device wire format, so saving a document costs a
  ``np.savez`` and no re-encoding;
- agent names ride in a JSON header (names are the only strings — numeric
  ids are peer-local, `README.md:33-35`);
- resume rebuilds a ``models.oracle.ListCRDT`` bit-identically (asserted
  by tests via doc_spans/frontier/log equality), and the serve lanes
  warm-start from it (``serve/lanes_backend.upload_lane``).

Integrity (`net/` fault model applied to disk): every checkpoint carries a
CRC32 over its array contents plus a format version, and loads REFUSE
corrupted, truncated, or version-mismatched files with a typed
``CheckpointError`` — a resume must restore bit-identical state or fail
precisely, never load garbage into a serving replica.

Incremental (delta) checkpoints: a ``kind="delta"`` file
records the history since a referenced predecessor — the ops exported
by ``models.sync.export_txns_since`` from the predecessor's
``next_order``, encoded through the columnar wire format
(``net/columnar``) — so a warm save costs O(ops since last save)
instead of O(doc).  Chain integrity mirrors the wire's hard-rejection
contract: each delta names its predecessor's content CRC
(``prev_crc``) and order interval; a load walks base → deltas
verifying every link and REFUSES a stale, missing, or mismatched base
with a typed error.  Restore = load base + replay the decoded txns —
replay assigns the same orders in the same sequence the live document
did, so a chain restore is bit-identical to a full-snapshot restore.  ``CheckpointChain``
manages one document's base + links with periodic compaction.
"""
from __future__ import annotations

import json
import os
import zipfile
import zlib
from typing import Dict, List, Optional

import numpy as np

from .rle import (
    KCRDTSpan,
    KDeleteEntry,
    KDoubleDelete,
    KOrderSpan,
    TxnSpan,
)

# v2 added the content CRC32 (zlib) to the meta header; v3 adds the
# ``next_order`` meta (the delta-chain anchor) and the ``delta`` kind.
# Older versions are refused — re-save from a live document.
FORMAT_VERSION = 3


class CheckpointError(Exception):
    """A checkpoint failed to load: corrupted, truncated, or wrong
    format version. The file is refused whole — no partial state."""


def _meta_to_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)


def _meta_from_array(arr: np.ndarray) -> dict:
    return json.loads(arr.tobytes().decode("utf-8"))


def _content_crc(arrays: Dict[str, np.ndarray]) -> int:
    """CRC32 over every array's raw bytes, key-sorted (stable across
    save/load regardless of npz member order). ``zlib.crc32`` (C speed)
    rather than the wire codec's pure-Python CRC32C: checkpoints are
    MB-to-GB arrays where the table loop would cost ~0.25 s/MiB on
    every save AND load; the integrity guarantee is the same."""
    crc = 0
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        crc = zlib.crc32(a.tobytes(), crc)
    return crc & 0xFFFF_FFFF


def _save_npz(path: str, meta: dict, arrays: Dict[str, np.ndarray]) -> int:
    """Write one checkpoint member file; returns its content CRC (the
    chain-link identity delta checkpoints reference)."""
    meta = dict(meta)
    crc = meta["crc"] = _content_crc(arrays)
    np.savez(path, meta=_meta_to_array(meta), **arrays)
    return crc


def _load_npz(path: str, expect_kind: str):
    """Open + fully validate a checkpoint; returns (meta, {key: array}).

    Raises ``CheckpointError`` on anything short of a bit-perfect file:
    unreadable/truncated zip, missing members, undecodable meta, version
    or kind mismatch, or content CRC mismatch.
    """
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    except (OSError, EOFError, ValueError, KeyError,
            NotImplementedError, zipfile.BadZipFile) as e:
        # NotImplementedError: zipfile refuses exotic flag bits a
        # corrupting flip can set (e.g. "compressed patched data") —
        # still a corrupt file, still a typed refusal.
        raise CheckpointError(f"unreadable checkpoint {path!r}: {e}") from e
    if "meta" not in arrays:
        raise CheckpointError(f"checkpoint {path!r} has no meta header")
    try:
        meta = _meta_from_array(arrays.pop("meta"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CheckpointError(
            f"checkpoint {path!r}: undecodable meta header: {e}") from e
    version = meta.get("version")
    if version != FORMAT_VERSION:
        raise CheckpointError(
            f"checkpoint {path!r}: format version {version!r}, "
            f"this build reads {FORMAT_VERSION}")
    if meta.get("kind", "oracle") != expect_kind:
        raise CheckpointError(
            f"checkpoint {path!r}: kind {meta.get('kind', 'oracle')!r}, "
            f"expected {expect_kind!r}")
    stored = meta.get("crc")
    computed = _content_crc(arrays)
    if stored != computed:
        raise CheckpointError(
            f"checkpoint {path!r}: content CRC mismatch "
            f"(stored {stored!r}, computed {computed:#010x}) — "
            f"file corrupted, refusing to load")
    return meta, arrays


def save_doc(doc, path: str, extra_meta: Optional[dict] = None) -> dict:
    """Serialize an oracle ``ListCRDT`` to ``path`` (.npz).

    Returns ``{"crc", "next_order", "bytes"}`` — what a delta chain
    needs to reference this file as its base.

    ``extra_meta`` rides in the JSON header under caller-chosen keys
    (the serve tier stores its doc id and local-edit replay watermark
    there).  Loads ignore unknown meta keys, so extra meta is
    backward- and forward-compatible without a FORMAT_VERSION bump;
    core keys cannot be overridden."""
    n = doc.n
    cwo = list(doc.client_with_order)
    deletes = list(doc.deletes)
    dds = list(doc.double_deletes)
    txns = list(doc.txns)
    item_orders = [
        (a, e.seq, e.order, e.length)
        for a, cd in enumerate(doc.client_data)
        for e in cd.item_orders
    ]
    parents = [
        (i, p) for i, t in enumerate(txns) for p in t.parents
    ]
    meta = dict(extra_meta or {})
    meta.update({
        "version": FORMAT_VERSION,
        "kind": "oracle",
        "agents": [cd.name for cd in doc.client_data],
        "n": n,
        "next_order": doc.get_next_order(),
    })
    arrays = dict(
        order=doc.order[:n],
        origin_left=doc.origin_left[:n],
        origin_right=doc.origin_right[:n],
        deleted=doc.deleted[:n],
        chars=doc.chars[:n],
        frontier=np.asarray(doc.frontier, dtype=np.uint32),
        cwo=np.asarray([(e.order, e.agent, e.seq, e.length) for e in cwo],
                       dtype=np.int64).reshape(-1, 4),
        item_orders=np.asarray(item_orders, dtype=np.int64).reshape(-1, 4),
        deletes=np.asarray([(e.op_order, e.target, e.length)
                            for e in deletes],
                           dtype=np.int64).reshape(-1, 3),
        double_deletes=np.asarray([(e.target, e.length, e.excess)
                                   for e in dds],
                                  dtype=np.int64).reshape(-1, 3),
        txns=np.asarray([(t.order, t.length, t.shadow) for t in txns],
                        dtype=np.int64).reshape(-1, 3),
        txn_parents=np.asarray(parents, dtype=np.int64).reshape(-1, 2),
    )
    crc = _save_npz(path, meta, arrays)
    return {"crc": crc, "next_order": meta["next_order"],
            "bytes": os.path.getsize(path)}


def load_doc(path: str):
    """Rebuild an oracle ``ListCRDT`` from a ``save_doc`` checkpoint.

    Raises ``CheckpointError`` if the file is corrupted, truncated, or a
    different format version — never returns partial state.
    """
    return _load_doc_with_meta(path)[0]


def _load_doc_with_meta(path: str):
    """``(doc, meta)`` from one validated read — chain restores need the
    base's CRC/next_order without re-reading and re-checksumming the
    whole O(doc) file."""
    meta, z = _load_npz(path, expect_kind="oracle")
    try:
        n = int(meta["n"])
        agents = meta["agents"]
    except (KeyError, TypeError, ValueError) as e:
        raise CheckpointError(f"checkpoint {path!r}: bad meta: {e}") from e

    try:
        return _rebuild_oracle(z, n, agents), meta
    except (KeyError, ValueError, IndexError) as e:
        raise CheckpointError(
            f"checkpoint {path!r}: inconsistent contents: {e}") from e


def _rebuild_oracle(z, n: int, agents):
    from ..models.oracle import ClientData, ListCRDT

    doc = ListCRDT(capacity=max(n, 64))
    doc.n = n
    doc.order[:n] = z["order"]
    doc.origin_left[:n] = z["origin_left"]
    doc.origin_right[:n] = z["origin_right"]
    doc.deleted[:n] = z["deleted"]
    doc.chars[:n] = z["chars"]
    doc.rebuild_raw_index()  # the body was set directly, not spliced
    doc.frontier = [int(o) for o in z["frontier"]]

    doc.client_data = [ClientData(name) for name in agents]
    for a, seq, order, length in z["item_orders"]:
        doc.client_data[int(a)].item_orders.append(
            KOrderSpan(int(seq), int(order), int(length)))
    for order, agent, seq, length in z["cwo"]:
        doc.client_with_order.append(
            KCRDTSpan(int(order), int(agent), int(seq), int(length)))
    for op_order, target, length in z["deletes"]:
        doc.deletes.append(
            KDeleteEntry(int(op_order), int(target), int(length)))
    for target, length, excess in z["double_deletes"]:
        doc.double_deletes.append(
            KDoubleDelete(int(target), int(length), int(excess)))
    parents_by_txn: List[List[int]] = [[] for _ in range(len(z["txns"]))]
    for i, p in z["txn_parents"]:
        parents_by_txn[int(i)].append(int(p))
    for (order, length, shadow), ps in zip(z["txns"], parents_by_txn):
        doc.txns.append(TxnSpan(int(order), int(length), int(shadow), ps))
    return doc


# -- incremental (delta) checkpoints -----------------------------------------

def save_delta(doc, path: str, *, base_crc: int, prev_crc: int,
               from_order: int, extra_meta: Optional[dict] = None) -> dict:
    """Write the history ``from_order..`` as one delta link at ``path``.

    ``prev_crc`` names the immediate predecessor file (the base for the
    first link, the previous delta after that) and ``base_crc`` the
    chain's base — both are content CRCs, so a link can never be
    replayed onto the wrong snapshot.  The ops ride as a columnar wire
    stream (``net/columnar.encode_txns_stream``): the save costs
    O(ops since ``from_order``), not O(doc).
    """
    from ..models.sync import export_txns_since
    from ..net import columnar

    next_order = doc.get_next_order()
    if from_order > next_order:
        raise CheckpointError(
            f"delta from_order {from_order} is ahead of the document "
            f"({next_order}) — stale chain state, re-save a full base")
    blob = columnar.encode_txns_stream(export_txns_since(doc, from_order))
    meta = dict(extra_meta or {})
    meta.update({
        "version": FORMAT_VERSION,
        "kind": "delta",
        "base_crc": int(base_crc),
        "prev_crc": int(prev_crc),
        "from_order": int(from_order),
        "next_order": int(next_order),
    })
    arrays = dict(txns_blob=np.frombuffer(blob, dtype=np.uint8))
    crc = _save_npz(path, meta, arrays)
    return {"crc": crc, "next_order": next_order,
            "ops": next_order - from_order,
            "bytes": os.path.getsize(path)}


def load_delta(path: str):
    """Load + fully validate one delta link; returns
    ``(meta, [RemoteTxn])``. Corruption anywhere — file, meta, or the
    embedded wire stream — is a typed ``CheckpointError``."""
    from ..net import codec

    meta, arrays = _load_npz(path, expect_kind="delta")
    for key in ("base_crc", "prev_crc", "from_order", "next_order"):
        if not isinstance(meta.get(key), int):
            raise CheckpointError(
                f"delta checkpoint {path!r}: missing/invalid {key!r} meta")
    blob = bytes(arrays["txns_blob"].tobytes()) \
        if "txns_blob" in arrays else None
    if blob is None:
        raise CheckpointError(
            f"delta checkpoint {path!r} has no txns_blob member")
    txns: List = []
    try:
        for kind, value in codec.decode_frames(blob):
            if kind != codec.KIND_TXNS:
                raise CheckpointError(
                    f"delta checkpoint {path!r}: non-TXNS frame in blob")
            txns.extend(value)
    except codec.CodecError as e:
        raise CheckpointError(
            f"delta checkpoint {path!r}: corrupt txn stream: {e}") from e
    return meta, txns


def replay_chain(base_path: str, delta_paths: List[str]):
    """Restore a document from ``base`` + delta links, verifying every
    chain invariant: each link's ``prev_crc`` must equal the content CRC
    of its predecessor file, ``base_crc`` the base's, and the order
    intervals must tile ``base.next_order..`` exactly.  Replay applies
    the decoded txns in stream order — order assignment is sequential,
    so the restored document is the one the live replica held.
    """
    return replay_chain_with_meta(base_path, delta_paths)[0]


def replay_chain_with_meta(base_path: str, delta_paths: List[str]):
    """``replay_chain`` that also returns the TIP file's meta header
    (the last link's, or the base's for a link-less chain) — where the
    serve tier's extra meta (doc id, local-edit replay watermark) rides
    at its freshest."""
    doc, base_meta = _load_doc_with_meta(base_path)
    tip_meta = base_meta
    base_crc = base_meta["crc"]
    prev_crc = base_crc
    cursor = int(base_meta.get("next_order", 0))
    for link_path in delta_paths:
        meta, txns = load_delta(link_path)
        if meta["base_crc"] != base_crc:
            raise CheckpointError(
                f"delta {link_path!r} references base crc "
                f"{meta['base_crc']:#010x}, chain base is {base_crc:#010x} "
                f"— stale or foreign base, refusing to replay")
        if meta["prev_crc"] != prev_crc:
            raise CheckpointError(
                f"delta {link_path!r} references predecessor crc "
                f"{meta['prev_crc']:#010x}, got {prev_crc:#010x} — "
                f"broken chain, refusing to replay")
        if meta["from_order"] != cursor:
            raise CheckpointError(
                f"delta {link_path!r} starts at order {meta['from_order']}, "
                f"chain cursor is {cursor} — missing or reordered link")
        try:
            for txn in txns:
                doc.apply_remote_txn(txn)
        except (AssertionError, KeyError, ValueError, IndexError) as e:
            raise CheckpointError(
                f"delta {link_path!r}: replay failed: {e}") from e
        if doc.get_next_order() != meta["next_order"]:
            raise CheckpointError(
                f"delta {link_path!r}: replay landed at order "
                f"{doc.get_next_order()}, link claims {meta['next_order']}")
        prev_crc = meta["crc"]
        cursor = meta["next_order"]
        tip_meta = meta
    return doc, tip_meta


class CheckpointChain:
    """One document's base + delta links with periodic compaction.

    ``save(doc)`` writes a delta link when the chain is warm and small,
    or folds everything into a fresh base once the chain carries more
    than ``compact_ops`` ops or ``compact_links`` links (restore cost
    and directory clutter stay bounded).  ``load()`` replays the chain
    with full integrity checking.  File layout: ``<stem>.base.npz`` +
    ``<stem>.d<k>.npz``.
    """

    def __init__(self, stem: str, *, compact_ops: int = 4096,
                 compact_links: int = 16):
        self.stem = stem
        self.compact_ops = max(1, compact_ops)
        self.compact_links = max(1, compact_links)
        self.base_path = f"{stem}.base.npz"
        self.base_info: Optional[dict] = None
        self.links: List[dict] = []   # {"path", "crc", "next_order", ...}

    @property
    def next_order(self) -> Optional[int]:
        if self.links:
            return self.links[-1]["next_order"]
        return self.base_info["next_order"] if self.base_info else None

    def _link_path(self) -> str:
        return f"{self.stem}.d{len(self.links):04d}.npz"

    @classmethod
    def from_disk(cls, stem: str, *, compact_ops: int = 4096,
                  compact_links: int = 16):
        """Rebuild chain state from files on disk (crash recovery: the
        in-memory ``base_info``/``links`` died with the process).

        Returns ``(chain, refused, tip_meta)`` where ``refused`` lists
        the link paths dropped for failing validation — a torn tail
        link truncates the chain to its valid prefix (the journal
        replays the rest), and the next ``save`` overwrites the
        refused file — and ``tip_meta`` is the newest VALID file's meta
        header (where serve-tier extra meta rides).  A corrupt or
        absent BASE is a typed ``CheckpointError``: with no base, no
        prefix of the chain is restorable.
        """
        chain = cls(stem, compact_ops=compact_ops,
                    compact_links=compact_links)
        base_meta, _ = _load_npz(chain.base_path, expect_kind="oracle")
        tip_meta = base_meta
        chain.base_info = {
            "crc": base_meta["crc"],
            "next_order": int(base_meta.get("next_order", 0)),
            "bytes": os.path.getsize(chain.base_path),
        }
        refused: List[str] = []
        prev_crc = base_meta["crc"]
        cursor = chain.base_info["next_order"]
        k = 0
        while True:
            path = f"{stem}.d{k:04d}.npz"
            if not os.path.exists(path):
                break
            try:
                meta, _txns = load_delta(path)
                if (meta["base_crc"] != chain.base_info["crc"]
                        or meta["prev_crc"] != prev_crc
                        or meta["from_order"] != cursor):
                    raise CheckpointError(
                        f"delta {path!r}: chain linkage mismatch")
            except CheckpointError:
                # Valid-prefix recovery: this link (and anything after
                # it) is unusable; the journal suffix covers the gap.
                refused.append(path)
                break
            chain.links.append({
                "path": path, "crc": meta["crc"],
                "next_order": meta["next_order"],
                "ops": meta["next_order"] - meta["from_order"],
                "bytes": os.path.getsize(path),
            })
            prev_crc = meta["crc"]
            cursor = meta["next_order"]
            tip_meta = meta
            k += 1
        return chain, refused, tip_meta

    def save(self, doc, extra_meta: Optional[dict] = None) -> dict:
        """Checkpoint ``doc``; returns ``{"kind", "bytes", "ops"}`` —
        what the residency layer's byte counters record.

        An unchanged doc (tip already == ``next_order`` — e.g. a
        restore-for-read immediately re-evicted) writes NOTHING and
        returns kind ``"noop"``: the existing chain already restores
        this exact state, and an empty link per idle evict would walk
        the chain toward a pointless full-base compaction."""
        tip = self.next_order
        if tip is not None and tip == doc.get_next_order():
            return {"kind": "noop", "bytes": 0, "ops": 0}
        ops_since_base = (doc.get_next_order() - self.base_info["next_order"]
                          if self.base_info else None)
        fresh = (
            self.base_info is None
            or tip is None or tip > doc.get_next_order()
            or ops_since_base > self.compact_ops
            or len(self.links) >= self.compact_links
        )
        if fresh:
            for link in self.links:
                if os.path.exists(link["path"]):
                    os.remove(link["path"])
            self.links = []
            self.base_info = save_doc(doc, self.base_path,
                                      extra_meta=extra_meta)
            return {"kind": "full", "bytes": self.base_info["bytes"],
                    "ops": self.base_info["next_order"]}
        path = self._link_path()
        prev_crc = self.links[-1]["crc"] if self.links \
            else self.base_info["crc"]
        info = save_delta(doc, path, base_crc=self.base_info["crc"],
                          prev_crc=prev_crc, from_order=tip,
                          extra_meta=extra_meta)
        info["path"] = path
        self.links.append(info)
        return {"kind": "delta", "bytes": info["bytes"], "ops": info["ops"]}

    def load(self):
        """Restore the chained document (typed refusal on any broken
        link)."""
        return self.load_with_meta()[0]

    def load_with_meta(self):
        """``(doc, tip_meta)`` — the restored document plus the tip
        file's meta header (freshest extra meta)."""
        if self.base_info is None:
            raise CheckpointError(f"chain {self.stem!r} has no base")
        return replay_chain_with_meta(
            self.base_path, [link["path"] for link in self.links])


def save_flat_doc(flat, path: str) -> None:
    """Checkpoint a device ``FlatDoc`` (downloads once). Accepts a single
    doc or a ``stack_docs`` batch (leading doc axis on every column,
    including ``n``/``next_order``). The arrays and their dtypes are the
    JAX package's: ``signed``/``n`` int32, the logs and ``next_order``
    uint32."""
    import torch

    def u32(t):
        return np.asarray(t.cpu().numpy()).view(np.uint32)

    nxt = flat.next_order
    if isinstance(nxt, torch.Tensor):
        next_order = u32(nxt.to(torch.int32))
    else:
        next_order = np.asarray(int(nxt) & 0xFFFF_FFFF, dtype=np.uint32)
    n = flat.n
    arrays = dict(
        signed=flat.signed.cpu().numpy(),
        ol_log=u32(flat.ol_log),
        or_log=u32(flat.or_log),
        rank_log=u32(flat.rank_log),
        chars_log=u32(flat.chars_log),
        n=(n.cpu().numpy().astype(np.int32) if isinstance(n, torch.Tensor)
           else np.asarray(int(n), dtype=np.int32)),
        next_order=next_order,
    )
    _save_npz(path, {"version": FORMAT_VERSION, "kind": "flat"}, arrays)


def load_flat_doc(path: str, device=None):
    """Rebuild a ``FlatDoc`` from a ``save_flat_doc`` checkpoint on
    ``device`` (as ``resolve_device``): a single doc keeps ``n`` and
    ``next_order`` as ints, a batch as int32 tensors.

    Raises ``CheckpointError`` on corruption/truncation/version mismatch.
    """
    _, z = _load_npz(path, expect_kind="flat")
    try:
        return _rebuild_flat(z, device)
    except (KeyError, ValueError, IndexError) as e:
        raise CheckpointError(
            f"checkpoint {path!r}: inconsistent contents: {e}") from e


def _rebuild_flat(z, device):
    import torch

    from .. import resolve_device
    from ..ops.span_arrays import FlatDoc

    dev = resolve_device(device)

    def bits(name):
        a = np.array(z[name], dtype=np.uint32)
        return torch.from_numpy(a.view(np.int32)).to(dev)

    n = np.asarray(z["n"], dtype=np.int32)
    nxt = np.asarray(z["next_order"], dtype=np.uint32)
    batched = n.ndim == 1
    return FlatDoc(
        signed=torch.from_numpy(np.array(z["signed"], np.int32)).to(dev),
        ol_log=bits("ol_log"), or_log=bits("or_log"),
        rank_log=bits("rank_log"), chars_log=bits("chars_log"),
        n=torch.from_numpy(n.copy()).to(dev) if batched else int(n),
        next_order=(bits("next_order") if batched else int(nxt)))
