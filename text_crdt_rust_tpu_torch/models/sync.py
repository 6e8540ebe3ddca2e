"""Peer synchronization: export local history as ``RemoteTxn``s and merge
(counterpart of ``text_crdt_rust_tpu/models/sync.py``).

Exports a document's history since an order watermark, merges another
peer's history (skipping already-known (agent, seq) ranges and splitting
partially-known spans), and derives the peer-portable progress vector and
state digest the wire's DIGEST frames carry. All ids cross this boundary
as (agent-name string, seq) pairs because numeric agent ids and orders
are peer-local (`doc.rs:236-240`).
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Set

from ..common import (
    CLIENT_INVALID,
    RemoteDel,
    RemoteId,
    RemoteIns,
    RemoteTxn,
    split_txn_suffix,
    txn_len,
)
from .oracle import ListCRDT


def export_txns_since(doc: ListCRDT, start_order: int = 0) -> List[RemoteTxn]:
    """All history with order >= ``start_order`` as RemoteTxns, in order.

    Txn spans are split on agent boundaries (the txns RLE can merge linear
    history across agents, `txn.rs:38-42`) and re-derive per-run ops from the
    logs: a delete-op order range is found in the deletes log
    (`list/mod.rs:82-84`); anything else is an insert run whose implicit
    origin chain (`span.rs:9-18`) bounds the run.
    """
    out: List[RemoteTxn] = []
    end_order = doc.get_next_order()
    if start_order >= end_order:
        # Idle hot path: a session polls this every tick — don't build
        # the O(n) index when there is nothing to export.
        return out
    # One pass over the body: order -> raw index (avoids a per-char scan).
    idx_of = {int(doc.order[i]): i for i in range(doc.n)}
    o = start_order
    while o < end_order:
        txn_found = doc.txns.find(o)
        assert txn_found is not None, f"no txn covering order {o}"
        txn_entry, txn_off = txn_found
        txn_end = txn_entry.order + txn_entry.length
        # Split on agent span boundaries too.
        cwo_found = doc.client_with_order.find(o)
        assert cwo_found is not None
        cwo_entry, cwo_off = cwo_found
        cwo_end = cwo_entry.order + cwo_entry.length
        sub_end = min(txn_end, cwo_end)

        agent_name = doc.get_agent_name(cwo_entry.agent)
        seq0 = cwo_entry.seq + cwo_off
        if txn_off == 0:
            parents = [doc.order_to_remote_id(p) for p in txn_entry.parents]
        else:
            # Interior of a merged linear span: parent is the previous op.
            parents = [doc.order_to_remote_id(o - 1)]

        ops: List = []
        pos = o
        while pos < sub_end:
            del_found = doc.deletes.find(pos)
            if del_found is not None:
                de, de_off = del_found
                take = min(de.op_order + de.length, sub_end) - pos
                # Split the target run at our client_with_order span
                # boundaries: a (agent, seq) range is only portable as one
                # RemoteDel if it was assigned orders as one run (the
                # reference's implicit "contiguous from a single client"
                # constraint, `list/mod.rs` OpExternal comment).
                t0 = de.target + de_off
                t_found = doc.client_with_order.find(t0)
                assert t_found is not None
                t_entry, t_off = t_found
                take = min(take, t_entry.length - t_off)
                ops.append(RemoteDel(
                    id=doc.order_to_remote_id(t0),
                    len=take,
                ))
                pos += take
            else:
                # Insert run: orders pos.. while the implicit origin chain
                # holds and items exist in the body.
                i0 = idx_of.get(pos)
                assert i0 is not None, f"order {pos} neither delete nor insert"
                origin_left = int(doc.origin_left[i0])
                origin_right = int(doc.origin_right[i0])
                run_idx = [i0]
                p = pos + 1
                while p < sub_end:
                    ii = idx_of.get(p)
                    if ii is None:
                        break
                    if int(doc.origin_left[ii]) != p - 1:
                        break
                    if int(doc.origin_right[ii]) != origin_right:
                        break
                    run_idx.append(ii)
                    p += 1
                chars = [chr(int(doc.chars[iq])) for iq in run_idx]
                ops.append(RemoteIns(
                    origin_left=doc.order_to_remote_id(origin_left),
                    origin_right=doc.order_to_remote_id(origin_right),
                    ins_content="".join(chars),
                ))
                pos = p

        out.append(RemoteTxn(
            id=RemoteId(agent_name, seq0),
            parents=parents,
            ops=ops,
        ))
        o = sub_end
    return out


def merge_into(dst: ListCRDT, src: ListCRDT) -> int:
    """Apply everything ``dst`` is missing from ``src``'s history.

    Returns the number of RemoteTxns applied. Applying in source order is
    causally safe: parents always have smaller source order than their txn.
    """
    applied = 0
    for txn in export_txns_since(src, 0):
        agent = dst.get_or_create_agent_id(txn.id.agent)
        next_seq = dst.client_data[agent].get_next_seq()
        if txn.id.seq + txn_len(txn) <= next_seq:
            continue  # fully known
        if txn.id.seq < next_seq:
            txn = split_txn_suffix(txn, next_seq - txn.id.seq)
        dst.apply_remote_txn(txn)
        applied += 1
    return applied


def remote_frontier(doc: ListCRDT) -> Set[RemoteId]:
    """Frontier as peer-portable ids (orders are peer-local)."""
    return {doc.order_to_remote_id(o) for o in doc.frontier}


def agent_watermarks(doc: ListCRDT) -> Dict[str, int]:
    """Per-agent next expected seq — the peer-portable progress vector a
    DIGEST frame advertises (`net/session.py`). Orders are peer-local;
    (agent name, seq) watermarks are the only comparable progress."""
    return {cd.name: cd.get_next_seq() for cd in doc.client_data}


def state_digest(doc: ListCRDT) -> int:
    """Order-independent 32-bit digest of the *converged* state.

    Hashes the document body in document order as peer-portable
    (agent name, seq, deleted) triples plus the sorted remote frontier —
    never local orders, which differ across peers that interleaved the
    same history differently. Two peers that have applied the same op set
    converge to the same YATA document order (PAPER.md §1), so equal
    history ⇒ equal digest; equal watermarks with UNEQUAL digests is the
    divergence signal the resync session trips on.
    """
    h = 0
    # u32 length prefix: agent names are unbounded strings (the codec
    # caps them at 4 KiB, but the digest must never be the crash site).
    for i in range(doc.n):
        agent, seq = doc.loc_of_order(int(doc.order[i]))
        name = doc.get_agent_name(agent).encode("utf-8")
        h = zlib.crc32(struct.pack("<I", len(name)) + name, h)
        h = zlib.crc32(
            struct.pack("<IB", seq, 1 if doc.deleted[i] else 0), h)
    frontier = sorted(((r.agent, r.seq) for r in remote_frontier(doc)))
    for name_s, seq in frontier:
        name = name_s.encode("utf-8")
        h = zlib.crc32(struct.pack("<I", len(name)) + name, h)
        h = zlib.crc32(struct.pack("<I", seq), h)
    return h & 0xFFFF_FFFF


def export_txns_for_wants(doc: ListCRDT,
                          wants: Dict[str, int]) -> List[RemoteTxn]:
    """Serve a REQUEST frame: history covering every requested
    (agent, from_seq..) range this doc knows about.

    Exports since the *minimum* local order covering any requested id —
    possibly a superset of the ask (linear history interleaves agents),
    which is safe: the receiver's ``CausalBuffer`` trims known prefixes
    and drops duplicates idempotently. Unknown agents and already-covered
    watermarks are skipped; returns ``[]`` when nothing is owed.
    """
    start = None
    for name, from_seq in wants.items():
        aid = doc.get_agent_id(name)
        if aid is None or aid == CLIENT_INVALID:
            continue
        cd = doc.client_data[aid]
        if from_seq >= cd.get_next_seq():
            continue
        o = cd.seq_to_order(from_seq)
        start = o if start is None else min(start, o)
    if start is None:
        return []
    return export_txns_since(doc, start)
