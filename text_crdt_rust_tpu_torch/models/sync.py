"""Peer synchronization, export side (counterpart of
``text_crdt_rust_tpu/models/sync.py:33``, ``export_txns_since`` only).

Exports a document's history since an order watermark as ``RemoteTxn``s.
All ids cross this boundary as (agent-name string, seq) pairs because
numeric agent ids and orders are peer-local (`doc.rs:236-240`). Merging
and the rest of the sync layer come with the serve slice.
"""
from __future__ import annotations

from typing import List

from ..common import RemoteDel, RemoteId, RemoteIns, RemoteTxn
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
