"""Host-side reference document engine — the correctness oracle
(counterpart of ``text_crdt_rust_tpu/models/oracle.py``, numpy on the
host, same semantics).

An item-granular rebuild of the reference's ``ListCRDT``
(`src/list/doc.rs:19-511`, state at `src/list/mod.rs:52-99`). Where the
reference stores the document as a pointer B-tree of RLE ``YjsSpan`` runs
(`range_tree/`), the oracle stores **one row per character** in
struct-of-arrays numpy columns. This is deliberately the simplest
obviously correct representation; the device replays are validated
against it.

Semantic invariants preserved bit-exactly:

- per-item implicit origin chaining: item ``k`` of an inserted run has
  origin_left ``order+k-1`` and the run's shared origin_right
  (`list/span.rs:9-18`, `origin_left_at_offset` `span.rs:24-28`);
- tombstones are sign-flips, never removals (`span.rs:110-119`) — here a
  ``deleted`` byte column;
- the Yjs/YATA integrate scan with name-based tiebreak and the
  scanning/scan_start backtrack (`doc.rs:167-234`), with scan_start
  pinned only on the false->true transition (see ``_integrate``);
- origin_right is the item *immediately after* origin_left in raw order,
  even if deleted (`doc.rs:452-453` keeps that known quirk);
- deletes log keyed by the delete op's order; double-delete interval
  increments (`doc.rs:295-340`);
- frontier advance + txn shadow computation (`doc.rs:34-48`, `:350-374`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..common import (
    CLIENT_INVALID,
    LocalOp,
    ROOT_ORDER,
    RemoteDel,
    RemoteId,
    RemoteIns,
    RemoteTxn,
)
from ..utils.rle import (
    KCRDTSpan,
    KDeleteEntry,
    KDoubleDelete,
    KOrderSpan,
    Rle,
    TxnSpan,
    increment_delete_range,
)


class ClientData:
    """Per-agent name + (seq -> order) RLE map (`list/mod.rs:33-43`)."""

    def __init__(self, name: str):
        self.name = name
        self.item_orders: Rle[KOrderSpan] = Rle()

    def get_next_seq(self) -> int:
        last = self.item_orders.last()
        return last.seq + last.length if last is not None else 0

    def seq_to_order(self, seq: int) -> int:
        found = self.item_orders.find(seq)
        assert found is not None, f"unknown seq {seq} for agent {self.name}"
        entry, offset = found
        return entry.order + offset


class ListCRDT:
    """Python oracle document (`src/list/doc.rs`)."""

    def __init__(self, capacity: int = 64):
        # Document body: one row per character, document order, tombstones
        # in place. SoA columns sized `capacity`, `n` rows live.
        self.order = np.full(capacity, ROOT_ORDER, dtype=np.uint32)
        self.origin_left = np.full(capacity, ROOT_ORDER, dtype=np.uint32)
        self.origin_right = np.full(capacity, ROOT_ORDER, dtype=np.uint32)
        self.deleted = np.zeros(capacity, dtype=bool)
        self.chars = np.zeros(capacity, dtype=np.uint32)  # unicode codepoints
        self.n = 0
        # order -> raw body index, maintained through every splice — the
        # oracle's SpaceIndex (`markers.rs:8`): ``raw_index_of_order`` is
        # one array read instead of a full-body np.nonzero scan (the
        # per-probed-char cost that capped differential-fuzz throughput).
        # -1 = order not in the body.
        self._raw_index = np.full(capacity, -1, dtype=np.int64)

        # Frontier starts at ROOT (`doc.rs:54`).
        self.frontier: List[int] = [ROOT_ORDER]
        # order -> (agent, seq) (`list/mod.rs:58-63`).
        self.client_with_order: Rle[KCRDTSpan] = Rle()
        self.client_data: List[ClientData] = []
        # Logs (`list/mod.rs:82-95`).
        self.deletes: Rle[KDeleteEntry] = Rle()
        self.double_deletes: Rle[KDoubleDelete] = Rle()
        self.txns: Rle[TxnSpan] = Rle()

    # -- agents ------------------------------------------------------------

    def get_or_create_agent_id(self, name: str) -> int:
        if name == "ROOT":
            return CLIENT_INVALID
        aid = self.get_agent_id(name)
        if aid is not None:
            return aid
        self.client_data.append(ClientData(name))
        return len(self.client_data) - 1

    def get_agent_id(self, name: str) -> Optional[int]:
        if name == "ROOT":
            return CLIENT_INVALID
        for i, cd in enumerate(self.client_data):
            if cd.name == name:
                return i
        return None

    def get_agent_name(self, agent: int) -> str:
        if agent == CLIENT_INVALID:
            return "ROOT"
        return self.client_data[agent].name

    # -- order bookkeeping -------------------------------------------------

    def get_next_order(self) -> int:
        last = self.client_with_order.last()
        return last.order + last.length if last is not None else 0

    def assign_order_to_client(self, agent: int, seq: int, order: int,
                               length: int) -> None:
        """(`doc.rs:155-165`)"""
        self.client_with_order.append(KCRDTSpan(order, agent, seq, length))
        self.client_data[agent].item_orders.append(KOrderSpan(seq, order, length))

    def agent_of_order(self, order: int) -> int:
        found = self.client_with_order.find(order)
        assert found is not None
        return found[0].agent

    def loc_of_order(self, order: int) -> Tuple[int, int]:
        """order -> (agent, seq)."""
        found = self.client_with_order.find(order)
        assert found is not None
        entry, offset = found
        return entry.agent, entry.seq + offset

    def remote_id_to_order(self, rid: RemoteId) -> int:
        """(`doc.rs:236-240`)"""
        agent = self.get_agent_id(rid.agent)
        assert agent is not None, f"unknown agent {rid.agent!r}"
        if agent == CLIENT_INVALID:
            return ROOT_ORDER
        return self.client_data[agent].seq_to_order(rid.seq)

    def order_to_remote_id(self, order: int) -> RemoteId:
        if order == ROOT_ORDER:
            return RemoteId("ROOT", 0xFFFF_FFFF)
        agent, seq = self.loc_of_order(order)
        return RemoteId(self.get_agent_name(agent), seq)

    # -- document body helpers --------------------------------------------

    def _grow(self, need: int) -> None:
        cap = len(self.order)
        if self.n + need <= cap:
            return
        new_cap = max(cap * 2, self.n + need)
        for name in ("order", "origin_left", "origin_right", "deleted", "chars"):
            old = getattr(self, name)
            fill = ROOT_ORDER if old.dtype == np.uint32 and name != "chars" else 0
            new = np.full(new_cap, fill, dtype=old.dtype)
            new[: self.n] = old[: self.n]
            setattr(self, name, new)

    def rebuild_raw_index(self) -> None:
        """Recompute the order->raw-index map from the body — for
        restore paths that set the body columns directly instead of
        splicing (``utils.checkpoint._rebuild_oracle``)."""
        n = self.n
        orders = self.order[:n].astype(np.int64)
        top = int(orders.max(initial=0)) + 1
        if top > len(self._raw_index):
            self._raw_index = np.full(top, -1, dtype=np.int64)
        else:
            self._raw_index[:] = -1
        self._raw_index[orders] = np.arange(n)

    def raw_index_of_order(self, order: int) -> int:
        """Raw (tombstones included) document index of an item — the
        oracle's stand-in for the order->leaf SpaceIndex (`doc.rs:101-107`).
        One indexed read off the splice-maintained map (``check()``
        verifies the map against the body wholesale)."""
        i = int(self._raw_index[order]) if order < len(self._raw_index) else -1
        assert 0 <= i < self.n and int(self.order[i]) == order, (
            f"order {order} not found in doc body"
        )
        return i

    def raw_index_of_live(self, content_pos: int) -> int:
        """Raw index of the ``content_pos``-th live item (0-based)."""
        live = ~self.deleted[: self.n]
        cum = np.cumsum(live)
        idx = int(np.searchsorted(cum, content_pos + 1, side="left"))
        assert idx < self.n, f"content pos {content_pos} out of range"
        return idx

    def _cursor_after(self, origin: int) -> int:
        """Raw cursor just after item ``origin`` (`doc.rs:121-136`)."""
        if origin == ROOT_ORDER:
            return 0
        return self.raw_index_of_order(origin) + 1

    # -- integrate (the YATA core) ----------------------------------------

    def _integrate(self, agent: int, first_order: int, origin_left: int,
                   origin_right: int, length: int, content: str,
                   raw_cursor: Optional[int] = None) -> int:
        """Yjs/YATA concurrent-insert conflict resolution (`doc.rs:167-234`).

        Returns the raw index the run was inserted at. Cursors are plain raw
        indices here: the reference's cursor total order (`cursor.rs:274-304`)
        collapses to integer comparison in the flat layout (SURVEY §2
        `Cursor` row).
        """
        if raw_cursor is None:
            raw_cursor = self._cursor_after(origin_left)
        cursor = raw_cursor
        left_cursor = raw_cursor
        scan_start = raw_cursor
        scanning = False

        while cursor < self.n:
            other_order = int(self.order[cursor])
            if other_order == origin_right:
                break
            other_left = int(self.origin_left[cursor])
            other_left_cursor = self._cursor_after(other_left)
            if other_left_cursor < left_cursor:
                break
            elif other_left_cursor == left_cursor:
                # Possibly-concurrent items: Yjs name tiebreak
                # (`doc.rs:204-217`) — on *agent name*, not agent id.
                my_name = self.get_agent_name(agent)
                other_name = self.get_agent_name(self.agent_of_order(other_order))
                if my_name > other_name:
                    scanning = False
                elif origin_right == int(self.origin_right[cursor]):
                    break
                else:
                    # Deliberate fix vs the reference: `doc.rs:214-216`
                    # re-pins scan_start on *every* scanning iteration, which
                    # diverges from Yjs (Item.integrate keeps `left` pinned
                    # unless o.client < this.client) and breaks N-peer
                    # convergence — e.g. merging an (origin ROOT, right ROOT)
                    # item into three chained same-origin items. Pin only on
                    # the false→true transition.
                    if not scanning:
                        scan_start = cursor
                    scanning = True
            cursor += 1
        if scanning:
            cursor = scan_start

        self._splice_in(cursor, first_order, origin_left, origin_right,
                        length, content)
        return cursor

    def _splice_in(self, at: int, first_order: int, origin_left: int,
                   origin_right: int, length: int, content: str) -> None:
        assert length > 0, "zero-length splice would corrupt neighbour origins"
        self._grow(length)
        n = self.n
        # Index upkeep costs O(moved), the same as the splice itself:
        # shifted items move +length, the new run maps to at..at+length.
        if first_order + length > len(self._raw_index):
            new = np.full(max(2 * len(self._raw_index),
                              first_order + length), -1, dtype=np.int64)
            new[: len(self._raw_index)] = self._raw_index
            self._raw_index = new
        self._raw_index[self.order[at:n].astype(np.int64)] += length
        self._raw_index[first_order: first_order + length] = np.arange(
            at, at + length)
        for name in ("order", "origin_left", "origin_right", "deleted", "chars"):
            arr = getattr(self, name)
            arr[at + length: n + length] = arr[at: n]
        orders = np.arange(first_order, first_order + length, dtype=np.uint32)
        self.order[at: at + length] = orders
        # Implicit origin chaining within the run (`span.rs:9-13,24-28`).
        self.origin_left[at] = np.uint32(origin_left)
        if length > 1:
            self.origin_left[at + 1: at + length] = orders[:-1]
        self.origin_right[at: at + length] = np.uint32(origin_right)
        self.deleted[at: at + length] = False
        if content:
            assert len(content) == length
            self.chars[at: at + length] = np.frombuffer(
                content.encode("utf-32-le"), dtype=np.uint32
            )
        self.n += length

    # -- local edits -------------------------------------------------------

    def apply_local_txn(self, agent: int, local_ops: List[LocalOp]) -> None:
        """(`doc.rs:376-469`)"""
        first_order = self.get_next_order()
        next_order = first_order

        txn_span = sum(op.del_span + len(op.ins_content) for op in local_ops)
        self.assign_order_to_client(
            agent, self.client_data[agent].get_next_seq(), first_order, txn_span
        )

        for op in local_ops:
            pos = op.pos
            if op.del_span > 0:
                next_order = self._local_deactivate(pos, op.del_span, next_order)
            if op.ins_content:
                ins_len = len(op.ins_content)
                order = next_order
                next_order += ins_len
                if pos == 0:
                    origin_left, cursor = ROOT_ORDER, 0
                else:
                    li = self.raw_index_of_live(pos - 1)
                    origin_left = int(self.order[li])
                    cursor = li + 1
                # Known reference quirk kept: origin_right does NOT skip
                # deleted items (`doc.rs:452-453`).
                origin_right = (
                    int(self.order[cursor]) if cursor < self.n else ROOT_ORDER
                )
                self._integrate(agent, order, origin_left, origin_right,
                                ins_len, op.ins_content, raw_cursor=cursor)

        self._insert_txn(None, first_order, next_order - first_order)
        assert next_order == self.get_next_order()

    def _local_deactivate(self, pos: int, del_span: int, next_order: int) -> int:
        """Tombstone ``del_span`` live items from content pos ``pos``
        (`range_tree/mutations.rs:520-570` + `doc.rs:392-433`)."""
        i = self.raw_index_of_live(pos)
        runs: List[Tuple[int, int]] = []  # (target_order_start, len), RLE-merged
        remaining = del_span
        while remaining > 0:
            assert i < self.n, "local delete past end of document"
            if self.deleted[i]:
                i += 1
                continue
            o = int(self.order[i])
            self.deleted[i] = True
            if runs and runs[-1][0] + runs[-1][1] == o:
                runs[-1] = (runs[-1][0], runs[-1][1] + 1)
            else:
                runs.append((o, 1))
            remaining -= 1
            i += 1
        for target, length in runs:
            self.deletes.append(KDeleteEntry(next_order, target, length))
            next_order += length
        return next_order

    def local_insert(self, agent: int, pos: int, content: str) -> None:
        self.apply_local_txn(agent, [LocalOp(pos=pos, ins_content=content)])

    def local_delete(self, agent: int, pos: int, del_span: int) -> None:
        self.apply_local_txn(agent, [LocalOp(pos=pos, del_span=del_span)])

    # -- remote edits ------------------------------------------------------

    def apply_remote_txn(self, txn: RemoteTxn) -> None:
        """(`doc.rs:242-348`)"""
        agent = self.get_or_create_agent_id(txn.id.agent)
        next_seq = self.client_data[agent].get_next_seq()
        # Out-of-order txns must be buffered by the caller (the reference
        # asserts here too, `doc.rs:246-247`; see parallel/causal.py).
        assert next_seq == txn.id.seq, (
            f"remote txn out of order: expected seq {next_seq}, got {txn.id.seq}"
        )

        first_order = self.get_next_order()
        next_order = first_order

        txn_len = 0
        for op in txn.ops:
            if isinstance(op, RemoteIns):
                txn_len += len(op.ins_content)
            else:
                assert op.len > 0, "zero-length RemoteDel"
                txn_len += op.len
        # Zero-length txns would create zero-length RLE log entries and break
        # frontier arithmetic (first_order + len - 1).
        assert txn_len > 0, "empty remote txn"

        self.assign_order_to_client(agent, txn.id.seq, first_order, txn_len)

        for op in txn.ops:
            if isinstance(op, RemoteIns):
                ins_len = len(op.ins_content)
                if ins_len == 0:
                    continue
                order = next_order
                next_order += ins_len
                origin_left = self.remote_id_to_order(op.origin_left)
                origin_right = self.remote_id_to_order(op.origin_right)
                self._integrate(agent, order, origin_left, origin_right,
                                ins_len, op.ins_content, raw_cursor=None)
            else:
                assert isinstance(op, RemoteDel)
                order = next_order
                next_order += op.len
                # The reference maps the target id to a local order once and
                # walks `len` *local* orders (`doc.rs:301-311`) — which
                # silently assumes the target seq range is order-contiguous
                # on every peer. It isn't in general (peers interleave txns
                # differently), so we walk the target range in *seq space*,
                # chunked through our own item_orders runs; each chunk is
                # order-contiguous locally by construction. When the
                # reference's implicit assumption holds, the deletes-log
                # entries RLE-merge back into the identical single entry.
                target_agent = self.get_agent_id(op.id.agent)
                assert target_agent is not None and target_agent != CLIENT_INVALID
                item_orders = self.client_data[target_agent].item_orders
                seq = op.id.seq
                remaining = op.len
                consumed = 0
                dd_run: Optional[Tuple[int, int]] = None  # (start, len)
                while remaining > 0:
                    found = item_orders.find(seq)
                    assert found is not None, (
                        f"delete target ({op.id.agent},{seq}) unknown"
                    )
                    entry, off = found
                    run_len = min(entry.length - off, remaining)
                    target = entry.order + off
                    # Log the delete keyed by the delete op's order
                    # (`doc.rs:305-308`).
                    self.deletes.append(
                        KDeleteEntry(order + consumed, target, run_len)
                    )
                    # Deleted items may be fragmented in doc order
                    # (`doc.rs:310-334`); double-deleted runs are counted
                    # (`mutations.rs:579-615`, `double_delete.rs:41-106`).
                    for k in range(run_len):
                        t = target + k
                        i = self.raw_index_of_order(t)
                        if self.deleted[i]:
                            if dd_run is not None and dd_run[0] + dd_run[1] == t:
                                dd_run = (dd_run[0], dd_run[1] + 1)
                            else:
                                if dd_run is not None:
                                    increment_delete_range(
                                        self.double_deletes, dd_run[0], dd_run[1])
                                dd_run = (t, 1)
                        else:
                            self.deleted[i] = True
                    seq += run_len
                    consumed += run_len
                    remaining -= run_len
                if dd_run is not None:
                    increment_delete_range(self.double_deletes,
                                           dd_run[0], dd_run[1])

        parents = [self.remote_id_to_order(p) for p in txn.parents]
        self._insert_txn(parents, first_order, txn_len)

    # -- time DAG ----------------------------------------------------------

    def _advance_branch_by(self, txn_parents: List[int], first_order: int,
                           length: int) -> None:
        """(`doc.rs:34-48`)"""
        assert first_order not in self.frontier
        self.frontier = [o for o in self.frontier if o not in txn_parents]
        self.frontier.append(first_order + length - 1)

    def _insert_txn(self, txn_parents: Optional[List[int]], first_order: int,
                    length: int) -> None:
        """(`doc.rs:350-374`)"""
        last_order = first_order + length - 1
        if txn_parents is not None:
            self._advance_branch_by(txn_parents, first_order, length)
        else:
            txn_parents = self.frontier
            self.frontier = [last_order]

        shadow = first_order
        while shadow >= 1 and (shadow - 1) in txn_parents:
            found = self.txns.find(shadow - 1)
            assert found is not None
            shadow = found[0].shadow

        self.txns.append(TxnSpan(first_order, length, shadow, list(txn_parents)))

    # -- read-back ---------------------------------------------------------

    def __len__(self) -> int:
        """Live character count (`doc.rs:484-486`)."""
        return int(np.count_nonzero(~self.deleted[: self.n]))

    def to_string(self) -> str:
        live = ~self.deleted[: self.n]
        cps = self.chars[: self.n][live]
        return cps.astype("<u4").tobytes().decode("utf-32-le")

    def doc_spans(self) -> List[Tuple[int, int, int, int]]:
        """Document body as maximally RLE-merged YjsSpan tuples
        (order, origin_left, origin_right, signed_len) — the canonical
        compacted form used to compare engines."""
        from ..utils.rle import merge_yjs_spans
        return merge_yjs_spans(
            (int(self.order[i]), int(self.origin_left[i]),
             int(self.origin_right[i]), -1 if self.deleted[i] else 1)
            for i in range(self.n)
        )

    def check(self) -> None:
        """Structure invariants (`root.rs:242-253` ethos)."""
        n = self.n
        orders = self.order[:n]
        assert len(np.unique(orders)) == n, "duplicate orders in doc body"
        # The order->raw-index map must agree with the body everywhere.
        assert bool((self._raw_index[orders.astype(np.int64)]
                     == np.arange(n)).all()), "order index diverged from body"
        self.client_with_order.check()
        self.deletes.check()
        self.double_deletes.check()
        for cd in self.client_data:
            cd.item_orders.check()
        # Every assigned insert order appears in the body exactly once:
        # body orders == all orders minus delete-op orders.
        total = self.get_next_order()
        del_ops = sum(e.length for e in self.deletes)
        assert n == total - del_ops, (
            f"body has {n} items, expected {total - del_ops}"
        )
