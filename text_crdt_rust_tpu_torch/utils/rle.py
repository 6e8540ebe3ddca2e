"""Flat sorted run-length-encoded vectors (counterpart of
``text_crdt_rust_tpu/utils/rle.py``, the whole file).

The reference's span algebra (`src/splitable_span.rs:3-37`) and the flat
RLE container (`src/rle/simple_rle.rs:12-103`, `src/rle/mod.rs:16-68`).
Every entry type implements the SplitableSpan contract:

    ``length``, ``truncate(at) -> rest``, ``can_append(other)``,
    ``append(other)``

with the invariant that after ``rest = e.truncate(at)``:
``old_len == at + rest.length`` and ``e.can_append(rest)``
(`splitable_span.rs:10-16`).

Keyed entries fold the reference's ``KVPair`` (`rle/mod.rs:16-68`) into the
entry itself: ``key`` is the RLE key, ``can_append`` requires key
consecutiveness exactly like ``KVPair::can_append``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Generic, Iterator, List, Optional, Tuple, TypeVar


@dataclass
class KOrderSpan:
    """item_orders entry: seq range -> order range, always live
    (`list/mod.rs:33-43`, value type `src/order.rs:7-11` with positive len)."""

    seq: int
    order: int
    length: int

    @property
    def key(self) -> int:
        return self.seq

    def can_append(self, other: "KOrderSpan") -> bool:
        return (
            other.seq == self.seq + self.length
            and other.order == self.order + self.length
        )

    def append(self, other: "KOrderSpan") -> None:
        self.length += other.length

    def truncate(self, at: int) -> "KOrderSpan":
        rest = KOrderSpan(self.seq + at, self.order + at, self.length - at)
        self.length = at
        return rest

    def at_offset(self, offset: int) -> int:
        return self.order + offset


@dataclass
class KCRDTSpan:
    """client_with_order entry: order range -> (agent, seq) range
    (`list/mod.rs:58-63`, value type `range_tree/entry.rs:44`)."""

    order: int
    agent: int
    seq: int
    length: int

    @property
    def key(self) -> int:
        return self.order

    def can_append(self, other: "KCRDTSpan") -> bool:
        return (
            other.order == self.order + self.length
            and other.agent == self.agent
            and other.seq == self.seq + self.length
        )

    def append(self, other: "KCRDTSpan") -> None:
        self.length += other.length

    def truncate(self, at: int) -> "KCRDTSpan":
        rest = KCRDTSpan(self.order + at, self.agent, self.seq + at, self.length - at)
        self.length = at
        return rest


@dataclass
class KDeleteEntry:
    """deletes entry: delete-op order range -> deleted-target order range
    (`src/list/delete.rs:7-40`; keyed by the *delete op's* order,
    `list/mod.rs:82-84`)."""

    op_order: int
    target: int
    length: int

    @property
    def key(self) -> int:
        return self.op_order

    def can_append(self, other: "KDeleteEntry") -> bool:
        return (
            other.op_order == self.op_order + self.length
            and other.target == self.target + self.length
        )

    def append(self, other: "KDeleteEntry") -> None:
        self.length += other.length

    def truncate(self, at: int) -> "KDeleteEntry":
        rest = KDeleteEntry(self.op_order + at, self.target + at, self.length - at)
        self.length = at
        return rest


@dataclass
class KDoubleDelete:
    """double_deletes entry: target order range deleted 1+excess times
    (`src/list/double_delete.rs:12-16`; keyed by the item *being* deleted)."""

    target: int
    length: int
    excess: int

    @property
    def key(self) -> int:
        return self.target

    def can_append(self, other: "KDoubleDelete") -> bool:
        return (
            other.target == self.target + self.length
            and other.excess == self.excess
        )

    def append(self, other: "KDoubleDelete") -> None:
        self.length += other.length

    def truncate(self, at: int) -> "KDoubleDelete":
        rest = KDoubleDelete(self.target + at, self.length - at, self.excess)
        self.length = at
        return rest


@dataclass
class TxnSpan:
    """Time-DAG node covering a run of ops (`src/list/txn.rs:10-18`).

    ``shadow``: earliest order this span transitively dominates without
    branching (`txn.rs:14-15`, computed at `doc.rs:361-364`).
    ``parents``: parents of the first txn in the span (`txn.rs:17-18`).
    """

    order: int
    length: int
    shadow: int
    parents: List[int] = field(default_factory=list)

    @property
    def key(self) -> int:
        return self.order

    def can_append(self, other: "TxnSpan") -> bool:
        # RLE merge iff linear history (`txn.rs:38-42`). Key consecutiveness
        # is implied because orders are dense.
        return (
            len(other.parents) == 1
            and other.parents[0] == self.order + self.length - 1
            and other.shadow == self.shadow
        )

    def append(self, other: "TxnSpan") -> None:
        self.length += other.length

    def truncate(self, at: int) -> "TxnSpan":
        # Note: the parent of the remainder is the last op of the first half
        # (the reference's `txn.rs:26-35` writes `at - 1`, an absolute/relative
        # mixup that is unreachable in practice; we use the absolute order).
        rest = TxnSpan(self.order + at, self.length - at, self.shadow,
                       [self.order + at - 1])
        self.length = at
        return rest


E = TypeVar("E")


class Rle(Generic[E]):
    """Flat sorted vector of RLE entries keyed by ``entry.key``
    (`src/rle/simple_rle.rs:12-103`).

    ``append`` merges with the last entry when possible (amortized O(1),
    `simple_rle.rs:41-52`); ``find`` is a binary search returning
    ``(entry, offset)`` (`simple_rle.rs:18-37`); ``insert`` merges with
    neighbours (`simple_rle.rs:54-77`).
    """

    def __init__(self, entries: Optional[List[E]] = None):
        self.entries: List[E] = entries if entries is not None else []

    # -- queries ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self) -> Iterator[E]:
        return iter(self.entries)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Rle) and self.entries == other.entries

    def __repr__(self) -> str:
        return f"Rle({self.entries!r})"

    def num_entries(self) -> int:
        return len(self.entries)

    def last(self) -> Optional[E]:
        return self.entries[-1] if self.entries else None

    def search(self, key: int) -> Tuple[bool, int]:
        """Binary search: (True, idx) if ``key`` falls inside entry idx,
        else (False, insertion_idx) (`simple_rle.rs:18-28`)."""
        ents = self.entries
        lo, hi = 0, len(ents)
        while lo < hi:  # find first entry with entry.key > key
            mid = (lo + hi) // 2
            if ents[mid].key <= key:
                lo = mid + 1
            else:
                hi = mid
        idx = lo - 1
        if idx >= 0:
            e = ents[idx]
            if key < e.key + e.length:
                return True, idx
        return False, idx + 1

    def find(self, key: int) -> Optional[Tuple[E, int]]:
        """-> (entry, offset into entry) or None (`simple_rle.rs:30-37`)."""
        ok, idx = self.search(key)
        if not ok:
            return None
        e = self.entries[idx]
        return e, key - e.key

    def get(self, key: int):
        """Value at key for entries supporting ``at_offset``
        (`simple_rle.rs:99-102`)."""
        found = self.find(key)
        if found is None:
            raise KeyError(key)
        entry, offset = found
        return entry.at_offset(offset)

    # -- mutation ---------------------------------------------------------

    def append(self, entry: E) -> None:
        if self.entries and self.entries[-1].can_append(entry):
            self.entries[-1].append(entry)
        else:
            self.entries.append(entry)

    def insert(self, entry: E) -> None:
        """Sorted insert with neighbour merging (`simple_rle.rs:54-77`)."""
        ok, idx = self.search(entry.key)
        assert not ok, "Rle.insert: key range already occupied"
        before = self.entries[idx - 1] if idx > 0 else None
        after = self.entries[idx] if idx < len(self.entries) else None
        if before is not None and before.can_append(entry):
            before.append(entry)
            if after is not None and before.can_append(after):
                before.append(after)
                del self.entries[idx]
        elif after is not None and entry.can_append(after):
            merged = entry
            merged.append(after)
            self.entries[idx] = merged
        else:
            self.entries.insert(idx, entry)

    def check(self) -> None:
        """Invariant walker: keys strictly increasing, non-overlapping,
        no zero-length entries (mirrors the reference's `check()` ethos,
        `range_tree/root.rs:242-253`)."""
        prev_end = -1
        for e in self.entries:
            assert e.length > 0, f"zero-length RLE entry {e!r}"
            assert e.key >= prev_end, (
                f"overlapping/unsorted RLE entries at key {e.key}"
            )
            prev_end = e.key + e.length


def merge_yjs_spans(spans):
    """Canonicalize a doc-order sequence of YjsSpan tuples
    (order, origin_left, origin_right, signed_len) by maximally RLE-merging
    adjacent spans under the reference predicate (`span.rs:47-53`): same
    sign, consecutive orders, chained origin_left, shared origin_right.
    Every engine's doc_spans() reports this form so they compare exactly.
    """
    out = []
    for (o, ol, orr, slen) in spans:
        if out:
            po, pol, porr, plen = out[-1]
            alen = abs(plen)
            if ((plen > 0) == (slen > 0) and o == po + alen
                    and ol == o - 1 and orr == porr):
                out[-1] = (po, pol, porr, plen + slen)
                continue
        out.append((o, ol, orr, slen))
    return out


def increment_delete_range(rle: Rle[KDoubleDelete], base: int, length: int) -> None:
    """Gap-aware interval-increment over the double-delete RLE vector.

    Faithful rebuild of `Rle<KVPair<DoubleDelete>>::increment_delete_range`
    (`src/list/double_delete.rs:41-106`): handles gap insert, entry split and
    partial overlap; adjacent equal-excess runs merge.
    """
    assert length > 0
    nxt = KDoubleDelete(base, length, 1)
    ok, idx = rle.search(base)
    if ok:
        # search returned the containing entry; the reference's
        # `search().unwrap_or_else(|idx| idx)` yields the entry index either
        # way, so start there.
        pass
    ents = rle.entries
    while True:
        if idx == len(ents) or ents[idx].key > nxt.key:
            # In a gap. Insert as much as we can here (`double_delete.rs:52-72`).
            this_entry = nxt
            if idx < len(ents) and nxt.key + nxt.length > ents[idx].key:
                nxt = this_entry.truncate(ents[idx].key - this_entry.key)
                done_here = False
            else:
                done_here = True
            if idx >= 1 and ents[idx - 1].can_append(this_entry):
                ents[idx - 1].append(this_entry)
            else:
                ents.insert(idx, this_entry)
                idx += 1
            if done_here:
                break
        # Now we're inside an entry (`double_delete.rs:75-103`).
        entry = ents[idx]
        assert entry.key <= nxt.key < entry.key + entry.length
        if entry.key < nxt.key:
            remainder = entry.truncate(nxt.key - entry.key)
            idx += 1
            ents.insert(idx, remainder)
        entry = ents[idx]
        assert entry.key == nxt.key
        if entry.length <= nxt.length:
            entry.excess += 1
            nxt = KDoubleDelete(nxt.target + entry.length,
                                nxt.length - entry.length, 1)
            if nxt.length == 0:
                break
            idx += 1
        else:
            remainder = entry.truncate(nxt.length)
            entry.excess += 1
            ents.insert(idx + 1, remainder)
            break
