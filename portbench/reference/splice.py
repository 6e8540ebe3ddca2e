"""The plain reference of a local-edit replay: splice the patches into a
character sequence that keeps its deleted characters.

Each character ever inserted has an order: orders count the history's
operations, a patch's deleted characters first, then its inserted ones
(``doc.rs:376-389``). The document is every inserted character in
document order, live or deleted. A patch deletes the ``del_len`` live
characters from live position ``pos``, then inserts its text right after
the ``pos``-th live character (at the very start when ``pos`` is 0),
before any deleted characters that follow it. Each inserted character
records two origins: the live character before it (its origin-left, the
previous character of the same patch for all but the first) and the
character, live or deleted, that followed the insert point (its
origin-right, the same for a patch's every character); ``ROOT`` stands
for the document's start and end.

The sequence is held in chunks of a few hundred characters with each
chunk's count of live ones, so a position is found by one search over
the chunks' live prefix and one scan of a chunk.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: The origin of an insert at the document's start or end (u32).
ROOT = 0xFFFF_FFFF
#: A chunk is split in two when it grows past this many characters.
CHUNK = 1024


@dataclasses.dataclass
class Expected:
    """The reference's document and origins."""

    signed: np.ndarray    # int64 [N]: every inserted character in document
    #                       order, order + 1 if live, -(order + 1) if deleted
    ol: np.ndarray        # uint32 [orders]: origin-left by order
    orr: np.ndarray       # uint32 [orders]: origin-right by order
    inserted: np.ndarray  # bool [orders]: the order is an inserted character
    text: str             # the live characters

    @property
    def orders(self) -> int:
        return len(self.ol)

    def runs(self):
        """``(starts, lengths)``: the fewest runs that spell ``signed``: a
        run continues while the characters keep their sign and their
        orders count up by one. ``starts`` are the runs' first values of
        ``signed``."""
        s = self.signed
        if len(s) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        cont = np.zeros(len(s), bool)
        cont[1:] = (np.sign(s[1:]) == np.sign(s[:-1])) & \
            (np.abs(s[1:]) == np.abs(s[:-1]) + 1)
        heads = np.flatnonzero(~cont)
        lens = np.diff(np.append(heads, len(s)))
        return s[heads], lens


class _Doc:
    """The character sequence in chunks: ``val`` holds order + 1,
    ``live`` the live mask, ``cum`` the inclusive prefix of each chunk's
    live count."""

    def __init__(self):
        self.val = [np.zeros(0, np.int64)]
        self.live = [np.zeros(0, bool)]
        self.cum = np.zeros(1, np.int64)

    def locate(self, p: int):
        """``(chunk, index)`` of the ``p``-th live character (1-based)."""
        c = int(np.searchsorted(self.cum, p))
        if c >= len(self.val):
            raise ValueError(f"live position {p} past the end")
        before = int(self.cum[c - 1]) if c else 0
        i = int(np.flatnonzero(self.live[c])[p - before - 1])
        return c, i

    def first_value(self, c: int):
        """Order + 1 of the first character at or after chunk ``c``."""
        while c < len(self.val):
            if len(self.val[c]):
                return int(self.val[c][0])
            c += 1
        return 0

    def insert(self, p: int, vals: np.ndarray):
        """Insert after the ``p``-th live character; returns the origins
        ``(left, right)`` of the first inserted character (order + 1, 0
        for ``ROOT``)."""
        if p == 0:
            c, at, left = 0, 0, 0
            right = self.first_value(0)
        else:
            c, i = self.locate(p)
            at = i + 1
            left = int(self.val[c][i])
            right = (int(self.val[c][at]) if at < len(self.val[c])
                     else self.first_value(c + 1))
        self.val[c] = np.concatenate(
            [self.val[c][:at], vals, self.val[c][at:]])
        self.live[c] = np.concatenate(
            [self.live[c][:at], np.ones(len(vals), bool),
             self.live[c][at:]])
        self.cum[c:] += len(vals)
        if len(self.val[c]) > 2 * CHUNK:
            self._split(c)
        return left, right

    def delete(self, p: int, d: int):
        """Delete the ``d`` live characters from live position ``p``."""
        if d <= 0:
            return
        c, i = self.locate(p + 1)
        rem = d
        while rem > 0:
            if c >= len(self.val):
                raise ValueError("delete past the end of the document")
            hit = np.flatnonzero(self.live[c][i:])[:rem] + i
            self.live[c][hit] = False
            self.cum[c:] -= len(hit)
            rem -= len(hit)
            c, i = c + 1, 0

    def _split(self, c: int):
        h = len(self.val[c]) // 2
        v, lv = self.val[c], self.live[c]
        self.val[c:c + 1] = [v[:h], v[h:]]
        self.live[c:c + 1] = [lv[:h], lv[h:]]
        low = int(self.cum[c]) - int(lv[h:].sum())
        self.cum = np.insert(self.cum, c, low)

    def signed(self) -> np.ndarray:
        v = np.concatenate(self.val)
        return np.where(np.concatenate(self.live), v, -v)


def replay(patches) -> Expected:
    """The document and origins that ``patches`` (objects with ``pos``,
    ``del_len`` and ``ins_content``) leave."""
    total = sum(p.del_len + len(p.ins_content) for p in patches)
    ol = np.zeros(total, np.uint32)
    orr = np.zeros(total, np.uint32)
    inserted = np.zeros(total, bool)
    chars = np.zeros(total, np.uint32)
    doc = _Doc()
    nxt = 0
    for p in patches:
        doc.delete(p.pos, p.del_len)
        nxt += p.del_len
        n = len(p.ins_content)
        if not n:
            continue
        left, right = doc.insert(p.pos, np.arange(nxt + 1, nxt + n + 1,
                                                  dtype=np.int64))
        ol[nxt] = left - 1 if left else ROOT
        ol[nxt + 1:nxt + n] = np.arange(nxt, nxt + n - 1)
        orr[nxt:nxt + n] = right - 1 if right else ROOT
        inserted[nxt:nxt + n] = True
        chars[nxt:nxt + n] = np.frombuffer(
            p.ins_content.encode("utf-32-le"), np.uint32)
        nxt += n
    signed = doc.signed()
    live = signed[signed > 0] - 1
    text = chars[live].tobytes().decode("utf-32-le")
    return Expected(signed=signed, ol=ol, orr=orr, inserted=inserted,
                    text=text)
