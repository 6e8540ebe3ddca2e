"""Deterministic fault injection for the replication wire.

A ``FaultyChannel`` sits between two peers and mangles frames the way a
real network does — drops, duplicates, reorders, truncations, bit-flips —
under a seeded RNG so every fuzz failure replays exactly. The convergence
contract under test (PAPER.md §1, Yjs/YATA model): whatever this channel
does, the receiving peer must either converge bit-identically after
resync or reject the frame with a typed error. Zero uncaught exceptions.

Faults are rolled independently per frame at ``send`` time (so one frame
can be both duplicated and bit-flipped); ``reorder`` is applied at
``drain`` time by moving a marked frame to a random later position in the
delivery batch. Counters record every injected fault for assertion
against the session metrics.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class FaultSpec:
    """Per-frame fault probabilities (independent rolls)."""

    drop: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    truncate: float = 0.0
    bitflip: float = 0.0

    @classmethod
    def all(cls, p: float) -> "FaultSpec":
        return cls(drop=p, duplicate=p, reorder=p, truncate=p, bitflip=p)


@dataclass
class FaultyChannel:
    """One-directional frame pipe with seeded fault injection."""

    spec: FaultSpec = field(default_factory=FaultSpec)
    seed: int = 0

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        # (frame, reorder_marked) pending delivery.
        self._queue: List[tuple] = []
        self.counters: Dict[str, int] = {
            "sent": 0, "dropped": 0, "duplicated": 0, "reordered": 0,
            "truncated": 0, "bitflipped": 0, "delivered": 0,
        }

    # -- fault transforms ---------------------------------------------------

    def _truncate(self, frame: bytes) -> bytes:
        if len(frame) <= 1:
            return b""
        return frame[: self._rng.randrange(0, len(frame))]

    def _bitflip(self, frame: bytes) -> bytes:
        if not frame:
            return frame
        i = self._rng.randrange(len(frame))
        bit = 1 << self._rng.randrange(8)
        out = bytearray(frame)
        out[i] ^= bit
        return bytes(out)

    # -- pipe ---------------------------------------------------------------

    def send(self, frame: bytes) -> None:
        rng = self._rng
        self.counters["sent"] += 1
        if rng.random() < self.spec.drop:
            self.counters["dropped"] += 1
            return
        copies = 1
        if rng.random() < self.spec.duplicate:
            self.counters["duplicated"] += 1
            copies = 2
        for _ in range(copies):
            f = frame
            if rng.random() < self.spec.truncate:
                self.counters["truncated"] += 1
                f = self._truncate(f)
            if rng.random() < self.spec.bitflip:
                self.counters["bitflipped"] += 1
                f = self._bitflip(f)
            marked = rng.random() < self.spec.reorder
            self._queue.append((f, marked))

    def drain(self) -> List[bytes]:
        """Deliver everything queued, applying reorders, and reset."""
        batch = self._queue
        self._queue = []
        out: List[bytes] = []
        deferred: List[bytes] = []
        for frame, marked in batch:
            if marked:
                deferred.append(frame)
            else:
                out.append(frame)
        for frame in deferred:
            pos = self._rng.randrange(len(out) + 1)
            if pos != len(out):
                self.counters["reordered"] += 1
            out.insert(pos, frame)
        self.counters["delivered"] += len(out)
        return out

    @property
    def pending(self) -> int:
        return len(self._queue)
