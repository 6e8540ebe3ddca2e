"""Write-ahead op journal for the serve tier (counterpart of
``text_crdt_rust_tpu/serve/journal.py``; segment files are byte for byte
the JAX package's for the same run).

A ``DocServer`` is an in-memory process: between checkpoints, a crash
loses every resident doc and every admitted-but-unapplied op.  The
journal closes that window as a **full input log**: every
state-mutating call that crosses the admission edge is recorded, and
``DocServer.recover()`` re-drives the normal admission → buffer →
batcher path with the same inputs in the same order.  The server is a
deterministic state machine, so re-execution reproduces the crashed
process byte-for-byte — including residency trajectory, local-edit
position resolution, and the in-flight pipelined ticks that were
dispatched but never synced (their inputs are in the log; the replayed
ticks re-derive them).  Record kinds:

- ``ADMIT``  — a doc was admitted (body: doc id).  Replaying admits in
  order reproduces the router's least-loaded shard assignment and its
  dict iteration order, which the batcher's drain loop depends on.
- ``TXNS``   — fresh remote txns accepted for one doc.  The body is a
  complete ``net/columnar`` ``TXNS_MUX`` frame (self-CRC'd, deflated
  when that wins) — the same bytes the wire speaks, so the journal
  format inherits the codec's torn/corrupt taxonomy for free.
  Duplicate deliveries are NOT journaled: a dup is a no-op on buffer
  state, so skipping it preserves the exact state trajectory at a
  fraction of the bytes.
- ``LOCAL``  — a server-side local edit with its per-doc submission
  ordinal (an exactly-once audit stamp: replay asserts the rebuilt
  ``DocState.local_seen`` agrees with every record's ordinal).
- ``TICK``   — a logical tick boundary; the fsync point, and the
  replay pacing marker (recovery calls ``server.tick()`` here so the
  apply cadence — and therefore local-edit interleaving — reproduces).
- ``FRAME``  — a control frame on the per-doc lane, raw bytes.
  REQUEST frames touch the residency LRU clock and DIGEST frames
  advance ``peer_marks``; both steer later traffic, so the input log
  must carry them for the re-execution to stay exact.
- ``POLL``   — a ``poll_request_frame`` call (body: doc id).  Polling
  folds oracle watermarks into ``known_marks``, which narrows future
  REQUEST wants — a mutation, so it is an input.

Records are framed per segment as::

    varint(global_seq) | kind:1 | varint(len(body)) | body | crc32c:4LE

with the CRC chained record-to-record (each record's CRC seeds the
next) so a bit-flip anywhere poisons the whole suffix, exactly like
``utils.checkpoint``'s chain CRCs.  Segments are per shard
(``shard<k>.<seg:06d>.tcrj``) with a magic header; the chain restarts
at each segment.  Appends are flushed immediately (process-crash
durability); ``os.fsync`` runs at TICK markers every
``fsync_ticks`` ticks (power-loss durability), which is the knob the
``recovery`` ledger cell prices.

``scan`` is the reader: it keeps the valid prefix of each shard's
stream (the ``obs.load_events`` discipline) and reports every refused
suffix as a typed ``JournalError`` naming segment and byte offset —
corruption is never silent.  Records from all shards merge into one
total order on the global sequence number, which is what
``DocServer.recover()`` replays.

``repair`` makes the disk agree with the scan: every refused suffix is
truncated/quarantined (to ``<segment>.refused`` sidecars — forensic
bytes are moved, never destroyed) so a reopened journal's NEW segments
can never be dropped behind a stale torn segment on the next scan.
``Journal.__init__`` runs it on every reopen, which is what makes a
crash → recover → crash → recover sequence lossless for the records
journaled between the crashes.
"""
from __future__ import annotations

import os
import re
from typing import IO, Dict, List, NamedTuple, Optional, Sequence, Tuple

from ..utils.integrity import crc32c

JOURNAL_MAGIC = b"TCRJ"
JOURNAL_VERSION = 1

# Record kinds (one byte on the wire).
REC_ADMIT = 1
REC_TXNS = 2
REC_LOCAL = 3
REC_TICK = 4
REC_FRAME = 5
REC_POLL = 6

_KIND_NAMES = {REC_ADMIT: "admit", REC_TXNS: "txns",
               REC_LOCAL: "local", REC_TICK: "tick",
               REC_FRAME: "frame", REC_POLL: "poll"}

# Rotate a shard's segment once it crosses this many bytes.  Rotation
# bounds the blast radius of a corrupt record (only one segment's
# suffix is lost) and keeps recovery's read buffers small.
DEFAULT_ROTATE_BYTES = 1 << 20


class JournalError(Exception):
    """Typed refusal of a journal segment suffix.  Carries the segment
    path, the byte offset of the first refused record, and the reason —
    so a torn tail is distinguishable from a bit-flip in tests and in
    the flight recorder."""

    def __init__(self, segment: str, offset: int, reason: str):
        super().__init__(f"{segment} @ {offset}: {reason}")
        self.segment = segment
        self.offset = offset
        self.reason = reason


class JournalRecord(NamedTuple):
    seq: int          # global monotonic sequence number
    shard: int        # shard whose segment held the record
    kind: int         # REC_* constant
    body: bytes       # kind-specific payload
    segment: str      # segment path (diagnostics)
    offset: int       # byte offset of the record in its segment


def _write_varint(out: bytearray, value: int) -> None:
    assert value >= 0
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, cur: int, end: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if cur >= end:
            raise ValueError("varint truncated")
        b = buf[cur]
        cur += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, cur
        shift += 7
        if shift > 63:
            raise ValueError("varint overflow")


def _pack_str(out: bytearray, s: str) -> None:
    data = s.encode("utf-8")
    _write_varint(out, len(data))
    out += data


def _unpack_str(buf: bytes, cur: int, end: int) -> Tuple[str, int]:
    n, cur = _read_varint(buf, cur, end)
    if cur + n > end:
        raise ValueError("string truncated")
    return buf[cur:cur + n].decode("utf-8"), cur + n


def encode_local_body(doc_id: str, agent: str, pos: int, del_len: int,
                      ins_content: str, ordinal: int) -> bytes:
    out = bytearray()
    _pack_str(out, doc_id)
    _pack_str(out, agent)
    _write_varint(out, pos)
    _write_varint(out, del_len)
    _pack_str(out, ins_content)
    _write_varint(out, ordinal)
    return bytes(out)


def decode_local_body(body: bytes) -> Tuple[str, str, int, int, str, int]:
    end = len(body)
    doc_id, cur = _unpack_str(body, 0, end)
    agent, cur = _unpack_str(body, cur, end)
    pos, cur = _read_varint(body, cur, end)
    del_len, cur = _read_varint(body, cur, end)
    ins, cur = _unpack_str(body, cur, end)
    ordinal, cur = _read_varint(body, cur, end)
    return doc_id, agent, pos, del_len, ins, ordinal


def decode_frame_body(body: bytes) -> Tuple[str, bytes]:
    doc_id, cur = _unpack_str(body, 0, len(body))
    return doc_id, body[cur:]


def _segment_name(shard: int, index: int) -> str:
    return f"shard{shard}.{index:06d}.tcrj"


_SEGMENT_RE = re.compile(r"shard(\d+)\.(\d+)\.tcrj")


def _parse_segment_name(name: str) -> Optional[Tuple[int, int]]:
    """``(shard, index)`` of a segment file name; None for any other
    file (sidecars, strays)."""
    m = _SEGMENT_RE.fullmatch(name)
    return None if m is None else (int(m.group(1)), int(m.group(2)))


def _segment_header(shard: int) -> bytes:
    out = bytearray(JOURNAL_MAGIC)
    out.append(JOURNAL_VERSION)
    _write_varint(out, shard)
    return bytes(out)


class _ShardLog:
    """One shard's open segment: file handle, CRC chain state, and the
    rotation counter."""

    __slots__ = ("shard", "index", "path", "fh", "crc", "size")

    def __init__(self, shard: int):
        self.shard = shard
        self.index = 0
        self.path: Optional[str] = None
        self.fh: Optional[IO[bytes]] = None
        self.crc = 0
        self.size = 0


class Journal:
    """Append-side of the write-ahead journal.  One instance per
    ``DocServer``; ``None`` when ``ServeConfig.journal_dir`` is unset
    (journaling off — the shipped default for latency benches)."""

    def __init__(self, journal_dir: str, num_shards: int, *,
                 fsync_ticks: int = 1,
                 rotate_bytes: int = DEFAULT_ROTATE_BYTES,
                 counters=None, tracer=None):
        assert num_shards >= 1
        assert fsync_ticks >= 1
        self.dir = journal_dir
        self.num_shards = num_shards
        self.fsync_ticks = fsync_ticks
        self.rotate_bytes = rotate_bytes
        self.counters = counters
        self.tracer = tracer
        self._seq = 0
        self._suspended = 0
        self._closed = False
        os.makedirs(journal_dir, exist_ok=True)
        # Repair before anything else: truncate/quarantine any refused
        # suffix a crash left behind, so (a) the global sequence
        # continues past the last RECOVERABLE record (never reusing
        # sequence numbers) and (b) segments this reopen appends are
        # never dropped behind a stale torn segment on the next scan —
        # the double-crash data-loss hole.  The refusals stay loud:
        # counted and traced here, and ``DocServer.recover()`` folds
        # ``self.repair_errors`` into its replay stats and the flight
        # recorder.
        existing, self.repair_errors = repair(journal_dir)
        for err in self.repair_errors:
            self._count("journal_refusals")
            if self.tracer is not None:
                self.tracer.event("journal.repair", segment=err.segment,
                                  offset=err.offset, reason=err.reason)
        if existing:
            self._seq = existing[-1].seq + 1
        self._shards = [_ShardLog(s) for s in range(num_shards)]
        for log in self._shards:
            log.index = self._next_segment_index(log.shard)

    # -- plumbing ----------------------------------------------------

    def _next_segment_index(self, shard: int) -> int:
        top = -1
        for name in sorted(os.listdir(self.dir)):
            parsed = _parse_segment_name(name)
            if parsed is not None and parsed[0] == shard:
                top = max(top, parsed[1])
        return top + 1

    def _open_segment(self, log: _ShardLog) -> None:
        log.path = os.path.join(self.dir, _segment_name(log.shard,
                                                        log.index))
        log.fh = open(log.path, "wb")
        header = _segment_header(log.shard)
        log.fh.write(header)
        log.crc = 0
        log.size = len(header)
        self._count("journal_bytes", len(header))
        if self.tracer is not None:
            self.tracer.event("journal.segment", shard=log.shard,
                              seg=log.index, path=log.path)

    def _count(self, name: str, n: int = 1) -> None:
        if self.counters is not None:
            self.counters.incr(name, n)

    def _append(self, shard: int, kind: int, body: bytes) -> None:
        if self._suspended or self._closed:
            return
        log = self._shards[shard]
        if log.fh is None:
            self._open_segment(log)
        rec = bytearray()
        _write_varint(rec, self._seq)
        rec.append(kind)
        _write_varint(rec, len(body))
        rec += body
        crc = crc32c(bytes(rec), log.crc)
        rec += crc.to_bytes(4, "little")
        log.fh.write(rec)
        # Flush every append: the OS page cache survives a process
        # crash, which is the failure mode the chaos harness models.
        # fsync (power loss) is paced separately by TICK markers.
        log.fh.flush()
        log.crc = crc
        log.size += len(rec)
        self._seq += 1
        self._count("journal_records")
        self._count("journal_bytes", len(rec))
        if kind == REC_TICK and log.size >= self.rotate_bytes:
            # fsync before the handle goes away: ``tick()``'s cadenced
            # fsync loop only sees OPEN handles, so a rotated-out
            # segment's tail would otherwise never be fsynced — a
            # power-loss hole at exactly the rotating tick.
            os.fsync(log.fh.fileno())
            self._count("journal_fsyncs")
            log.fh.close()
            log.fh = None
            log.index += 1

    # -- append API --------------------------------------------------

    def admit(self, shard: int, doc_id: str) -> None:
        self._append(shard, REC_ADMIT, doc_id.encode("utf-8"))

    def txns(self, shard: int, doc_id: str, txns: Sequence) -> None:
        """Record fresh (non-duplicate) remote txns accepted for one
        doc, as one mux frame."""
        if not txns:
            return
        from ..common import txn_len
        from ..net import columnar
        body = columnar.encode_mux([(doc_id, list(txns))])
        self._append(shard, REC_TXNS, body)
        self._count("journal_ops", sum(txn_len(t) for t in txns))

    def local(self, shard: int, doc_id: str, agent: str, pos: int,
              del_len: int, ins_content: str, ordinal: int) -> None:
        self._append(shard, REC_LOCAL,
                     encode_local_body(doc_id, agent, pos, del_len,
                                       ins_content, ordinal))
        self._count("journal_ops", del_len + len(ins_content))

    def frame(self, shard: int, doc_id: str, data: bytes) -> None:
        """Record a control frame (REQUEST/DIGEST) verbatim: replay
        re-submits the same bytes through ``submit_frame``."""
        out = bytearray()
        _pack_str(out, doc_id)
        out += data
        self._append(shard, REC_FRAME, bytes(out))

    def poll(self, shard: int, doc_id: str) -> None:
        self._append(shard, REC_POLL, doc_id.encode("utf-8"))

    def tick(self, tick_no: int) -> None:
        """Mark a tick boundary on every shard's stream, then fsync at
        the configured cadence."""
        if self._suspended or self._closed:
            return
        body = bytearray()
        _write_varint(body, tick_no)
        for log in self._shards:
            self._append(log.shard, REC_TICK, bytes(body))
        if tick_no % self.fsync_ticks == 0:
            for log in self._shards:
                if log.fh is not None:
                    os.fsync(log.fh.fileno())
            self._count("journal_fsyncs")

    # -- lifecycle ---------------------------------------------------

    def suspend(self):
        """Context manager: appends no-op inside (used while recovery
        replays the journal through the normal submit path — replayed
        ops must not re-journal themselves)."""
        journal = self

        class _Suspend:
            def __enter__(self):
                journal._suspended += 1
                return journal

            def __exit__(self, *exc):
                journal._suspended -= 1
                return False

        return _Suspend()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for log in self._shards:
            if log.fh is not None:
                log.fh.flush()
                os.fsync(log.fh.fileno())
                log.fh.close()
                log.fh = None


# -- scan side -------------------------------------------------------

def _scan_segment(path: str, shard: int
                  ) -> Tuple[List[JournalRecord], Optional[JournalError]]:
    """Read one segment, returning the valid record prefix and the
    typed error that ended the read (``None`` on a clean EOF)."""
    with open(path, "rb") as fh:
        buf = fh.read()
    end = len(buf)
    header = _segment_header(shard)
    if buf[:len(JOURNAL_MAGIC)] != JOURNAL_MAGIC:
        return [], JournalError(path, 0, "bad magic")
    if end < len(header) or buf[:len(header)] != header:
        return [], JournalError(path, 0, "bad segment header")
    records: List[JournalRecord] = []
    cur = len(header)
    crc = 0
    while cur < end:
        start = cur
        try:
            seq, cur = _read_varint(buf, cur, end)
            if cur >= end:
                raise ValueError("record truncated at kind")
            kind = buf[cur]
            cur += 1
            if kind not in _KIND_NAMES:
                return records, JournalError(
                    path, start, f"unknown record kind {kind}")
            blen, cur = _read_varint(buf, cur, end)
            if cur + blen + 4 > end:
                raise ValueError("record body truncated")
            body = buf[cur:cur + blen]
            cur += blen
            want = crc32c(buf[start:cur], crc)
            got = int.from_bytes(buf[cur:cur + 4], "little")
            cur += 4
            if want != got:
                return records, JournalError(
                    path, start,
                    f"crc mismatch (want {want:08x}, got {got:08x})")
        except ValueError as exc:
            # Torn tail: the record was cut mid-write.  The prefix up
            # to ``start`` is intact (chain-CRC'd), keep it.
            return records, JournalError(path, start, f"torn record: {exc}")
        crc = want
        records.append(JournalRecord(seq, shard, kind, body, path, start))
    return records, None


def scan(journal_dir: str
         ) -> Tuple[List[JournalRecord], List[JournalError]]:
    """Read every shard's segments under ``journal_dir`` and merge the
    valid records into global-sequence order.

    Per shard, segments are read in index order; the first refused
    record ends that shard's stream — later segments of the same shard
    are dropped too and reported (within one append epoch their bytes
    were written after the refused ones, so keeping them would admit
    records whose prefix is gone).  ``repair`` — run at every
    ``Journal`` reopen — truncates/quarantines refused suffixes
    precisely so segments from a LATER epoch (post-recovery appends)
    are never dropped behind them.  The returned error list is the
    loud part: callers count and trace every entry."""
    records: List[JournalRecord] = []
    errors: List[JournalError] = []
    if not os.path.isdir(journal_dir):
        return records, errors
    by_shard: Dict[int, List[Tuple[int, str]]] = {}
    for name in sorted(os.listdir(journal_dir)):
        parsed = _parse_segment_name(name)
        if parsed is None:
            continue
        shard, idx = parsed
        by_shard.setdefault(shard, []).append(
            (idx, os.path.join(journal_dir, name)))
    for shard in sorted(by_shard):
        segs = sorted(by_shard[shard])
        broken = False
        for idx, path in segs:
            if broken:
                errors.append(JournalError(
                    path, 0, "dropped: earlier segment refused"))
                continue
            recs, err = _scan_segment(path, shard)
            records.extend(recs)
            if err is not None:
                errors.append(err)
                broken = True
    records.sort(key=lambda r: r.seq)
    return records, errors


def repair(journal_dir: str
           ) -> Tuple[List[JournalRecord], List[JournalError]]:
    """Scan, then make the disk AGREE with the scan: after repair, a
    fresh ``scan`` returns exactly the records this call returned and
    no errors.

    Without this, a reopened journal appends post-recovery records to
    NEW segments of a shard whose torn segment is still on disk — and
    the next scan, refusing the stale torn record first, would drop
    those fully durable later segments ("earlier segment refused").
    Recovery already discarded the refused suffix, so records written
    after it are causally independent of it and must survive a second
    crash.  ``Journal.__init__`` calls this on every reopen.

    Refused bytes are moved, never destroyed: a refused record suffix
    is cut from its segment into a ``<segment>.refused`` sidecar; a
    segment refused whole (bad header, or dropped behind an earlier
    refused segment of its shard — recovery never replayed it) is
    renamed to ``<segment>.refused``.  The ``.refused`` namespace is
    invisible to ``scan`` and to the segment-index allocator.

    Returns the same ``(records, errors)`` as the pre-repair scan."""
    records, errors = scan(journal_dir)
    for err in errors:
        if not os.path.exists(err.segment):
            continue
        if err.offset == 0:
            # Nothing in the segment was recovered (bad magic/header)
            # or nothing in it was replayed (dropped behind a refused
            # earlier segment): quarantine the whole file.
            os.replace(err.segment, err.segment + ".refused")
            continue
        with open(err.segment, "r+b") as fh:
            fh.seek(err.offset)
            tail = fh.read()
            with open(err.segment + ".refused", "wb") as side:
                side.write(tail)
            fh.truncate(err.offset)
            fh.flush()
            os.fsync(fh.fileno())
    return records, errors
