"""Binary wire codec for peer replication frames.

The reference's ``RemoteTxn``/``RemoteOp``/``RemoteId`` structs are the
only peer-portable history representation (`external_txn.rs:5-30`), but it
never serializes them. This codec puts them on an actual wire, following
automerge's columnar-binary playbook in spirit (compact varints, string
table, checksummed chunks) while keeping the frame layout
simple enough to audit byte-by-byte:

``frame := MAGIC(1B) VERSION(1B) varint(payload_len) payload CRC32C(4B LE)``

- the CRC32C (Castagnoli) covers *everything* before it — magic, version,
  the length varint and the payload — so any truncation or single-byte
  corruption anywhere in the frame is detected (CRC32 detects all burst
  errors up to 32 bits);
- agent names appear once per frame in a string table; every id in the
  body is a (table index, seq) varint pair (`README.md:33-35`: only the
  name strings are peer-portable — numeric ids and orders are peer-local);
- ``payload := kind(1B) body``: kind 0 carries a ``RemoteTxn`` batch,
  kinds 1/2 are the session layer's control messages (range REQUEST and
  watermark+state DIGEST, `net/session.py`).

Every malformed input raises ``CodecError`` with a precise message —
never an ``IndexError``/``UnicodeDecodeError``/assertion. Decoding is
hardened against adversarial lengths: varints are width-capped, declared
lengths are bounds-checked against the buffer before any allocation, and
the payload cursor must land exactly on the declared end.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple, Union

from ..common import (
    RemoteDel,
    RemoteId,
    RemoteIns,
    RemoteTxn,
    txn_len,
    validate_remote_txn,
)
from ..utils.integrity import crc32c

MAGIC = 0xC7
FRAME_VERSION = 1            # row-oriented body (this module)
FRAME_VERSION_COLUMNAR = 2   # columnar body (net/columnar.py)
_FRAME_VERSIONS = (FRAME_VERSION, FRAME_VERSION_COLUMNAR)

# Wire-format names (ServeConfig.wire_format / session knobs) -> TXNS
# encoder.  Decoding needs no selection: ``decode_frame`` negotiates on
# the version byte, so peers on different formats interoperate.
WIRE_FORMATS = ("row", "columnar")


def txns_encoder(wire: str):
    """The ``encode_txns`` implementation for a wire-format name."""
    if wire == "row":
        return encode_txns
    if wire == "columnar":
        from . import columnar
        return columnar.encode_txns
    raise ValueError(f"unknown wire format {wire!r}; one of {WIRE_FORMATS}")

# Frame kinds (first payload byte).
KIND_TXNS = 0      # batch of RemoteTxns
KIND_REQUEST = 1   # per-agent "send me seqs >= from_seq" wants
KIND_DIGEST = 2    # per-agent watermarks + portable state digest
KIND_TXNS_MUX = 3  # v2 only: many docs' txn batches on one connection

_MAX_PAYLOAD = 1 << 28   # 256 MiB: reject absurd declared lengths early
_MAX_NAME_BYTES = 4096   # agent names are human-scale identifiers
_MAX_VARINT_BYTES = 10   # 64-bit LEB128
_U32_MAX = 0xFFFF_FFFF


class CodecError(ValueError):
    """A frame failed validation (framing, CRC, version, or body shape).

    The recoverable rejection path: the session layer counts it and
    re-requests the range; it must never surface as a crash.

    When the failure is txn-level (the frame decoded but a txn failed
    ``validate_remote_txn``), ``agent``/``seq``/``n`` name the offending
    span so the reject trace event can carry the op's identity —
    structurally-undecodable frames leave them ``None``
    (there is no span to name)."""

    def __init__(self, message: str, *, agent=None, seq=None, n=None):
        super().__init__(message)
        self.agent = agent
        self.seq = seq
        self.n = n


# -- varints -----------------------------------------------------------------

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
    value = 0
    shift = 0
    for _ in range(_MAX_VARINT_BYTES):
        if cur >= end:
            raise CodecError("truncated varint")
        b = buf[cur]
        cur += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, cur
        shift += 7
    raise CodecError("varint too long")


# -- string table ------------------------------------------------------------

class _NameTable:
    """First-seen-order agent-name table for one frame."""

    def __init__(self) -> None:
        self.names: List[str] = []
        self._ids: Dict[str, int] = {}

    def idx(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self.names)
            self.names.append(name)
        return i


def _collect_names(txns: Sequence[RemoteTxn]) -> _NameTable:
    table = _NameTable()
    for txn in txns:
        table.idx(txn.id.agent)
        for p in txn.parents:
            table.idx(p.agent)
        for op in txn.ops:
            if isinstance(op, RemoteIns):
                table.idx(op.origin_left.agent)
                table.idx(op.origin_right.agent)
            else:
                table.idx(op.id.agent)
    return table


def _write_str(out: bytearray, s: str) -> None:
    raw = s.encode("utf-8")
    _write_varint(out, len(raw))
    out += raw


def _read_str(buf: bytes, cur: int, end: int, what: str,
              max_bytes: int = _MAX_PAYLOAD) -> Tuple[str, int]:
    """One length-prefixed UTF-8 string, bounds-checked; the single
    hardening point for every string the wire carries."""
    ln, cur = _read_varint(buf, cur, end)
    if ln > max_bytes:
        raise CodecError(f"{what} of {ln} bytes exceeds cap {max_bytes}")
    if ln > end - cur:
        raise CodecError(f"truncated {what}")
    try:
        s = buf[cur:cur + ln].decode("utf-8")
    except UnicodeDecodeError as e:
        raise CodecError(f"{what} not utf-8: {e}") from None
    return s, cur + ln


def _check_name(name: str) -> str:
    """Encode-side twin of the decoder's name cap: emitting an oversized
    name would produce frames every compliant peer rejects — fail fast at
    the source instead of poisoning the re-request cycle."""
    if len(name.encode("utf-8")) > _MAX_NAME_BYTES:
        raise CodecError(
            f"agent name of {len(name.encode('utf-8'))} bytes exceeds "
            f"cap {_MAX_NAME_BYTES}")
    return name


def _write_names(out: bytearray, names: Sequence[str]) -> None:
    _write_varint(out, len(names))
    for name in names:
        _write_str(out, _check_name(name))


def _read_names(buf: bytes, cur: int, end: int) -> Tuple[List[str], int]:
    count, cur = _read_varint(buf, cur, end)
    if count > end - cur:  # each name costs >= 1 byte
        raise CodecError("name table longer than payload")
    names: List[str] = []
    for _ in range(count):
        name, cur = _read_str(buf, cur, end, "agent name",
                              max_bytes=_MAX_NAME_BYTES)
        names.append(name)
    return names, cur


def _write_rid(out: bytearray, table: _NameTable, rid: RemoteId) -> None:
    _write_varint(out, table.idx(rid.agent))
    _write_varint(out, rid.seq)


def _read_rid(buf: bytes, cur: int, end: int,
              names: Sequence[str]) -> Tuple[RemoteId, int]:
    idx, cur = _read_varint(buf, cur, end)
    if idx >= len(names):
        raise CodecError(f"agent index {idx} out of table range {len(names)}")
    seq, cur = _read_varint(buf, cur, end)
    if seq > _U32_MAX:
        raise CodecError(f"seq {seq} exceeds u32")
    return RemoteId(names[idx], seq), cur


# -- framing -----------------------------------------------------------------

def _frame(payload: bytes, version: int = FRAME_VERSION) -> bytes:
    out = bytearray([MAGIC, version])
    _write_varint(out, len(payload))
    out += payload
    out += struct.pack("<I", crc32c(bytes(out)))
    return bytes(out)


class FrameInfo:
    """Frame-layer metadata ``decode_frame_ex`` plumbs through to the
    receiver: the stored CRC32C doubles as a content-derived
    **frame id** — deterministic across same-seed runs, identical for a
    dup-delivered frame — so per-op flow events can name WHICH frame
    carried a span without any wire-format change."""

    __slots__ = ("version", "crc", "length")

    def __init__(self, version: int, crc: int, length: int):
        self.version = version
        self.crc = crc
        self.length = length


def _unframe(buf: bytes, offset: int) -> Tuple[int, bytes, int]:
    """Validate one frame at ``offset``; return
    ``(version, payload, next_offset)``."""
    total = len(buf)
    if offset >= total:
        raise CodecError("empty input")
    if buf[offset] != MAGIC:
        raise CodecError(f"bad magic byte 0x{buf[offset]:02x}")
    if offset + 2 > total:
        raise CodecError("truncated header")
    ln, cur = _read_varint(buf, offset + 2, total)
    if ln > _MAX_PAYLOAD:
        raise CodecError(f"declared payload length {ln} too large")
    payload_end = cur + ln
    if payload_end + 4 > total:
        raise CodecError("frame truncated (payload or CRC missing)")
    stored = struct.unpack_from("<I", buf, payload_end)[0]
    computed = crc32c(bytes(buf[offset:payload_end]))
    if stored != computed:
        raise CodecError(
            f"CRC mismatch: stored {stored:#010x} != computed {computed:#010x}")
    # Version is checked after the CRC: a corrupted version byte reports as
    # a CRC failure; a *valid* frame from a future format reports here.
    if buf[offset + 1] not in _FRAME_VERSIONS:
        raise CodecError(f"unsupported frame version {buf[offset + 1]}")
    return buf[offset + 1], bytes(buf[cur:payload_end]), payload_end + 4


# -- KIND_TXNS ---------------------------------------------------------------

def encode_txns(txns: Sequence[RemoteTxn]) -> bytes:
    """One frame carrying a ``RemoteTxn`` batch."""
    for txn in txns:
        validate_remote_txn(txn)
    table = _collect_names(txns)
    body = bytearray([KIND_TXNS])
    _write_names(body, table.names)
    _write_varint(body, len(txns))
    for txn in txns:
        _write_rid(body, table, txn.id)
        _write_varint(body, len(txn.parents))
        for p in txn.parents:
            _write_rid(body, table, p)
        _write_varint(body, len(txn.ops))
        for op in txn.ops:
            if isinstance(op, RemoteIns):
                body.append(0)
                _write_rid(body, table, op.origin_left)
                _write_rid(body, table, op.origin_right)
                _write_str(body, op.ins_content)
            else:
                body.append(1)
                _write_rid(body, table, op.id)
                _write_varint(body, op.len)
    return _frame(bytes(body))


def _decode_txns(buf: bytes, cur: int, end: int) -> List[RemoteTxn]:
    names, cur = _read_names(buf, cur, end)
    count, cur = _read_varint(buf, cur, end)
    if count > end - cur:  # each txn costs >= 1 byte
        raise CodecError("txn count longer than payload")
    txns: List[RemoteTxn] = []
    for _ in range(count):
        tid, cur = _read_rid(buf, cur, end, names)
        n_parents, cur = _read_varint(buf, cur, end)
        if n_parents > end - cur:
            raise CodecError("parent count longer than payload")
        parents: List[RemoteId] = []
        for _ in range(n_parents):
            p, cur = _read_rid(buf, cur, end, names)
            parents.append(p)
        n_ops, cur = _read_varint(buf, cur, end)
        if n_ops > end - cur:
            raise CodecError("op count longer than payload")
        ops: List[Union[RemoteIns, RemoteDel]] = []
        for _ in range(n_ops):
            if cur >= end:
                raise CodecError("truncated op tag")
            tag = buf[cur]
            cur += 1
            if tag == 0:
                ol, cur = _read_rid(buf, cur, end, names)
                orr, cur = _read_rid(buf, cur, end, names)
                content, cur = _read_str(buf, cur, end, "insert content")
                ops.append(RemoteIns(ol, orr, content))
            elif tag == 1:
                rid, cur = _read_rid(buf, cur, end, names)
                ln, cur = _read_varint(buf, cur, end)
                # Cap like seqs: an unchecked huge length would poison the
                # receiver's per-agent watermark (seq + len) forever.
                if ln > _U32_MAX or rid.seq + ln > _U32_MAX + 1:
                    raise CodecError(f"delete length {ln} exceeds u32 range")
                ops.append(RemoteDel(rid, ln))
            else:
                raise CodecError(f"unknown op tag {tag}")
        txn = RemoteTxn(tid, parents, ops)
        try:
            validate_remote_txn(txn)
        except ValueError as e:
            # Name the offending span: the frame's bytes were sound, so
            # the op's identity is known and the reject can carry it.
            raise CodecError(f"invalid txn: {e}", agent=tid.agent,
                             seq=tid.seq, n=txn_len(txn)) from None
        txns.append(txn)
    if cur != end:
        raise CodecError(f"{end - cur} trailing bytes after txn batch")
    return txns


# -- KIND_REQUEST / KIND_DIGEST ----------------------------------------------

def _write_name_map(body: bytearray, mapping: Dict[str, int]) -> None:
    _write_varint(body, len(mapping))
    for name in sorted(mapping):
        _write_str(body, _check_name(name))
        _write_varint(body, mapping[name])


def encode_request(wants: Dict[str, int]) -> bytes:
    """REQUEST frame: for each agent name, "send me seqs >= from_seq"."""
    body = bytearray([KIND_REQUEST])
    _write_name_map(body, wants)
    return _frame(bytes(body))


def encode_digest(watermarks: Dict[str, int], digest: int) -> bytes:
    """DIGEST frame: per-agent next-seq watermarks + portable state digest
    (``models.sync.state_digest``)."""
    body = bytearray([KIND_DIGEST])
    _write_name_map(body, watermarks)
    body += struct.pack("<I", digest & _U32_MAX)
    return _frame(bytes(body))


def _decode_name_map(buf: bytes, cur: int, end: int
                     ) -> Tuple[Dict[str, int], int]:
    count, cur = _read_varint(buf, cur, end)
    if count > end - cur:
        raise CodecError("map longer than payload")
    out: Dict[str, int] = {}
    for _ in range(count):
        name, cur = _read_str(buf, cur, end, "agent name",
                              max_bytes=_MAX_NAME_BYTES)
        seq, cur = _read_varint(buf, cur, end)
        if seq > _U32_MAX:
            raise CodecError(f"seq {seq} exceeds u32")
        out[name] = seq
    return out, cur


# -- public decode -----------------------------------------------------------

def decode_frame(buf: bytes, offset: int = 0):
    """Decode ONE frame at ``offset``.

    Returns ``(kind, value, next_offset)`` where ``value`` is a txn list
    (KIND_TXNS), a wants dict (KIND_REQUEST), or a ``(watermarks, digest)``
    pair (KIND_DIGEST). Raises ``CodecError`` on any malformed input.
    """
    kind, value, next_offset, _info = decode_frame_ex(buf, offset)
    return kind, value, next_offset


def decode_frame_ex(buf: bytes, offset: int = 0):
    """``decode_frame`` plus a ``FrameInfo`` fourth element: the
    receiver-side frame-id plumb-through (the stored CRC32C, already
    verified by ``_unframe``) for flow provenance and audit logs."""
    version, payload, next_offset = _unframe(buf, offset)
    info = FrameInfo(version,
                     struct.unpack_from("<I", buf, next_offset - 4)[0],
                     next_offset - offset)
    if not payload:
        raise CodecError("empty payload")
    kind = payload[0]
    cur, end = 1, len(payload)
    if version == FRAME_VERSION_COLUMNAR:
        # Version 2 defines only the columnar TXNS bodies; control
        # frames (REQUEST/DIGEST) stay version 1 — they are name maps
        # with no columnar gear to gain.
        from . import columnar
        if kind == KIND_TXNS:
            return KIND_TXNS, columnar.decode_txns(payload, cur, end), \
                next_offset, info
        if kind == KIND_TXNS_MUX:
            return KIND_TXNS_MUX, \
                columnar.decode_txns_mux(payload, cur, end), \
                next_offset, info
        raise CodecError(f"frame kind {kind} not defined for version 2")
    if kind == KIND_TXNS:
        return KIND_TXNS, _decode_txns(payload, cur, end), \
            next_offset, info
    if kind == KIND_REQUEST:
        wants, cur = _decode_name_map(payload, cur, end)
        if cur != end:
            raise CodecError("trailing bytes after request")
        return KIND_REQUEST, wants, next_offset, info
    if kind == KIND_DIGEST:
        marks, cur = _decode_name_map(payload, cur, end)
        if cur + 4 != end:
            raise CodecError("bad digest trailer")
        digest = struct.unpack_from("<I", payload, cur)[0]
        return KIND_DIGEST, (marks, digest), next_offset, info
    raise CodecError(f"unknown frame kind {kind}")


def decode_frames(buf: bytes) -> List[Tuple[int, object]]:
    """Decode a back-to-back frame stream; ``[(kind, value), ...]``."""
    out: List[Tuple[int, object]] = []
    offset = 0
    while offset < len(buf):
        kind, value, offset = decode_frame(buf, offset)
        out.append((kind, value))
    return out
