"""CRC32C (Castagnoli) — the wire-frame integrity primitive.

Used by the wire codec (`net/codec.py`, per-frame checksums). zlib only
ships CRC32 (IEEE); CRC32C is the variant with hardware support on
modern CPUs and the one automerge/gRPC/iSCSI use. A 256-entry table is
plenty fast for frame-sized inputs and keeps the tree dependency-free.
(The checkpoint store deliberately uses ``zlib.crc32`` instead — its
inputs are MB-scale arrays where a pure-Python byte loop would dominate
save/load; see ``utils/checkpoint.py::_content_crc``.) Lives in
``utils`` (imports nothing) so any consumer can use it without an
import cycle.
"""
from __future__ import annotations

from typing import List

_U32_MAX = 0xFFFF_FFFF


def _make_table() -> List[int]:
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C checksum of ``data`` (optionally continuing ``crc``)."""
    crc ^= _U32_MAX
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ _U32_MAX
