"""Core sentinels (counterpart of ``text_crdt_rust_tpu/common.py:20-28``).

The remote-transaction dataclasses come with the remote-op slice.
"""
from __future__ import annotations

# u32::MAX — the virtual "root" item every initial insert attaches to
# (`list/mod.rs:30`).
ROOT_ORDER: int = 0xFFFF_FFFF

# u16::MAX — invalid / ROOT agent id (`common.rs:13`, `doc.rs:68`).
CLIENT_INVALID: int = 0xFFFF

# u32 arithmetic mask for device parity (orders are u32 on device).
U32_MASK: int = 0xFFFF_FFFF
