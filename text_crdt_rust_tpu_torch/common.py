"""Core scalar types, sentinels and plain-data op structs (counterpart of
``text_crdt_rust_tpu/common.py:20-100``).

- Agent ids are dense u16 ints, peer-local (`common.rs:5-13`).
- ``CRDTLocation`` = (agent, seq) names one item globally (`common.rs:16-28`).
- Orders are dense u32 op ids, local to this peer (`list/mod.rs:29-30`).
- ``RemoteTxn`` / ``RemoteOp`` / ``RemoteId`` are the only peer-portable,
  agent-name-carrying structs (`external_txn.rs:5-30`): numeric ids are
  peer-local, so only strings cross the wire.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Union

# u32::MAX — the virtual "root" item every initial insert attaches to
# (`list/mod.rs:30`).
ROOT_ORDER: int = 0xFFFF_FFFF

# u16::MAX — invalid / ROOT agent id (`common.rs:13`, `doc.rs:68`).
CLIENT_INVALID: int = 0xFFFF

# u32 arithmetic mask for device parity (orders are u32 on device).
U32_MASK: int = 0xFFFF_FFFF


@dataclass(frozen=True)
class CRDTLocation:
    """(agent, seq) pair naming one inserted item (`common.rs:16-28`)."""

    agent: int = CLIENT_INVALID
    seq: int = 0xFFFF_FFFF


# The root location sentinel (`common.rs:30-33`).
CRDT_DOC_ROOT = CRDTLocation(agent=CLIENT_INVALID, seq=0)


@dataclass
class LocalOp:
    """One local edit: delete ``del_span`` chars at ``pos``, then insert
    ``ins_content`` at ``pos`` (`common.rs:46-50`)."""

    pos: int
    ins_content: str = ""
    del_span: int = 0


@dataclass(frozen=True)
class RemoteId:
    """Peer-portable item id: agent named by string (`external_txn.rs:6-9`)."""

    agent: str
    seq: int


ROOT_REMOTE_ID = RemoteId(agent="ROOT", seq=0xFFFF_FFFF)


@dataclass
class RemoteIns:
    """Remote insert run (`external_txn.rs:13-17`)."""

    origin_left: RemoteId
    origin_right: RemoteId
    ins_content: str


@dataclass
class RemoteDel:
    """Remote delete of ``len`` items starting at ``id`` (`external_txn.rs:19-22`)."""

    id: RemoteId
    len: int


RemoteOp = Union[RemoteIns, RemoteDel]


@dataclass
class RemoteTxn:
    """Peer-portable transaction (`external_txn.rs:25-30`)."""

    id: RemoteId
    parents: List[RemoteId] = field(default_factory=list)
    ops: List[RemoteOp] = field(default_factory=list)


def txn_len(txn: RemoteTxn) -> int:
    """Total item count of a txn = seqs it consumes (`doc.rs:252-257`):
    inserts consume one seq per char, deletes one per deleted item."""
    return sum(
        len(op.ins_content) if isinstance(op, RemoteIns) else op.len
        for op in txn.ops
    )
