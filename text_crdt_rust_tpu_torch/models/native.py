"""ctypes wrapper of the native C++ document engine (counterpart of
``text_crdt_rust_tpu/models/native.py``).

The native engine is the single-core CPU baseline (`BASELINE.md` row 1)
that every device replay is judged against, and a second host reference
beside the oracle. ``NativeListCRDT`` has the oracle's API for the subset
the baselines and differential tests use; ``rope_replay`` is the
text-only lower bound.

Remote txns are resolved here before the C call (agent names -> local
ids, remote ids -> orders for insert origins; delete targets stay
(agent, seq) pairs, which the engine walks in seq space) and passed to
the C interface as flat arrays.
"""
from __future__ import annotations

import ctypes as ct
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
from ..native.build import build
from ..utils.rle import merge_yjs_spans

_lib = None


def _load():
    """The engine's library, built and typed at first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ct.CDLL(build())
    u32 = ct.c_uint32
    p32 = ct.POINTER(ct.c_uint32)
    pi32 = ct.POINTER(ct.c_int32)
    lib.tcr_new.restype = ct.c_void_p
    lib.tcr_new.argtypes = []
    lib.tcr_free.restype = None
    lib.tcr_free.argtypes = [ct.c_void_p]
    lib.tcr_last_error.restype = ct.c_char_p
    lib.tcr_last_error.argtypes = [ct.c_void_p]
    lib.tcr_get_or_create_agent.restype = u32
    lib.tcr_get_or_create_agent.argtypes = [ct.c_void_p, ct.c_char_p]
    lib.tcr_agent_id.restype = ct.c_int
    lib.tcr_agent_id.argtypes = [ct.c_void_p, ct.c_char_p]
    for name in ("tcr_len", "tcr_raw_len", "tcr_next_order", "tcr_num_spans"):
        fn = getattr(lib, name)
        fn.restype = u32
        fn.argtypes = [ct.c_void_p]
    lib.tcr_apply_local_txn.restype = ct.c_int
    lib.tcr_apply_local_txn.argtypes = [ct.c_void_p, u32, u32, p32, p32, p32,
                                        p32]
    lib.tcr_apply_remote_txn.restype = ct.c_int
    lib.tcr_apply_remote_txn.argtypes = [
        ct.c_void_p, u32, u32, p32, u32, u32, p32, p32, p32, p32, p32]
    lib.tcr_seq_to_order.restype = u32
    lib.tcr_seq_to_order.argtypes = [ct.c_void_p, u32, u32]
    lib.tcr_get_spans.restype = u32
    lib.tcr_get_spans.argtypes = [ct.c_void_p, p32, p32, p32, pi32, u32]
    lib.tcr_get_frontier.restype = u32
    lib.tcr_get_frontier.argtypes = [ct.c_void_p, p32, u32]
    lib.tcr_get_deletes.restype = u32
    lib.tcr_get_deletes.argtypes = [ct.c_void_p, p32, p32, p32, u32]
    lib.tcr_get_double_deletes.restype = u32
    lib.tcr_get_double_deletes.argtypes = [ct.c_void_p, p32, p32, p32, u32]
    lib.tcr_text_utf8.restype = u32
    lib.tcr_text_utf8.argtypes = [ct.c_void_p, ct.c_char_p, u32]
    lib.tcr_replay_trace.restype = ct.c_int
    lib.tcr_replay_trace.argtypes = [ct.c_void_p, u32, u32, p32, p32, p32,
                                     p32]
    lib.tcr_rope_replay.restype = ct.c_longlong
    lib.tcr_rope_replay.argtypes = [u32, p32, p32, p32, p32, p32, u32]
    lib.tcr_memory_bytes.restype = ct.c_ulonglong
    lib.tcr_memory_bytes.argtypes = [ct.c_void_p]
    _lib = lib
    return lib


def _u32arr(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint32))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_uint32))


def _cps(s: str) -> np.ndarray:
    if not s:
        return np.zeros(0, dtype=np.uint32)
    return np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32)


class NativeListCRDT:
    """A native-engine document with the oracle's API subset."""

    def __init__(self):
        self._lib = _load()
        self._doc = self._lib.tcr_new()

    def __del__(self):
        doc = getattr(self, "_doc", None)
        if doc:
            self._doc = None
            self._lib.tcr_free(doc)

    def _check(self, rc: int) -> None:
        if rc != 0:
            msg = self._lib.tcr_last_error(self._doc).decode()
            raise AssertionError(f"native engine error: {msg}")

    # -- agents ---------------------------------------------------------

    def get_or_create_agent_id(self, name: str) -> int:
        aid = self._lib.tcr_get_or_create_agent(self._doc, name.encode())
        return CLIENT_INVALID if aid == 0xFFFFFFFF else aid

    def get_agent_id(self, name: str) -> Optional[int]:
        aid = self._lib.tcr_agent_id(self._doc, name.encode())
        if aid == -2:
            return None
        return CLIENT_INVALID if aid == -1 else aid

    # -- edits ----------------------------------------------------------

    def apply_local_txn(self, agent: int, local_ops: List[LocalOp]) -> None:
        pos = _u32arr([op.pos for op in local_ops])
        dels = _u32arr([op.del_span for op in local_ops])
        ins_lens = _u32arr([len(op.ins_content) for op in local_ops])
        cps = _u32arr(np.concatenate([_cps(op.ins_content)
                                      for op in local_ops])
                      if local_ops else np.zeros(0, dtype=np.uint32))
        self._check(self._lib.tcr_apply_local_txn(
            self._doc, agent, len(local_ops), _ptr(pos), _ptr(dels),
            _ptr(ins_lens), _ptr(cps)))

    def local_insert(self, agent: int, pos: int, content: str) -> None:
        self.apply_local_txn(agent, [LocalOp(pos=pos, ins_content=content)])

    def local_delete(self, agent: int, pos: int, del_span: int) -> None:
        self.apply_local_txn(agent, [LocalOp(pos=pos, del_span=del_span)])

    def _rid_to_order(self, rid: RemoteId) -> int:
        aid = self.get_agent_id(rid.agent)
        if aid is None:
            raise AssertionError(f"unknown agent {rid.agent!r}")
        if aid == CLIENT_INVALID:
            return ROOT_ORDER
        o = self._lib.tcr_seq_to_order(self._doc, aid, rid.seq)
        if o == ROOT_ORDER:
            raise AssertionError(f"unknown seq {rid.seq} for {rid.agent!r}")
        return o

    def apply_remote_txn(self, txn: RemoteTxn) -> None:
        agent = self.get_or_create_agent_id(txn.id.agent)
        if agent == CLIENT_INVALID:
            raise AssertionError("ROOT cannot author txns")
        txn_len = sum(len(op.ins_content) if isinstance(op, RemoteIns)
                      else op.len for op in txn.ops)
        first_order = self.get_next_order()

        def rid_order(rid: RemoteId) -> int:
            if rid.agent == "ROOT":
                return ROOT_ORDER
            # A reference into this txn: the engine assigns the txn's
            # order range on entry (`doc.rs:265-269`), so seqs inside
            # [txn.id.seq, txn.id.seq + txn_len) map to
            # first_order + (seq - txn.id.seq) before the C call runs.
            if rid.agent == txn.id.agent and \
                    txn.id.seq <= rid.seq < txn.id.seq + txn_len:
                return first_order + (rid.seq - txn.id.seq)
            return self._rid_to_order(rid)

        parents = _u32arr([rid_order(p) for p in txn.parents])
        kinds, A, B, L = [], [], [], []
        cps_list = []
        for op in txn.ops:
            if isinstance(op, RemoteIns):
                kinds.append(0)
                A.append(rid_order(op.origin_left))
                B.append(rid_order(op.origin_right))
                L.append(len(op.ins_content))
                cps_list.append(_cps(op.ins_content))
            elif isinstance(op, RemoteDel):
                t_aid = self.get_agent_id(op.id.agent)
                if t_aid is None or t_aid == CLIENT_INVALID:
                    raise AssertionError(
                        f"delete of an unknown agent {op.id.agent!r}")
                kinds.append(1)
                A.append(t_aid)
                B.append(op.id.seq)
                L.append(op.len)
            else:
                raise TypeError(f"not a remote op: {op!r}")
        cps = np.concatenate(cps_list) if cps_list else np.zeros(0, np.uint32)
        self._check(self._lib.tcr_apply_remote_txn(
            self._doc, agent, txn.id.seq, _ptr(parents), len(parents),
            len(kinds), _ptr(_u32arr(kinds)), _ptr(_u32arr(A)),
            _ptr(_u32arr(B)), _ptr(_u32arr(L)), _ptr(_u32arr(cps))))

    def replay_trace(self, agent: int, pos, dels, ins_lens, cps) -> None:
        """Replay a flattened local-edit trace in one native call (the
        `benches/yjs.rs:32-49` workload)."""
        pos, dels, ins_lens, cps = map(_u32arr, (pos, dels, ins_lens, cps))
        rc = self._lib.tcr_replay_trace(
            self._doc, agent, len(pos), _ptr(pos), _ptr(dels), _ptr(ins_lens),
            _ptr(cps))
        self._check(0 if rc == 0 else -1)

    # -- read-back ------------------------------------------------------

    def __len__(self) -> int:
        return self._lib.tcr_len(self._doc)

    def raw_len(self) -> int:
        return self._lib.tcr_raw_len(self._doc)

    def num_spans(self) -> int:
        return self._lib.tcr_num_spans(self._doc)

    def memory_bytes(self) -> int:
        """The document's allocation (the `alloc.rs:40-50` TracingAlloc
        role): every live vector and map buffer."""
        return self._lib.tcr_memory_bytes(self._doc)

    def get_next_order(self) -> int:
        return self._lib.tcr_next_order(self._doc)

    def to_string(self) -> str:
        n = self._lib.tcr_text_utf8(self._doc, None, 0)
        buf = ct.create_string_buffer(n)
        self._lib.tcr_text_utf8(self._doc, buf, n)
        return buf.raw[:n].decode("utf-8")

    def doc_spans(self) -> List[Tuple[int, int, int, int]]:
        """The document body as maximally merged YjsSpan tuples (the
        oracle's ``doc_spans`` form; merge predicate `span.rs:47-53`)."""
        n = self._lib.tcr_get_spans(self._doc, None, None, None, None, 0)
        order = np.zeros(n, np.uint32)
        ol = np.zeros(n, np.uint32)
        orr = np.zeros(n, np.uint32)
        ln = np.zeros(n, np.int32)
        self._lib.tcr_get_spans(
            self._doc, _ptr(order), _ptr(ol), _ptr(orr),
            ln.ctypes.data_as(ct.POINTER(ct.c_int32)), n)
        return merge_yjs_spans(
            (int(order[i]), int(ol[i]), int(orr[i]), int(ln[i]))
            for i in range(n))

    @property
    def frontier(self) -> List[int]:
        n = self._lib.tcr_get_frontier(self._doc, None, 0)
        buf = np.zeros(n, np.uint32)
        self._lib.tcr_get_frontier(self._doc, _ptr(buf), n)
        return [int(x) for x in buf]

    def deletes_entries(self) -> List[Tuple[int, int, int]]:
        n = self._lib.tcr_get_deletes(self._doc, None, None, None, 0)
        a, b, c = (np.zeros(n, np.uint32) for _ in range(3))
        self._lib.tcr_get_deletes(self._doc, _ptr(a), _ptr(b), _ptr(c), n)
        return [(int(a[i]), int(b[i]), int(c[i])) for i in range(n)]

    def double_deletes_entries(self) -> List[Tuple[int, int, int]]:
        n = self._lib.tcr_get_double_deletes(self._doc, None, None, None, 0)
        a, b, c = (np.zeros(n, np.uint32) for _ in range(3))
        self._lib.tcr_get_double_deletes(self._doc, _ptr(a), _ptr(b),
                                         _ptr(c), n)
        return [(int(a[i]), int(b[i]), int(c[i])) for i in range(n)]


def rope_replay(pos, dels, ins_lens, cps, want_content: bool = True):
    """Text-only gap-buffer replay (the `benches/ropey.rs:12-38` analog):
    the lower bound the CRDT numbers are judged against, the same edit
    stream with no CRDT metadata. Returns ``(final_len, content or
    None)``; raises ``RuntimeError`` on a patch out of range."""
    lib = _load()
    pos, dels, ins_lens, cps = map(_u32arr, (pos, dels, ins_lens, cps))
    cap = int(cps.size) + 16
    out = np.zeros(cap, np.uint32) if want_content else None
    n = lib.tcr_rope_replay(len(pos), _ptr(pos), _ptr(dels), _ptr(ins_lens),
                            _ptr(cps), _ptr(out) if want_content else None,
                            cap if want_content else 0)
    if n < 0:
        raise RuntimeError("rope replay: patch out of range")
    content = None
    if want_content:
        content = out[:n].tobytes().decode("utf-32-le")
    return int(n), content
