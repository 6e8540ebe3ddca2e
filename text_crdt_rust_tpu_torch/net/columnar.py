"""Columnar TXNS wire format (frame version 2) — the automerge gear.

The row codec (``net/codec.py``, frame version 1) spends most of its
bytes on per-op structure: every txn repeats ids, parents, origins and
lengths inline, so a single-char edit costs ~15-20 wire bytes.  The
automerge binary document format shows the next gear: strip
the structure out into **columns**, delta-code each column against a
cheap predictor, and run-length-encode the residuals — whole columns of
"the obvious value" collapse to a few bytes, and what remains is close
to the information actually carried.

Frame layout (outer framing identical to v1 — same MAGIC, varint
length, trailing CRC32C over *everything* before it — only the version
byte differs, which is how old row frames keep decoding side by side):

``frame := MAGIC(1B) VERSION=2(1B) varint(payload_len) payload CRC32C``
``payload := kind(1B) flags(1B) body``
``body(TXNS) := names varint(n_txns) varint(n_chunks) chunk*``
``body(TXNS_MUX) := docnames names varint(n_txns) varint(n_chunks) chunk*``
``chunk := (col_id << 1 | enc)(1B) varint(byte_len) bytes``

``flags`` bit 0 set means the body (everything after the flags byte)
is one DEFLATE stream prefixed by ``varint(raw_len)`` — the automerge
compressed-chunk trick lifted to the whole frame, which is what makes
the per-frame name tables (hundreds of ``d0123.a0``-shaped agent names
on a multiplexed connection) nearly free.

The **TXNS_MUX** body is the connection-level multiplexed form: one
frame carries many documents' txn batches, each txn tagged by a
``DOC`` column index into a doc-id string table.  Per-doc frames pay
the fixed frame + name-table + chunk-header cost per *document*; a
replication link (edge aggregator, shard-to-shard migration) pays it
once per *window* — on the 200-doc loadgen this is the difference
between a ~3x and a >5x bytes-per-op cut, because the Zipf cold tail
is all overhead.

A chunk's ``bytes`` (after undoing ``enc``: 0 = raw, 1 = DEFLATE — the
encoder picks whichever is smaller, per chunk) are RLE runs over
zigzag-LEB128 **residuals**:

``runs := { varint(run_len) varint(zigzag(residual)) }*``

and each column's residual is its value minus a *predictor* the decoder
can reconstruct: the PER-AGENT seq chain for ``T_SEQ`` (an agent's next
txn seq is its last seq + length — a linear history collapses to one
run of zeros), ``author`` for parent/origin agent indices, the parent
agent's own previous txn seq for parent seqs (a linear continuation or
a just-carried merge point costs ~0), the txn's own emission cursor
``seq + chars_emitted - 1`` for an origin-left on the author's OWN
chain (a typing run is all zeros), previous-value chains for foreign
origin-lefts and all origin-rights (a run typed into existing text
keeps one successor char), the previous delete's ``seq+len`` for delete
targets (a sweep chains), and the ROOT sentinel seq wherever the
origin's *agent* already says ROOT (tail appends would otherwise pay a
5-byte varint each).  Insert content rides as one concatenated
codepoint column.  Count-like columns predict their modal value
(1 parent, 1 op) as the chain seed.
A column whose residuals are ALL ZERO — every value perfectly
predicted, the common case for whole columns of a single-agent frame —
is simply absent, as is an empty one: the decoder reconstructs an
absent column as pure prediction.

Hard-rejection contract (the row wire's, kept bit for bit): the outer CRC32C
covers every chunk, so ANY corruption — including truncation mid-column
-chunk — is a typed ``CodecError``; on top of that the body is
structurally validated (runs must land exactly on the expected count,
indices/seqs/lengths are range-checked, every decoded txn passes
``validate_remote_txn``) so even a hand-built CRC-valid frame can never
mis-decode.  DEFLATE — per chunk and per frame body — is inflated
through a bounded decompressor (a declared column/body can never expand
past its declared size), so adversarial frames cannot balloon memory.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Sequence, Tuple, Union

from ..common import (
    RemoteDel,
    RemoteId,
    RemoteIns,
    RemoteTxn,
    validate_remote_txn,
)
from .codec import (
    KIND_TXNS,
    KIND_TXNS_MUX,
    CodecError,
    _collect_names,
    _frame,
    _read_names,
    _read_varint,
    _write_names,
    _write_varint,
)

FRAME_VERSION_COLUMNAR = 2

# Column ids.  The decoder walks them in dependency order (counts before
# the columns they size, ops before the txn-seq chain that needs txn
# lengths), so the ids are a namespace, not a decode order.
T_AGENT, T_SEQ, T_NPAR, T_NOPS = 0, 1, 2, 3
P_AGENT, P_SEQ = 4, 5
OP_TAG = 6
I_OLA, I_OLS, I_ORA, I_ORS, I_LEN, CONTENT = 7, 8, 9, 10, 11, 12
D_AGENT, D_SEQ, D_LEN = 13, 14, 15
DOC = 16   # TXNS_MUX only: per-txn doc-table index

_COLS_TXNS = frozenset(range(16))
_COLS_MUX = frozenset(range(17))

ENC_RAW = 0
ENC_DEFLATE = 1

_FLAG_DEFLATE = 1  # payload flags bit 0: body is one DEFLATE stream

_U32_MAX = 0xFFFF_FFFF
# Decode-side memory bounds.  RLE means a tiny frame can legitimately
# declare many values (that is the point), so counts cannot be bounded
# by payload length the way the row codec bounds them — these caps are
# the adversarial-allocation ceiling instead.  Encoders chunk:
# ``encode_txns_stream``/``encode_mux_stream`` emit back-to-back frames
# under the caps.
_MAX_TXNS = 1 << 16          # txns per frame
_MAX_DOCS = 1 << 14          # doc table entries per mux frame
_MAX_PARENTS = 1 << 18       # total parents per frame
_MAX_OPS = 1 << 18           # total ops per frame
_MAX_CONTENT = 1 << 20       # total insert codepoints per frame
_MAX_BODY = 1 << 23          # declared raw size of a deflated body
# Only deflate chunks big enough to plausibly win (DEFLATE costs ~11
# bytes of fixed overhead before any gain).
_DEFLATE_MIN = 64


# -- zigzag ------------------------------------------------------------------

def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


# -- run codec ---------------------------------------------------------------

def _enc_runs(residuals: Sequence[int]) -> bytes:
    """RLE runs of zigzag-LEB128 residuals; no count header — the
    decoder knows every column's exact expected length."""
    out = bytearray()
    i, n = 0, len(residuals)
    while i < n:
        v = residuals[i]
        j = i + 1
        while j < n and residuals[j] == v:
            j += 1
        _write_varint(out, j - i)
        _write_varint(out, _zigzag(v))
        i = j
    return bytes(out)


def _dec_runs(buf: bytes, expect_n: int, what: str) -> List[int]:
    """Inverse of ``_enc_runs``: must land EXACTLY on ``expect_n``
    residuals and consume the whole buffer."""
    out: List[int] = []
    cur, end = 0, len(buf)
    while cur < end:
        run, cur = _read_varint(buf, cur, end)
        if run < 1 or len(out) + run > expect_n:
            raise CodecError(
                f"{what} column overruns expected {expect_n} values")
        zz, cur = _read_varint(buf, cur, end)
        out.extend([_unzigzag(zz)] * run)
    if len(out) != expect_n:
        raise CodecError(
            f"{what} column holds {len(out)} values, expected {expect_n}")
    return out


# -- chunk layer -------------------------------------------------------------

def _write_chunk(out: bytearray, col_id: int, raw: bytes) -> None:
    enc, body = ENC_RAW, raw
    if len(raw) >= _DEFLATE_MIN:
        packed = zlib.compress(raw, 9)
        if len(packed) < len(raw):
            enc, body = ENC_DEFLATE, packed
    out.append((col_id << 1) | enc)
    _write_varint(out, len(body))
    out += body


def _read_chunks(buf: bytes, cur: int, end: int, known: frozenset
                 ) -> Tuple[Dict[int, Tuple[int, bytes]], int]:
    count, cur = _read_varint(buf, cur, end)
    if count > end - cur:  # each chunk costs >= 2 bytes
        raise CodecError("chunk count longer than payload")
    chunks: Dict[int, Tuple[int, bytes]] = {}
    for _ in range(count):
        if cur >= end:
            raise CodecError("truncated chunk header")
        col_id, enc = buf[cur] >> 1, buf[cur] & 1
        cur += 1
        if col_id not in known:
            raise CodecError(f"unknown column id {col_id}")
        if col_id in chunks:
            raise CodecError(f"duplicate column id {col_id}")
        ln, cur = _read_varint(buf, cur, end)
        if ln > end - cur:
            raise CodecError("truncated column chunk")
        chunks[col_id] = (enc, buf[cur:cur + ln])
        cur += ln
    return chunks, cur


def _col(chunks: Dict[int, Tuple[int, bytes]], col_id: int, expect_n: int,
         what: str) -> List[int]:
    """Decode one column to residuals; an absent chunk is all-zero
    residuals (every value predicted exactly — the encoder elides it)."""
    got = chunks.get(col_id)
    if got is None:
        return [0] * expect_n
    enc, body = got
    if enc == ENC_DEFLATE:
        # Bounded inflate: a column of expect_n residuals can never
        # legitimately exceed ~11 bytes per value (two max varints).
        cap = 22 * max(expect_n, 1) + 64
        body = _bounded_inflate(body, cap, what)
    return _dec_runs(body, expect_n, what)


def _bounded_inflate(data: bytes, cap: int, what: str) -> bytes:
    d = zlib.decompressobj()
    try:
        out = d.decompress(data, cap)
    except zlib.error as e:
        raise CodecError(f"{what} inflate failed: {e}") from None
    if d.unconsumed_tail or not d.eof or d.unused_data:
        raise CodecError(f"{what} exceeds inflate bound or carries "
                         f"trailing garbage")
    return out


# -- encode ------------------------------------------------------------------

def _encode_cols(pairs: Sequence[Tuple[int, RemoteTxn]], aidx: Dict[str, int],
                 mux: bool) -> List[Tuple[int, List[int]]]:
    """Residual columns for a flattened ``(doc_idx, txn)`` stream (the
    single-doc body is the degenerate ``doc_idx == 0`` case with the
    DOC column omitted)."""
    doc_col: List[int] = []
    t_agent: List[int] = []
    t_seq: List[int] = []
    t_npar: List[int] = []
    t_nops: List[int] = []
    p_agent: List[int] = []
    p_seq: List[int] = []
    op_tag: List[int] = []
    i_ola: List[int] = []
    i_ols: List[int] = []
    i_ora: List[int] = []
    i_ors: List[int] = []
    i_len: List[int] = []
    content: List[int] = []
    d_agent: List[int] = []
    d_seq: List[int] = []
    d_len: List[int] = []

    chain: Dict[int, int] = {}  # author idx -> its last txn's seq + len
    last_seq: Dict[int, int] = {}  # author idx -> its last txn's seq
    # Chain seeds: counts start at their modal value (one parent, one
    # op), so the typical column is all-zero residuals and elided.
    prev = dict(doc=0, t_agent=0, t_npar=1, t_nops=1, op_tag=0,
                i_ols=0, i_ors=0, i_len=1, content=0, d_agent=0, d_len=1)
    d_chain = 0                 # previous delete's target seq + len

    def delta(key: str, v: int) -> int:
        r = v - prev[key]
        prev[key] = v
        return r

    for doc_i, txn in pairs:
        doc_col.append(delta("doc", doc_i))
        author = aidx[txn.id.agent]
        seq = txn.id.seq
        t_agent.append(delta("t_agent", author))
        t_seq.append(seq - chain.get(author, 0))
        t_npar.append(delta("t_npar", len(txn.parents)))
        t_nops.append(delta("t_nops", len(txn.ops)))
        for p in txn.parents:
            # Parent agent rides author-relative; parent seq predicts
            # the PARENT AGENT's previous txn in this stream (a linear
            # continuation — own or a merge point on a peer we just
            # carried — costs ~0), falling back to seq - 1.
            p_idx = aidx[p.agent]
            p_agent.append(p_idx - author)
            p_seq.append(p.seq - last_seq.get(p_idx, seq - 1))
        tlen = 0
        emitted = 0             # insert chars already emitted this txn
        for op in txn.ops:
            if isinstance(op, RemoteIns):
                op_tag.append(delta("op_tag", 0))
                ola = aidx[op.origin_left.agent]
                ols = op.origin_left.seq
                # Origin-left agent rides author-relative (an author
                # extending their own run — the typing shape — is 0).
                i_ola.append(ola - author)
                if op.origin_left.agent == "ROOT":
                    i_ols.append(ols - _U32_MAX)
                elif ola == author:
                    # Own-chain origin: the char this txn's content is
                    # extending — exactly seq + emitted - 1 for a
                    # continuation, so a typing run is all zeros.
                    i_ols.append(ols - (seq + emitted - 1))
                else:
                    i_ols.append(ols - prev["i_ols"])
                    prev["i_ols"] = ols
                i_ora.append(aidx[op.origin_right.agent] - ola)
                if op.origin_right.agent == "ROOT":
                    i_ors.append(op.origin_right.seq - _U32_MAX)
                else:
                    # Previous-value chain: a typing run into existing
                    # text keeps ONE successor char for the whole run.
                    i_ors.append(op.origin_right.seq - prev["i_ors"])
                    prev["i_ors"] = op.origin_right.seq
                n = len(op.ins_content)
                i_len.append(delta("i_len", n))
                for ch in op.ins_content:
                    cp = ord(ch)
                    if 0xD800 <= cp <= 0xDFFF:
                        raise CodecError(
                            "insert content carries a lone surrogate")
                    content.append(delta("content", cp))
                tlen += n
                emitted += n
            else:
                op_tag.append(delta("op_tag", 1))
                d_agent.append(delta("d_agent", aidx[op.id.agent]))
                d_seq.append(op.id.seq - d_chain)
                d_chain = op.id.seq + op.len
                d_len.append(delta("d_len", op.len))
                tlen += op.len
        last_seq[author] = seq
        chain[author] = seq + tlen

    cols = [
        (T_AGENT, t_agent), (T_SEQ, t_seq), (T_NPAR, t_npar),
        (T_NOPS, t_nops), (P_AGENT, p_agent), (P_SEQ, p_seq),
        (OP_TAG, op_tag), (I_OLA, i_ola), (I_OLS, i_ols), (I_ORA, i_ora),
        (I_ORS, i_ors), (I_LEN, i_len), (CONTENT, content),
        (D_AGENT, d_agent), (D_SEQ, d_seq), (D_LEN, d_len),
    ]
    if mux:
        cols.insert(0, (DOC, doc_col))
    return cols


def _frame_budget(txns: Sequence[RemoteTxn], what: str) -> None:
    """Encode-side twin of the decoder's allocation caps: a frame that
    exceeds them would encode fine and then be rejected by EVERY
    compliant decoder — fail fast at the source (the stream encoders
    split windows under these budgets instead)."""
    if len(txns) > _MAX_TXNS:
        raise CodecError(
            f"{len(txns)} txns exceed per-frame cap {_MAX_TXNS} ({what})")
    n_ops = sum(len(t.ops) for t in txns)
    if n_ops > _MAX_OPS:
        raise CodecError(
            f"{n_ops} ops exceed per-frame cap {_MAX_OPS} ({what})")
    n_par = sum(len(t.parents) for t in txns)
    if n_par > _MAX_PARENTS:
        raise CodecError(
            f"{n_par} parents exceed per-frame cap {_MAX_PARENTS} ({what})")
    n_cp = sum(len(op.ins_content) for t in txns for op in t.ops
               if isinstance(op, RemoteIns))
    if n_cp > _MAX_CONTENT:
        raise CodecError(
            f"{n_cp} content codepoints exceed per-frame cap "
            f"{_MAX_CONTENT} ({what})")


def _txn_budget_cost(txn: RemoteTxn) -> Tuple[int, int, int]:
    """(ops, parents, codepoints) a txn spends against the frame caps."""
    return (len(txn.ops), len(txn.parents),
            sum(len(op.ins_content) for op in txn.ops
                if isinstance(op, RemoteIns)))


def _budget_windows(txns: Sequence, per_frame: int, cost):
    """Greedy split of a batch into windows each under the decode caps
    (``cost`` maps an item to its (ops, parents, codepoints) spend).
    A single item over the caps raises — it could never decode."""
    window: List = []
    ops = par = cp = 0
    for item in txns:
        o, p, c = cost(item)
        if window and (len(window) >= per_frame or ops + o > _MAX_OPS
                       or par + p > _MAX_PARENTS or cp + c > _MAX_CONTENT):
            yield window
            window, ops, par, cp = [], 0, 0, 0
        window.append(item)
        ops += o
        par += p
        cp += c
    if window:
        yield window


def _finish_frame(kind: int, raw_body: bytes) -> bytes:
    """Wrap a built body as one v2 frame, body-deflating when it wins
    (this is what makes multiplexed name tables nearly free). Bodies
    past 64 KiB skip the attempt: their chunks already deflated
    individually, so the whole-body pass is a near-certain loss paid
    in CPU on the biggest frames."""
    payload = bytearray([kind])
    if _DEFLATE_MIN <= len(raw_body) <= (1 << 16):
        packed = zlib.compress(raw_body, 9)
        header = bytearray()
        _write_varint(header, len(raw_body))
        if 1 + len(header) + len(packed) < 1 + len(raw_body):
            payload.append(_FLAG_DEFLATE)
            payload += header
            payload += packed
            return _frame(bytes(payload), version=FRAME_VERSION_COLUMNAR)
    payload.append(0)
    payload += raw_body
    return _frame(bytes(payload), version=FRAME_VERSION_COLUMNAR)


def encode_txns(txns: Sequence[RemoteTxn]) -> bytes:
    """One columnar (version 2) frame carrying a ``RemoteTxn`` batch.

    Decodes back — through ``codec.decode_frame``'s version negotiation
    — to exactly the structures ``codec.encode_txns`` would round-trip;
    the two formats are interchangeable on the wire.
    """
    for txn in txns:
        validate_remote_txn(txn)
    _frame_budget(txns, "encode_txns")
    table = _collect_names(txns)
    cols = _encode_cols([(0, t) for t in txns], table._ids, mux=False)
    body = bytearray()
    _write_names(body, table.names)
    _write_varint(body, len(txns))
    present = [(cid, res) for cid, res in cols if any(res)]
    _write_varint(body, len(present))
    for cid, res in present:
        _write_chunk(body, cid, _enc_runs(res))
    return _finish_frame(KIND_TXNS, bytes(body))


def encode_txns_stream(txns: Sequence[RemoteTxn],
                       per_frame: int = 4096) -> bytes:
    """Back-to-back columnar frames (``codec.decode_frames`` layout),
    windowed under ALL the decoder's adversarial-allocation caps (txn
    count, ops, parents, content) — the encoding for unbounded batches
    (anti-entropy resends, checkpoint deltas). A single txn over the
    caps raises: no framing could ever decode it."""
    if not txns:
        return encode_txns([])
    out = bytearray()
    for window in _budget_windows(txns, per_frame, _txn_budget_cost):
        out += encode_txns(window)
    return bytes(out)


def encode_mux(batches: Sequence[Tuple[str, Sequence[RemoteTxn]]]) -> bytes:
    """One TXNS_MUX frame: many documents' txn batches on one
    connection.  Per-doc txn order is preserved (that is the causal
    contract); doc interleaving is free — the DOC column is delta-coded
    so doc-sorted input costs ~2 bytes per document."""
    pairs: List[Tuple[int, RemoteTxn]] = []
    doc_ids: List[str] = []
    doc_idx: Dict[str, int] = {}
    for doc_id, txns in batches:
        i = doc_idx.get(doc_id)
        if i is None:
            i = doc_idx[doc_id] = len(doc_ids)
            doc_ids.append(doc_id)
        for txn in txns:
            validate_remote_txn(txn)
            pairs.append((i, txn))
    if len(doc_ids) > _MAX_DOCS:
        raise CodecError(f"{len(doc_ids)} docs exceed per-frame cap "
                         f"{_MAX_DOCS}")
    _frame_budget([t for _, t in pairs], "encode_mux")
    table = _collect_names([t for _, t in pairs])
    cols = _encode_cols(pairs, table._ids, mux=True)
    body = bytearray()
    _write_names(body, doc_ids)
    _write_names(body, table.names)
    _write_varint(body, len(pairs))
    present = [(cid, res) for cid, res in cols if any(res)]
    _write_varint(body, len(present))
    for cid, res in present:
        _write_chunk(body, cid, _enc_runs(res))
    return _finish_frame(KIND_TXNS_MUX, bytes(body))


def group_consecutive(pairs: Sequence[Tuple[str, RemoteTxn]]
                      ) -> List[Tuple[str, List[RemoteTxn]]]:
    """Fold a flat ``(doc_id, txn)`` stream into consecutive same-doc
    groups, order-preserving — the one grouping rule the mux encoder,
    stream splitter, and decoder all share."""
    grouped: List[Tuple[str, List[RemoteTxn]]] = []
    for doc_id, txn in pairs:
        if grouped and grouped[-1][0] == doc_id:
            grouped[-1][1].append(txn)
        else:
            grouped.append((doc_id, [txn]))
    return grouped


def encode_mux_stream(batches: Sequence[Tuple[str, Sequence[RemoteTxn]]],
                      per_frame: int = 4096) -> bytes:
    """Back-to-back TXNS_MUX frames chunked under the decode caps; a
    doc's batch may split across frames (per-doc txn order holds)."""
    flat: List[Tuple[str, RemoteTxn]] = [
        (doc_id, txn) for doc_id, txns in batches for txn in txns]
    if not flat:
        return encode_mux([])
    # A window of N txns references at most N docs, so capping the
    # window size at _MAX_DOCS keeps the doc table under its decode
    # cap too (callers may pass any per_frame).
    per_frame = min(per_frame, _MAX_DOCS)
    out = bytearray()
    for window in _budget_windows(flat, per_frame,
                                  lambda p: _txn_budget_cost(p[1])):
        out += encode_mux(group_consecutive(window))
    return bytes(out)


# -- decode ------------------------------------------------------------------

def _undelta(residuals: List[int], what: str, base: int = 0,
             lo: int = 0, hi: int = _U32_MAX) -> List[int]:
    """Previous-value predictor + range check (the single hardening
    point for every prev-coded column)."""
    out: List[int] = []
    v = base
    for r in residuals:
        v += r
        if v < lo or v > hi:
            raise CodecError(f"{what} value {v} out of range [{lo}, {hi}]")
        out.append(v)
    return out


def _unwrap_body(buf: bytes, cur: int, end: int
                 ) -> Tuple[bytes, int, int]:
    """Consume the flags byte; bounded-inflate the body when flagged.
    Returns ``(buffer, cur, end)`` to parse the raw body from."""
    if cur >= end:
        raise CodecError("truncated payload: missing flags byte")
    flags = buf[cur]
    cur += 1
    if flags & ~_FLAG_DEFLATE:
        raise CodecError(f"unknown payload flags {flags:#04x}")
    if not flags & _FLAG_DEFLATE:
        return buf, cur, end
    raw_len, cur = _read_varint(buf, cur, end)
    if raw_len > _MAX_BODY:
        raise CodecError(f"deflated body declares {raw_len} raw bytes, "
                         f"cap {_MAX_BODY}")
    body = _bounded_inflate(bytes(buf[cur:end]), raw_len, "frame body")
    if len(body) != raw_len:
        raise CodecError(f"deflated body inflated to {len(body)} bytes, "
                         f"declared {raw_len}")
    return body, 0, raw_len


def _decode_txn_cols(chunks: Dict[int, Tuple[int, bytes]],
                     names: List[str], n_txns: int) -> List[RemoteTxn]:
    """Reconstruct the txn stream from decoded column chunks (everything
    after the name tables and count header; shared by both bodies)."""
    n_names = len(names)

    t_agent = _undelta(_col(chunks, T_AGENT, n_txns, "txn agent"),
                       "txn agent index", hi=n_names - 1 if n_names else 0)
    t_npar = _undelta(_col(chunks, T_NPAR, n_txns, "parent count"),
                      "parent count", base=1, hi=1 << 16)
    t_nops = _undelta(_col(chunks, T_NOPS, n_txns, "op count"),
                      "op count", base=1, lo=1, hi=1 << 18)
    n_parents = sum(t_npar)
    n_ops = sum(t_nops)
    if n_parents > _MAX_PARENTS:
        raise CodecError(f"{n_parents} parents exceed cap {_MAX_PARENTS}")
    if n_ops > _MAX_OPS:
        raise CodecError(f"{n_ops} ops exceed cap {_MAX_OPS}")

    # Op columns first: txn seqs chain over txn LENGTHS, which only the
    # ops know.
    tag_res = _col(chunks, OP_TAG, n_ops, "op tag")
    tags = _undelta(tag_res, "op tag", hi=1)
    n_ins = sum(1 for t in tags if t == 0)
    n_del = n_ops - n_ins

    # Origin columns stay RAW residuals here: their predictors (author
    # index, own-chain seq + emitted, previous-value chains) resolve in
    # the txn assembly loop below, where author/seq are known.
    i_ola_res = _col(chunks, I_OLA, n_ins, "origin-left agent")
    i_ols_res = _col(chunks, I_OLS, n_ins, "origin-left seq")
    i_len = _undelta(_col(chunks, I_LEN, n_ins, "insert length"),
                     "insert length", base=1, lo=1, hi=_MAX_CONTENT)
    n_cp = sum(i_len)
    if n_cp > _MAX_CONTENT:
        raise CodecError(f"{n_cp} codepoints exceed cap {_MAX_CONTENT}")
    ora_res = _col(chunks, I_ORA, n_ins, "origin-right agent")
    ors_res = _col(chunks, I_ORS, n_ins, "origin-right seq")
    cps = _undelta(_col(chunks, CONTENT, n_cp, "content"),
                   "content codepoint", hi=0x10FFFF)
    for cp in cps:
        if 0xD800 <= cp <= 0xDFFF:
            raise CodecError(f"content codepoint {cp:#x} is a surrogate")

    d_agent = _undelta(_col(chunks, D_AGENT, n_del, "delete agent"),
                       "delete agent index",
                       hi=n_names - 1 if n_names else 0)
    d_len = _undelta(_col(chunks, D_LEN, n_del, "delete length"),
                     "delete length", base=1, lo=1)
    # Delete target seq: previous delete's seq + len (a sweep chains).
    d_seq: List[int] = []
    d_chain = 0
    for k, r in enumerate(_col(chunks, D_SEQ, n_del, "delete seq")):
        v = d_chain + r
        if v < 0 or v > _U32_MAX:
            raise CodecError(f"delete seq {v} out of u32 range")
        d_seq.append(v)
        d_chain = v + d_len[k]

    p_agent_res = _col(chunks, P_AGENT, n_parents, "parent agent")
    p_seq_res = _col(chunks, P_SEQ, n_parents, "parent seq")
    t_seq_res = _col(chunks, T_SEQ, n_txns, "txn seq")

    txns: List[RemoteTxn] = []
    oi = ii = di = ci = pi = 0
    chain: Dict[int, int] = {}
    last_seq: Dict[int, int] = {}
    prev_ols = prev_ors = 0
    for ti in range(n_txns):
        author = t_agent[ti]
        seq = chain.get(author, 0) + t_seq_res[ti]
        if seq < 0 or seq > _U32_MAX:
            raise CodecError(f"txn seq {seq} out of u32 range")
        parents: List[RemoteId] = []
        for _ in range(t_npar[ti]):
            pa = author + p_agent_res[pi]
            if pa < 0 or pa >= n_names:
                raise CodecError(
                    f"parent agent index {pa} out of table range {n_names}")
            ps = last_seq.get(pa, seq - 1) + p_seq_res[pi]
            if ps < 0 or ps > _U32_MAX:
                raise CodecError(f"parent seq {ps} out of u32 range")
            parents.append(RemoteId(names[pa], ps))
            pi += 1
        ops: List[Union[RemoteIns, RemoteDel]] = []
        tlen = 0
        emitted = 0
        for _ in range(t_nops[ti]):
            if tags[oi] == 0:
                ola = author + i_ola_res[ii]
                if ola < 0 or ola >= n_names:
                    raise CodecError(
                        f"origin-left agent index {ola} out of "
                        f"table range {n_names}")
                r = i_ols_res[ii]
                if names[ola] == "ROOT":
                    ols = _U32_MAX + r
                elif ola == author:
                    ols = (seq + emitted - 1) + r
                else:
                    ols = prev_ols + r
                    prev_ols = ols
                if ols < 0 or ols > _U32_MAX:
                    raise CodecError(
                        f"origin-left seq {ols} out of u32 range")
                ora = ola + ora_res[ii]
                if ora < 0 or ora >= n_names:
                    raise CodecError(
                        f"origin-right agent index {ora} out of "
                        f"table range {n_names}")
                if names[ora] == "ROOT":
                    ors = _U32_MAX + ors_res[ii]
                else:
                    ors = prev_ors + ors_res[ii]
                    prev_ors = ors
                if ors < 0 or ors > _U32_MAX:
                    raise CodecError(
                        f"origin-right seq {ors} out of u32 range")
                n = i_len[ii]
                text = "".join(map(chr, cps[ci:ci + n]))
                ci += n
                ops.append(RemoteIns(RemoteId(names[ola], ols),
                                     RemoteId(names[ora], ors), text))
                ii += 1
                tlen += n
                emitted += n
            else:
                ln = d_len[di]
                if d_seq[di] + ln > _U32_MAX + 1:
                    raise CodecError(
                        f"delete length {ln} exceeds u32 range")
                ops.append(RemoteDel(RemoteId(names[d_agent[di]],
                                              d_seq[di]), ln))
                di += 1
                tlen += ln
            oi += 1
        txn = RemoteTxn(RemoteId(names[author], seq), parents, ops)
        try:
            validate_remote_txn(txn)
        except ValueError as e:
            # Same span-naming contract as the row decoder: the bytes
            # were sound, so the reject can carry the op's identity.
            raise CodecError(f"invalid txn: {e}", agent=names[author],
                             seq=seq, n=tlen) from None
        txns.append(txn)
        last_seq[author] = seq
        chain[author] = seq + tlen
    return txns


def decode_txns(buf: bytes, cur: int, end: int) -> List[RemoteTxn]:
    """Decode a columnar KIND_TXNS payload body (after the kind byte).

    Raises ``CodecError`` on any structural violation; the caller
    (``codec.decode_frame``) has already CRC-checked the frame.
    """
    buf, cur, end = _unwrap_body(buf, cur, end)
    names, cur = _read_names(buf, cur, end)
    n_txns, cur = _read_varint(buf, cur, end)
    if n_txns > _MAX_TXNS:
        raise CodecError(f"txn count {n_txns} exceeds cap {_MAX_TXNS}")
    if n_txns and not names:
        raise CodecError("txn batch with empty name table")
    chunks, cur = _read_chunks(buf, cur, end, _COLS_TXNS)
    if cur != end:
        raise CodecError(f"{end - cur} trailing bytes after column chunks")
    return _decode_txn_cols(chunks, names, n_txns)


def decode_txns_mux(buf: bytes, cur: int, end: int
                    ) -> List[Tuple[str, List[RemoteTxn]]]:
    """Decode a TXNS_MUX payload body to ``[(doc_id, txns)]`` groups in
    stream order (consecutive same-doc txns grouped; a doc may appear
    in more than one group if the encoder interleaved)."""
    buf, cur, end = _unwrap_body(buf, cur, end)
    doc_ids, cur = _read_names(buf, cur, end)
    if len(doc_ids) > _MAX_DOCS:
        raise CodecError(f"doc table of {len(doc_ids)} exceeds cap "
                         f"{_MAX_DOCS}")
    names, cur = _read_names(buf, cur, end)
    n_txns, cur = _read_varint(buf, cur, end)
    if n_txns > _MAX_TXNS:
        raise CodecError(f"txn count {n_txns} exceeds cap {_MAX_TXNS}")
    if n_txns and not names:
        raise CodecError("txn batch with empty name table")
    if n_txns and not doc_ids:
        raise CodecError("mux batch with empty doc table")
    chunks, cur = _read_chunks(buf, cur, end, _COLS_MUX)
    if cur != end:
        raise CodecError(f"{end - cur} trailing bytes after column chunks")
    doc_col = _undelta(_col(chunks, DOC, n_txns, "doc index"),
                       "doc index", hi=len(doc_ids) - 1 if doc_ids else 0)
    txns = _decode_txn_cols(chunks, names, n_txns)
    return group_consecutive(
        [(doc_ids[di], txn) for di, txn in zip(doc_col, txns)])
