"""Fault-tolerant replication: wire codec, fault injection, resync sessions
(counterpart of ``text_crdt_rust_tpu/net``).

The reference defines the peer-portable structs but leaves the wire
unfinished ("wire encoding is out of scope") and punts on
out-of-order delivery (`doc.rs:246-247` TODO). This package finishes the
peer boundary for the production story: history
crosses the wire as *bytes*, and any byte stream a peer accepts either
converges bit-identically or is rejected with a precise, typed error —
never a crash, never a silent divergence.

- ``codec``   — length-prefixed binary frames for ``RemoteTxn`` batches
  (varint framing, agent-name string table, per-frame CRC32C, format
  version byte) plus the session control frames (REQUEST / DIGEST).
- ``columnar`` — the version-2 TXNS body: per-column delta+RLE LEB128
  chunks with predictive transforms (the automerge binary-format gear);
  ``decode_frame`` negotiates row/columnar on the version byte.
- ``faults``  — deterministic seeded fault injection (drop, duplicate,
  reorder, truncate, bit-flip) for fuzzing the whole stack.
- ``session`` — anti-entropy resync: per-agent watermarks + state
  digests detect gaps and divergence, missing ranges are re-requested
  with capped exponential backoff and the causal buffer is bounded
  (the device mirror waits for the flat engine's slice).
"""
from .codec import (
    CodecError,
    FRAME_VERSION,
    FRAME_VERSION_COLUMNAR,
    KIND_TXNS_MUX,
    WIRE_FORMATS,
    crc32c,
    decode_frame,
    decode_frames,
    encode_digest,
    encode_request,
    encode_txns,
    txns_encoder,
)
from .columnar import (
    encode_mux,
    encode_mux_stream,
    encode_txns_stream,
)
from .columnar import encode_txns as encode_txns_columnar
from .faults import FaultSpec, FaultyChannel
from .session import CausalGapError, DeviceMirror, ResyncSession

__all__ = [
    "CodecError",
    "CausalGapError",
    "DeviceMirror",
    "FaultSpec",
    "FaultyChannel",
    "FRAME_VERSION",
    "FRAME_VERSION_COLUMNAR",
    "KIND_TXNS_MUX",
    "ResyncSession",
    "WIRE_FORMATS",
    "crc32c",
    "decode_frame",
    "decode_frames",
    "encode_digest",
    "encode_mux",
    "encode_mux_stream",
    "encode_request",
    "encode_txns",
    "encode_txns_columnar",
    "encode_txns_stream",
    "txns_encoder",
]
