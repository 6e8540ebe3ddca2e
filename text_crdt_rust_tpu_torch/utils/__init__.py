"""Host utilities of the port: the editing-trace loader (``testdata``),
flat RLE vectors (``rle``), seeded edit streams (``randedit``), document
checkpoints (``checkpoint``), CRC32C (``integrity``) and the metrics
counters (``metrics``). The device ``FlatDoc`` checkpoints and the device
memory and run-state stats of the JAX package's ``metrics`` come with
the flat slice."""
from .checkpoint import CheckpointError, load_doc, save_doc
from .integrity import crc32c
from .metrics import Counters, Throughput, causal_buffer_stats, doc_stats
from .testdata import (
    TestData,
    TestPatch,
    TestTxn,
    flatten_patches,
    load_testing_data,
    trace_path,
)

__all__ = [
    "TestData",
    "TestPatch",
    "TestTxn",
    "flatten_patches",
    "load_testing_data",
    "trace_path",
    "CheckpointError",
    "load_doc",
    "save_doc",
    "crc32c",
    "Counters",
    "Throughput",
    "causal_buffer_stats",
    "doc_stats",
]
