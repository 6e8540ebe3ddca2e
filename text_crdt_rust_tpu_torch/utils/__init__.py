"""Host utilities of the port: the editing-trace loader (``testdata``),
flat RLE vectors (``rle``), seeded edit streams (``randedit``), document
checkpoints, device ``FlatDoc`` checkpoints included (``checkpoint``),
CRC32C (``integrity``) and the metrics (``metrics``: counters, document,
memory and run-state stats)."""
from .checkpoint import (
    CheckpointError,
    load_doc,
    load_flat_doc,
    save_doc,
    save_flat_doc,
)
from .integrity import crc32c
from .metrics import (
    Counters,
    Throughput,
    causal_buffer_stats,
    doc_stats,
    memory_stats,
    print_stats,
    run_stats,
)
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
    "load_flat_doc",
    "save_doc",
    "save_flat_doc",
    "crc32c",
    "Counters",
    "Throughput",
    "causal_buffer_stats",
    "doc_stats",
    "memory_stats",
    "print_stats",
    "run_stats",
]
