"""Host utilities of the port: the editing-trace loader (``testdata``),
flat RLE vectors (``rle``) and seeded edit streams (``randedit``)."""
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
]
