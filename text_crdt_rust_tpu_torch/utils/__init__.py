"""Host utilities of the port: the editing-trace loader."""
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
