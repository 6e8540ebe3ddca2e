"""The native single-core baseline and configuration 1 on the port: the
same edit streams the device replays take, replayed once by the native C++
engine (``models/native.py``) and, for local traces, by the text-only rope.

The counterpart of the JAX package's ``bench.py`` ``native_replay`` and
``native_remote_replay`` (``bench.py:372-411``) and of config 1,
``cfg_1_cpu`` (``bench.py:688-719``). Every device entry point
(``northstar``, ``storm``, ``stream``, ``kevin``, ``random_edits``,
``corpus``) checks the native engine's text through these functions. The
package reads no clock: ``chip_smoke.py`` times ``replay_trace`` on
``patch_lists``' output (what ``bench.py``'s ``native_replay`` times: the
conversion of the lists into u32 arrays and the one native call) and
``native_remote_replay`` (a fresh document and every txn), the median of
several runs with the load guard of ``bench.py``'s ``_baseline_samples``,
so that a ratio to the device means what the JAX package's means.

    python -m text_crdt_rust_tpu_torch.baseline [--trace automerge-paper]

replays one trace (config 1) and prints one JSON line with whether the
native engine and the rope each reproduced the trace's ``endContent``.
The native engine is CPU code by nature, as in the JAX package; there is
no device to choose.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Sequence

import numpy as np

from .common import RemoteTxn
from .models.native import NativeListCRDT, rope_replay
from .utils.testdata import TestPatch, flatten_patches, load_testing_data, \
    trace_path

#: The agent every local trace replays as (``bench.py``'s name).
AGENT = "bench"


def patch_lists(patches: Sequence[TestPatch]):
    """The four arguments of ``replay_trace`` as ``bench.py``'s
    ``native_replay`` builds them outside its timed region: positions,
    delete lengths and insert lengths as Python lists (converted to u32
    arrays inside each replay) and the inserted code points as a u32
    array."""
    return ([p.pos for p in patches], [p.del_len for p in patches],
            [len(p.ins_content) for p in patches],
            np.frombuffer("".join(p.ins_content for p in patches)
                          .encode("utf-32-le"), dtype=np.uint32))


def patch_columns(patches: Sequence[TestPatch]):
    """The four arguments as u32 arrays: the conversion ``cfg_1_cpu`` keeps
    out of the rope's timed region."""
    pos, dels, ilens, cps = patch_lists(patches)
    return (np.asarray(pos, np.uint32), np.asarray(dels, np.uint32),
            np.asarray(ilens, np.uint32), cps)


def replay_trace(columns) -> NativeListCRDT:
    """A fresh native document after one ``replay_trace`` of ``columns``
    (``patch_lists`` or ``patch_columns`` output)."""
    doc = NativeListCRDT()
    doc.replay_trace(doc.get_or_create_agent_id(AGENT), *columns)
    return doc


def native_replay(patches: Sequence[TestPatch]) -> NativeListCRDT:
    """The native engine after one replay of a local patch list (the
    original, unmerged stream)."""
    return replay_trace(patch_lists(patches))


def native_remote_replay(txns: Sequence[RemoteTxn]) -> NativeListCRDT:
    """The native engine after applying a remote txn stream in order (hot
    path #2, `doc.rs:242-348`)."""
    doc = NativeListCRDT()
    for t in txns:
        doc.apply_remote_txn(t)
    return doc


def rope_text(columns) -> str:
    """The rope's text after one replay of ``columns``."""
    return rope_replay(*columns)[1]


@dataclasses.dataclass
class CpuBaseline:
    """Config 1: one trace on the native engine and on the rope."""

    trace: str
    patches: List[TestPatch]
    want: str                 # the trace's endContent
    native_text: str
    rope_text: str
    native_spans: int
    native_memory_bytes: int

    @property
    def native_ok(self) -> bool:
        return self.native_text == self.want

    @property
    def rope_ok(self) -> bool:
        return self.rope_text == self.want

    @property
    def ok(self) -> bool:
        return self.native_ok and self.rope_ok


def run_cpu_baseline(trace: str = "automerge-paper") -> CpuBaseline:
    """Config 1 (``cfg_1_cpu``): replay the whole trace on the native
    engine and on the rope, and check both texts against ``endContent``."""
    data = load_testing_data(trace_path(trace))
    patches = flatten_patches(data)
    doc = native_replay(patches)
    return CpuBaseline(
        trace=trace, patches=patches, want=data.end_content,
        native_text=doc.to_string(),
        rope_text=rope_text(patch_columns(patches)),
        native_spans=doc.num_spans(),
        native_memory_bytes=doc.memory_bytes())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default="automerge-paper")
    args = ap.parse_args(argv)
    base = run_cpu_baseline(args.trace)
    print(json.dumps({
        "trace": args.trace, "patches": len(base.patches),
        "chars": len(base.want), "native_spans": base.native_spans,
        "native_memory_bytes": base.native_memory_bytes,
        "native_ok": base.native_ok, "rope_ok": base.rope_ok,
        "ok": base.ok}))
    return 0 if base.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
