"""The stats example on the port: a trace replay with its memory and
compaction report (counterpart of ``text_crdt_rust_tpu/examples/stats.py``).

The `examples/stats.rs:39-73` analog: replay a shipped editing trace on
the native C++ engine (or the host oracle), check the final content and
print span and memory statistics (the `print_stats` + `TracingAlloc`
report, `stats.rs:56-71`).

Usage: ``python -m text_crdt_rust_tpu_torch.examples.stats [--trace NAME]
[--engine native|oracle] [--detailed]``. The package reads no clock: pass
``clock=`` (for example ``time.perf_counter``) to ``main`` to print the
replay's rate.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional

from ..baseline import AGENT, patch_lists
from ..common import LocalOp
from ..config import StatsConfig
from ..models.native import NativeListCRDT
from ..models.oracle import ListCRDT
from ..utils.metrics import print_stats
from ..utils.testdata import flatten_patches, load_testing_data, trace_path


def main(argv=None, clock: Optional[Callable[[], float]] = None) -> int:
    cfg = StatsConfig.from_args(argv)
    data = load_testing_data(trace_path(cfg.trace))
    patches = flatten_patches(data)
    n_chars = sum(p.del_len + len(p.ins_content) for p in patches)
    print(f"{cfg.trace}: {len(patches)} patches, {n_chars} CRDT ops, "
          f"final length {len(data.end_content)}")

    if cfg.engine == "native":
        doc = NativeListCRDT()
        agent = doc.get_or_create_agent_id(AGENT)
        columns = patch_lists(patches)
        t0 = clock() if clock else None
        doc.replay_trace(agent, *columns)
    else:
        doc = ListCRDT(capacity=1024)
        agent = doc.get_or_create_agent_id(AGENT)
        t0 = clock() if clock else None
        for p in patches:
            doc.apply_local_txn(
                agent, [LocalOp(p.pos, p.ins_content, p.del_len)])
    rate = ""
    if clock:
        wall = clock() - t0
        rate = (f" {wall * 1e3:.0f} ms = {len(patches) / wall:,.0f} "
                f"patches/s,")
    ok = doc.to_string() == data.end_content
    print(f"replay ({cfg.engine}):{rate} final content "
          f"{'OK' if ok else 'MISMATCH'}")
    if not ok:
        return 1
    print_stats(doc, detailed=cfg.detailed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
