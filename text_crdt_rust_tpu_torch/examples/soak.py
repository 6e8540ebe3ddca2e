"""The soak example on the port: seeded random edits, checked against two
oracles, then the document's stats (counterpart of
``text_crdt_rust_tpu/examples/soak.py``).

The `examples/simple.rs:14-49` analog: 1M seeded random edits replayed
on the native C++ engine in one call, its text checked against the
text-only gap-buffer replay (`benches/ropey.rs`, an independent code
path), and the first ``--oracle`` edits also replayed step by step
through the host oracle with the text compared and ``check()`` run after
each (the `make_random_change` / `doc.check()` loop of `doc.rs:544-587`).
The edits are drawn from ``random.Random(seed)`` exactly as the JAX
package's example draws them.

Usage: ``python -m text_crdt_rust_tpu_torch.examples.soak [--edits N]
[--seed S] [--oracle N] [--detailed]``. The package reads no clock:
pass ``clock=`` (for example ``time.perf_counter``) to ``main`` to print
the native replay's rate.
"""
from __future__ import annotations

import random
import sys
from typing import Callable, Optional

import numpy as np

from ..common import LocalOp
from ..config import SoakConfig
from ..models.native import NativeListCRDT, rope_replay
from ..models.oracle import ListCRDT
from ..utils.metrics import print_stats


def make_edits(rng: random.Random, n: int):
    """A seeded random edit stream (the `make_random_change` distribution:
    inserts of 1-4 chars or deletes of 1-4, at uniform positions) as the
    four u32 columns of ``replay_trace``."""
    pos = np.zeros(n, np.uint32)
    dels = np.zeros(n, np.uint32)
    ilens = np.zeros(n, np.uint32)
    chars = []
    content_len = 0
    alphabet = "abcdefghijklmnop "
    for i in range(n):
        if content_len == 0 or rng.random() < 0.55:
            p = rng.randint(0, content_len)
            ins = "".join(rng.choice(alphabet)
                          for _ in range(rng.randint(1, 4)))
            pos[i] = p
            ilens[i] = len(ins)
            chars.append(ins)
            content_len += len(ins)
        else:
            p = rng.randint(0, content_len - 1)
            span = min(rng.randint(1, 4), content_len - p)
            pos[i] = p
            dels[i] = span
            content_len -= span
    cps = np.frombuffer("".join(chars).encode("utf-32-le"), dtype=np.uint32)
    return pos, dels, ilens, cps


def oracle_prefix(pos, dels, ilens, cps, steps: int) -> None:
    """Replay the first ``steps`` edits through the host oracle, comparing
    its text with a plain string after every edit; then ``check()``."""
    doc = ListCRDT(capacity=256)
    agent = doc.get_or_create_agent_id("soak")
    content = ""
    off = 0
    for i in range(steps):
        il = int(ilens[i])
        ins = cps[off:off + il].tobytes().decode("utf-32-le") if il else ""
        off += il
        p, d = int(pos[i]), int(dels[i])
        doc.apply_local_txn(agent, [LocalOp(p, ins, d)])
        content = content[:p] + ins + content[p + d:]
        if doc.to_string() != content:
            raise AssertionError(f"oracle diverged at edit {i}")
    doc.check()


def main(argv=None, clock: Optional[Callable[[], float]] = None) -> int:
    cfg = SoakConfig.from_args(argv)
    rng = random.Random(cfg.seed)
    print(f"soak: {cfg.edits} seeded random edits (seed={cfg.seed})")
    pos, dels, ilens, cps = make_edits(rng, cfg.edits)

    if cfg.oracle_steps:
        steps = min(cfg.oracle_steps, cfg.edits)
        oracle_prefix(pos, dels, ilens, cps, steps)
        print(f"  oracle prefix OK ({steps} steps, per-step checked)")

    ndoc = NativeListCRDT()
    agent = ndoc.get_or_create_agent_id("soak")
    t0 = clock() if clock else None
    ndoc.replay_trace(agent, pos, dels, ilens, cps)
    if clock:
        wall = clock() - t0
        print(f"  native replay: {cfg.edits / wall:,.0f} edits/s "
              f"({wall * 1e3:.0f} ms)")

    # The independent text-only oracle (another code path entirely).
    n, content = rope_replay(pos, dels, ilens, cps)
    if ndoc.to_string() != content:
        print("  native engine diverged from the gap-buffer oracle")
        return 1
    print(f"  content OK: {n} chars, {ndoc.num_spans()} spans "
          f"(compaction {ndoc.raw_len() / max(1, ndoc.num_spans()):.1f} "
          f"items/span)")
    print_stats(ndoc, detailed=cfg.detailed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
