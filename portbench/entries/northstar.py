"""The north-star entry: a trace compiled by the port's
``northstar.compile_northstar`` (merge, compile at the longest insert,
fuse at ``fuse_w``) and replayed by ``northstar.make_northstar_replayer``
(``ops/rle.make_replayer_rle``, kernel A1) into ``groups`` x ``batch``
identical documents. The port loads the trace itself from
``benchmark_data/``; the harness reads the same file with its frozen
loader after the window, for the reference, and holds the two patch
counts equal."""
from __future__ import annotations

import numpy as np

from portbench.entry import Entry
from text_crdt_rust_tpu_torch import northstar

KERNELS = ("rle_replay",)
#: The port reads the trace itself; the harness's copy is the reference's.
NEEDS_HISTORY = False


def setup(config: dict, traffic: dict, history, device) -> Entry:
    hist = config["history"]
    if config["engine"] != "rle":
        raise ValueError("this entry drives the rle engine (A1)")
    stream = northstar.compile_northstar(
        hist["trace"], patches=hist.get("patches"),
        fuse_w=config["fuse_w"], engine="rle")
    groups, batch = traffic["groups"], traffic["batch"]
    replay = northstar.make_northstar_replayer(
        stream, batch=batch, capacity=config["capacity"],
        block_k=config["block_k"], groups=groups, device=device)
    ops = stream.ops
    cols = (np.asarray(ops.ins_order_start, np.int64),
            np.asarray(ops.ins_len, np.int64))
    return Entry(replay=replay, results=lambda out: list(out),
                 steps=[cols] * groups, documents=groups * batch,
                 counters={"device_steps": ops.num_steps,
                           "patches": stream.n_patches})
