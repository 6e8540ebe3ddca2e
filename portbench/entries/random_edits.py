"""The random-edits entry (config 2): the benchmark's seeded patches
compiled by the two functions the port's ``corpus.compile_rle`` calls
(``merge_patches``, then ``compile_local_patches`` at min(longest insert,
``corpus.LMAX_CAP``), whole deletes), without its run-row dry run: the
capacity is the configuration's constant. Replayed by
``ops/rle.make_replayer_rle`` (kernel A1) into ``groups`` x ``batch``
identical documents."""
from __future__ import annotations

import numpy as np

from portbench.entry import Entry
from text_crdt_rust_tpu_torch.corpus import LMAX_CAP
from text_crdt_rust_tpu_torch.ops import batch as B
from text_crdt_rust_tpu_torch.ops.rle import make_replayer_rle
from text_crdt_rust_tpu_torch.utils.testdata import TestPatch

KERNELS = ("rle_replay",)


def setup(config: dict, traffic: dict, history, device) -> Entry:
    if config["engine"] != "rle":
        raise ValueError("this entry drives the rle engine (A1)")
    patches = [TestPatch(p.pos, p.del_len, p.ins_content)
               for p in history.patches]
    merged = B.merge_patches(patches)
    lmax = min(max([len(p.ins_content) for p in merged] + [1]), LMAX_CAP)
    ops, _ = B.compile_local_patches(merged, lmax=lmax, dmax=None)
    groups, batch = traffic["groups"], traffic["batch"]
    replay = make_replayer_rle([ops] * groups, capacity=config["capacity"],
                               batch=batch, block_k=config["block_k"],
                               chunk=config["chunk"], device=device)
    cols = (np.asarray(ops.ins_order_start, np.int64),
            np.asarray(ops.ins_len, np.int64))
    return Entry(replay=replay, results=lambda out: list(out),
                 steps=[cols] * groups, documents=groups * batch,
                 counters={"device_steps": ops.num_steps})
