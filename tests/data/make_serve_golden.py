"""Golden record of the JAX package's serve loadgen on a lane backend.

Runs ``text_crdt_rust_tpu.serve.loadgen.ServeLoadGen`` on the
``rle-lanes-mixed`` engine (A7 in Pallas interpret mode, on the CPU) or,
with ``--engine flat``, on the flat engine (``ServeConfig()``'s default,
XLA on the CPU) at pipeline depths 1 and 2 and writes, per depth, what a port run of the
same seed must reproduce: the report's logical fields
(``text_crdt_rust_tpu_torch.serve.loadgen.logical_report``), every
document's string and ``state_digest``, and the sha256 of the logical
trace stream (the stream without its ``"w"`` wall fields).

    JAX_PLATFORMS=cpu python tests/data/make_serve_golden.py \\
        --out tests/data/serve_lanes_golden.json

writes the acceptance shape (200 documents x 3 agents, 60 ticks of 48
events, 10% faults, 2 shards x 16 lanes; ~10 min a depth on a CPU), and

    JAX_PLATFORMS=cpu python tests/data/make_serve_golden.py --engine flat \
        --out tests/data/serve_flat_golden.json

the same shape on the flat engine (~1 min a depth).
``chip_smoke.py`` holds the port's runs on the card against them.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

ACCEPTANCE = dict(docs=200, agents_per_doc=3, ticks=60, events_per_tick=48,
                  zipf_alpha=1.1, fault_rate=0.10, local_prob=0.25, seed=7)
ACCEPTANCE_CFG = dict(engine="rle-lanes-mixed", num_shards=2,
                      lanes_per_shard=16)
#: ``ServeConfig()`` as it stands: the flat engine, 2 x 16 lanes.
FLAT_CFG = dict(engine="flat", num_shards=2, lanes_per_shard=16)


def record_of(gen, report) -> dict:
    """What a run must reproduce, from either package's loadgen (duck
    typed: both expose ``worlds``, ``server`` and the same report)."""
    from text_crdt_rust_tpu_torch.serve.loadgen import logical_report

    docs = {w.doc_id: [gen.server.doc_string(w.doc_id),
                       int(gen.server.doc_digest(w.doc_id))]
            for w in gen.worlds}
    trace = gen.server.tracer.logical_bytes()
    return {"logical": logical_report(report), "docs": docs,
            "trace_sha256": hashlib.sha256(trace).hexdigest(),
            "trace_events": trace.count(b"\n")}


def jax_record(params: dict, cfg_kw: dict, depth: int) -> dict:
    """One JAX loadgen run (CPU, interpret mode) as a golden record."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from text_crdt_rust_tpu.config import ServeConfig
    from text_crdt_rust_tpu.serve.loadgen import ServeLoadGen

    cfg = ServeConfig(pipeline_ticks=depth, trace_keep=True, **cfg_kw)
    gen = ServeLoadGen(cfg=cfg, **params)
    report = gen.run()
    if not report["converged"]:
        raise SystemExit(f"JAX loadgen did not converge: "
                         f"{report['mismatches'][:4]}")
    return record_of(gen, report)


def make_golden(params: dict, cfg_kw: dict, depths=(1, 2)) -> dict:
    """Both depths' records, each run in its own spawned process (the
    runs are independent and each takes minutes at the acceptance
    shape)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(depths), mp_context=ctx) as pool:
        futs = {d: pool.submit(jax_record, params, cfg_kw, d)
                for d in depths}
        recs = {str(d): f.result() for d, f in futs.items()}
    return {"params": params, "cfg": cfg_kw, "depths": recs}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--depths", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--engine", default="rle-lanes-mixed",
                    choices=("rle-lanes-mixed", "flat"))
    a = ap.parse_args(argv)
    cfg_kw = FLAT_CFG if a.engine == "flat" else ACCEPTANCE_CFG
    golden = make_golden(ACCEPTANCE, cfg_kw, tuple(a.depths))
    with open(a.out, "w") as f:
        json.dump(golden, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {a.out}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    main()
