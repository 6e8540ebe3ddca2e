"""The control and the faults of a cell, on the card at the cell's own
size: each takes the program's place under the window, and ``correct``
has to come out false (``faults.py``). Not run by the benchmark's runs.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--faults] [--seconds 2]

prints one JSON line a run: the kind (``control`` or a fault), the seed,
``correct`` and the numbers the check compared.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def control_wrap(replay, entry, history):
    """The plain reference in 16-bit orders, in the program's place."""
    from portbench import faults
    from portbench.reference import splice
    exp = faults.lower_precision(splice.replay(history.patches))
    made = []

    def call():
        if not made:
            made.extend(faults.as_outputs(exp, r, s) for r, s in
                        zip(entry.results(replay()), entry.steps))
        return list(made)

    return call


def fault_wrap(name):
    def wrap(replay, entry, history):
        from portbench import faults
        return lambda: faults.FAULTS[name](entry.results(replay()))
    return wrap


def main(argv=None) -> int:
    import torch

    from portbench import faults, spec
    from portbench.run import run_cell
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    kinds = [("control", control_wrap)]
    if args.faults:
        kinds += [(n, fault_wrap(n)) for n in faults.FAULTS]
    for seed in (int(s) for s in args.seeds.split(",")):
        for kind, wrap in kinds:
            r = run_cell(cell, seed, args.seconds, False,
                         torch.device("cuda", 0), spec.HERE, wrap=wrap,
                         t0=time.perf_counter())
            print(json.dumps({"kind": kind, "workload": args.workload,
                              "seed": seed, "correct": r["correct"],
                              "check": r["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
