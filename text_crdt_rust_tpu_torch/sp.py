"""Config ``sp`` on the port: the automerge-paper trace replayed into ONE
document whose run rows are sharded over the ``sp`` ranks of a world, on
``SpDoc`` (``parallel/sp_apply.py``, the ``sp-apply`` engine).

The counterpart of the JAX package's ``bench.py`` ``cfg_sp`` and
``perf/sp_bench.py`` (``run_sp``, ``rle_parity``): the trace (or its first
``patches``) is merged and compiled at ``lmax`` = the longest merged insert
with whole deletes, cut into 4 streams padded to one step count,
and applied chunk after chunk to a fresh ``SpDoc`` (on the card through
S1, ``ops/csrc/sp_replay.cu``: one launch a chunk at sp = 1, one a segment
between the collectives at sp > 1) with ``auto_reshard``
(a fresh document holds every live rank in shard 0, so a long stream must
rebalance between chunks). Shard rows come from the run-row dry run
(``ops.rle.simulate_run_rows``' peak) and one chunk's row growth bound
(``batch.row_growth_bound``): ``peak * slack / sp`` plus the bound, as the
JAX script sizes them at ``slack`` = 2.5; ``slack`` = 1 leaves room only for
an even rebalance plus one chunk, so an early chunk overflows shard 0 and
takes the retry. The by-order tables stay small (a local stream never reads
them).

Checks: the text equals the trace's (``endContent`` for the whole trace)
and the native engine's; the expanded order column equals the one the run
replay (A1, ``ops/rle.py``) gives for the same compiled stream (the parity
run; both replay one compile, so the orders agree, not only the text).

    python -m text_crdt_rust_tpu_torch.sp [--patches N] [--sp 1]
        --backend nccl|gloo [--device cpu] [--slack 2.5] [--skip-parity]

prints one JSON line: steps, chunks, shard rows, reshards, collectives a
step (what they count: on the card at sp = 1, S1 makes a one-rank group's
collectives in place and only each chunk's closing OR is a call), S1's
launches (rank 0's; none on the CPU, where the plain version runs) and
the checks. The package reads no clock: ``chip_smoke.py`` runs
the stages (``sp_prepare``, ``sp_replay``, ``sp_read``) as world jobs and
times ``sp_replay`` from its own clock.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
from typing import List, Optional

import numpy as np

from . import resolve_device
from .baseline import native_replay
from .ops import _kernels
from .ops import batch as B
from .ops import span_arrays as SA
from .ops.rle import expand_runs, make_replayer_rle, rle_to_flat, \
    simulate_run_rows
from .parallel import launch
from .parallel.mesh import make_mesh
from .parallel.sp_apply import SpDoc
from .utils.testdata import TestPatch, flatten_patches, load_testing_data, \
    trace_path

TRACE = "automerge-paper"
CHUNKS = 4
SLACK = 2.5            # the JAX script's shard-row headroom over the peak
ORDER_ROWS = 64        # by-order table rows a shard (local streams only)
PARITY_BLOCK_K = 64    # the JAX script's parity geometry on the run replay
PARITY_BATCH = 8


@functools.lru_cache(maxsize=1)
def _trace():
    data = load_testing_data(trace_path(TRACE))
    return tuple(flatten_patches(data)), data.end_content


def trace_patches(patches: Optional[int] = None):
    """The trace's patches (its first ``patches``) and the text they
    leave (``endContent`` for the whole trace). The trace is read once a
    process."""
    ps, end = _trace()
    if patches is None or patches >= len(ps):
        return list(ps), end
    ps = list(ps[:patches])
    s = ""
    for p in ps:
        s = s[:p.pos] + p.ins_content + s[p.pos + p.del_len:]
    return ps, s


def compile_sp(patches: List[TestPatch], chunks: int = CHUNKS):
    """Merge and compile at the longest merged insert, whole deletes:
    ``(ops, [chunk streams padded to one step count], steps a chunk)``."""
    merged = B.merge_patches(patches)
    lmax = max([len(p.ins_content) for p in merged] + [1])
    ops, _ = B.compile_local_patches(merged, lmax=lmax, dmax=None)
    s_chunk = -(-ops.num_steps // chunks)
    parts = [B.pad_ops(B._map_fields(lambda a: np.asarray(a)[i:i + s_chunk],
                                     ops), s_chunk)
             for i in range(0, ops.num_steps, s_chunk)]
    return ops, parts, s_chunk


def shard_rows_for(peak: int, nsp: int, s_chunk: int,
                   slack: float = SLACK) -> int:
    """Run rows a shard: ``peak * slack / nsp`` plus one chunk's row growth
    bound, in whole 8-row groups with 8 to 16 rows over (at ``slack`` = 2.5
    the JAX script's ``((peak * 2.5 // nsp + 2 * s_chunk) // 8 + 2) * 8``)."""
    return ((int(peak * slack) // nsp + B.row_growth_bound(s_chunk) - 1)
            // 8 + 2) * 8


@dataclasses.dataclass
class SpPlan:
    """What every rank needs to build the stream and the document."""

    patches: int           # trace patches replayed
    chunks: int
    nsp: int
    shard_rows: int
    peak_rows: int         # simulate_run_rows' peak
    final_rows: int        # simulate_run_rows' final count


def plan_sp(patches: Optional[int] = None, nsp: int = 1,
            slack: float = SLACK) -> SpPlan:
    """Size the run: the run-row dry run over the merged stream (the
    reference's quadratic list walk, ~20 s on one core for the whole
    trace) and ``shard_rows_for``."""
    ps, _ = trace_patches(patches)
    ops, _, s_chunk = compile_sp(ps)
    peak, final = simulate_run_rows(B.merge_patches(ps))
    return SpPlan(patches=len(ps), chunks=CHUNKS, nsp=nsp,
                  shard_rows=shard_rows_for(peak, nsp, s_chunk, slack),
                  peak_rows=peak, final_rows=final)


# -- the stages each rank runs (world jobs) ---------------------------------


def sp_prepare(ctx, plan: SpPlan) -> Optional[dict]:
    """Build the stream and a fresh ``SpDoc`` on this rank (kept in
    ``ctx.store`` for the next stages); the stream's shape. Ranks of the
    world past ``nsp`` only join the process groups (they answer None to
    every stage)."""
    ctx.store.pop("sp", None)
    mesh = make_mesh(n_devices=plan.nsp, dp=1, sp=plan.nsp,
                     device=ctx.device)
    if not mesh.member:
        return None
    ps, want = trace_patches(plan.patches)
    ops, parts, s_chunk = compile_sp(ps, plan.chunks)
    doc = SpDoc(mesh, plan.shard_rows, ORDER_ROWS, auto_reshard=True)
    ctx.store["sp"] = dict(doc=doc, ops=ops, parts=parts, mesh=mesh)
    return dict(steps=ops.num_steps, s_chunk=s_chunk, lmax=ops.lmax,
                device=str(ctx.device),
                backend=ctx.backend, shared_card=ctx.shared_card)


def sp_replay(ctx) -> Optional[dict]:
    """Apply every chunk to the empty document (each chunk's error bits
    read back, so the replay has finished when this returns); the
    reshards, the collective calls and this rank's kernel launches (the
    counts set to 0 first)."""
    st = ctx.store.get("sp")
    if st is None:
        return None
    doc, mesh = st["doc"], st["mesh"]
    doc.load(np.zeros(0, np.int32), np.zeros(0, np.int32))
    doc.reshards = 0
    calls0 = dict(mesh.calls)
    _kernels.reset_launches()
    for part in st["parts"]:
        doc.apply_stream(part)
    calls = {k: v - calls0.get(k, 0) for k, v in mesh.calls.items()}
    return dict(reshards=doc.reshards, calls=calls,
                collectives=calls.get("all_gather", 0)
                + calls.get("sum", 0), launches=dict(_kernels.launches))


def sp_read(ctx) -> Optional[dict]:
    """Read the document back: the packed runs, the expanded order column,
    the text and the rows each shard holds."""
    st = ctx.store.get("sp")
    if st is None:
        return None
    doc = st["doc"]
    return dict(runs=doc.runs(), expand=doc.expand(),
                text=doc.to_string([st["ops"]]),
                rows=doc.planes()["rows"].tolist())


# -- the parity run on A1 and the whole run ---------------------------------


def rle_parity(patches: List[TestPatch], peak_rows: int, device=None):
    """The same compile replayed by the run replay (A1 on the card) at the
    JAX script's parity geometry (capacity 2.5 x the run-row peak):
    ``(per-char order column, text)`` of document 0."""
    ops, _, _ = compile_sp(patches, 1)
    peak = peak_rows
    capacity = max(((int(peak * 2.5) + 255) // 256) * 256, 512)
    res = make_replayer_rle(ops, capacity=capacity, batch=PARITY_BATCH,
                            block_k=PARITY_BLOCK_K, chunk=128,
                            device=device)()
    res.check()
    return expand_runs(res), SA.to_string(rle_to_flat(ops, res))


@dataclasses.dataclass
class SpRun:
    """One replay of config ``sp`` and its checks."""

    plan: SpPlan
    shape: dict
    replay: dict
    read: dict
    want: str
    native_text: str
    parity: Optional[tuple] = None   # A1's (order column, text)

    @property
    def text_ok(self) -> bool:
        return self.read["text"] == self.want

    @property
    def native_ok(self) -> bool:
        return self.native_text == self.want

    @property
    def parity_ok(self) -> Optional[bool]:
        if self.parity is None:
            return None
        return (np.array_equal(self.parity[0], self.read["expand"])
                and self.parity[1] == self.want)

    @property
    def ok(self) -> bool:
        return self.text_ok and self.native_ok and self.parity_ok is not False

    def summary(self) -> dict:
        steps = self.shape["steps"]
        return dict(patches=self.plan.patches, steps=steps,
                    chunks=self.plan.chunks, sp=self.plan.nsp,
                    shard_rows=self.plan.shard_rows,
                    peak_rows=self.plan.peak_rows,
                    rows=self.read["rows"],
                    reshards=self.replay["reshards"],
                    collectives_per_step=self.replay["collectives"] / steps,
                    collectives_what=collectives_what(
                        self.plan.nsp, self.replay["launches"]),
                    launches=self.replay["launches"],
                    calls=self.replay["calls"],
                    backend=self.shape["backend"],
                    device=self.shape["device"],
                    shared_card=self.shape["shared_card"],
                    text_ok=self.text_ok, native_ok=self.native_ok,
                    parity_ok=self.parity_ok, ok=self.ok)


def collectives_what(nsp: int, launches: dict) -> str:
    """What ``collectives_per_step`` counts: ``Mesh`` calls, all of them
    but where S1 ran at sp = 1, which makes a one-rank group's
    collectives in place and leaves only each stream's closing OR."""
    if nsp == 1 and launches.get("sp_replay", 0):
        return ("the closing OR of each stream only: S1 makes a one-rank "
                "group's collectives in place")
    return "Mesh all_gather and sum calls"


def run_sp(patches: Optional[int] = None, nsp: int = 1, *, backend: str,
           device=None, slack: float = SLACK, parity: bool = True,
           world: Optional[launch.World] = None,
           plan: Optional[SpPlan] = None) -> SpRun:
    """Plan (unless a ``plan`` is given: it then sets the patches, ``sp``
    and the rows), replay on a world of ``plan.nsp`` ranks (``backend``
    and ``device`` as ``parallel.launch`` takes them; pass a running
    ``world`` of at least as many ranks to reuse it), read back, run the
    native engine and, with ``parity``, A1 on ``device`` (rank 0's card
    when ``device`` is None)."""
    if plan is None:
        plan = plan_sp(patches, nsp, slack)
    own = world is None
    if own:
        world = launch.World(plan.nsp, backend, device)
    try:
        shape = world.run(sp_prepare, plan)
        replay = world.run(sp_replay)
        read = world.run(sp_read)
    finally:
        if own:
            world.close()
    ps, want = trace_patches(plan.patches)
    par = None
    if parity:
        par = rle_parity(ps, plan.peak_rows, resolve_device(
            device if device is not None else "cuda"))
    return SpRun(plan=plan, shape=shape, replay=replay, read=read, want=want,
                 native_text=native_replay(ps).to_string(), parity=par)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--patches", type=int, default=None,
                    help="trace prefix (default: the whole trace)")
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--slack", type=float, default=SLACK)
    ap.add_argument("--backend", required=True, choices=("nccl", "gloo"))
    ap.add_argument("--device", default=None,
                    help="cpu, one card to share (cuda:0), or unset: one "
                         "card a rank")
    ap.add_argument("--skip-parity", action="store_true")
    args = ap.parse_args(argv)
    run = run_sp(args.patches, args.sp, backend=args.backend,
                 device=args.device, slack=args.slack,
                 parity=not args.skip_parity)
    print(json.dumps(run.summary()))
    return 0 if run.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
