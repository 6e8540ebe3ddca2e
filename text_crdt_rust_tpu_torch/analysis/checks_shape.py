"""TCR-K00x: shape-contract checking against the pinned bucket series
(the port's counterpart of the JAX package's family).

Serving keeps a small, DECLARED set of shapes: tick step counts from
``ServeConfig.step_buckets``, prefill scatter lengths from
``ops.batch.scatter_bucket``'s geometric series
(``PREFILL_BUCKET_BASE * 4^k``), and each CUDA kernel's launch
arguments (the device tensors and shape scalars its wrapper stages,
read from the ``_kernels.function(kernel, symbol, argtypes)``
bindings).  The JAX package's steady state is compile-free only on
those shapes, the port's serve reports count the same shape sets
(``shapes_seen``, the train and scatter compiles) for parity, and a
launch whose argument list drifts from its C interface shifts every
pointer after the change.  This check family pins the series and lints
the call sites:

- **TCR-K002** — the declared series are HARVESTED from the live AST
  (``harvest_contracts``) and pinned in ``SHAPE_CONTRACTS.json`` next
  to the engine; drift between the live tree and the pin is a finding,
  refreshed via the existing ``--update-pins`` discipline (the same
  re-pin-in-the-same-diff review moment as TCR-S003).  Pinned
  surfaces: the scatter series (base + growth factor), the default
  step buckets, and each kernel module's launch arguments per symbol
  (ctypes counts: ``c_void_p`` tensors and the stream, ``c_int``
  scalars).

- **TCR-K001** — call sites whose shape argument resolves statically
  (a literal, or a name all of whose reaching definitions bind one int
  — ``dataflow.FunctionFlow.const_int``) must land ON the pinned
  series: ``pad_ops(stream, S)`` / ``empty_ops``-padded stacks /
  ``chunk=`` of the blocked lanes replayer against the step buckets,
  ``PrefillDelta(..., bucket=L)`` / scatter-length pads against the
  scatter series.  Dynamically-computed shapes are skipped — those
  flow from the config at runtime and the ``shapes_seen`` counts own
  them; what the lint ratchets is the hard-coded off-series constant.
"""
from __future__ import annotations

import ast
import json
import os
from typing import Dict, List, Optional

from .dataflow import FunctionFlow, call_leaf, iter_functions
from .tcrlint import FileContext, Finding, dotted_name

SHAPE_PINS_PATH = os.path.join(os.path.dirname(__file__),
                               "SHAPE_CONTRACTS.json")

#: Where each declared series lives.
BATCH_FILE = "text_crdt_rust_tpu_torch/ops/batch.py"
CONFIG_FILE = "text_crdt_rust_tpu_torch/config.py"
KERNEL_GLOB_DIR = "text_crdt_rust_tpu_torch/ops"

#: Call sites checked against the STEP-bucket series (argument position
#: or keyword holding the shape — keyword names match the real
#: signatures: ``pad_ops(ops, num_steps)``).
STEP_SITES = {"pad_ops": (1, "num_steps"),
              "make_replayer_lanes_mixed_blocked": (None, "chunk")}

#: Call sites checked against the SCATTER series.
SCATTER_SITES = {"PrefillDelta": (None, "bucket")}


def _parse(root: str, rel: str) -> Optional[ast.Module]:
    path = os.path.join(root, rel)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return ast.parse(f.read(), filename=rel)


def _module_const(tree: ast.Module, name: str):
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Name) and t.id == name
                        and isinstance(node.value, ast.Constant)):
                    return node.value.value
        elif (isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)
              and node.target.id == name
              and isinstance(node.value, ast.Constant)):
            return node.value.value
    return None


def _scatter_factor(tree: ast.Module) -> Optional[int]:
    """The geometric growth factor from ``scatter_bucket``'s body
    (``b *= 4``)."""
    for _qual, fn in iter_functions(tree):
        if fn.name != "scatter_bucket":
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.AugAssign)
                    and isinstance(node.op, ast.Mult)
                    and isinstance(node.value, ast.Constant)):
                return node.value.value
    return None


def _step_buckets(tree: ast.Module) -> Optional[List[int]]:
    """``ServeConfig.step_buckets`` default tuple."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "ServeConfig":
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)
                        and stmt.target.id == "step_buckets"
                        and isinstance(stmt.value, ast.Tuple)):
                    vals = [e.value for e in stmt.value.elts
                            if isinstance(e, ast.Constant)]
                    return vals if len(vals) == len(
                        stmt.value.elts) else None
    return None


def _argtype_counts(node: ast.AST) -> Optional[Dict[str, int]]:
    """ctypes argument counts of an argtypes expression: ``[t] * n``
    lists and ``+``-concatenations thereof, keyed by the type's leaf name
    (``c_void_p``: a staged tensor's pointer or the stream; ``c_int``: a
    shape scalar).  None when the expression is not of that form."""
    if isinstance(node, (ast.List, ast.Tuple)):
        out: Dict[str, int] = {}
        for elt in node.elts:
            leaf = dotted_name(elt)
            if leaf is None:
                return None
            key = leaf.split(".")[-1]
            out[key] = out.get(key, 0) + 1
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        base, times = node.left, node.right
        if isinstance(base, ast.Constant):
            base, times = times, base
        counts = _argtype_counts(base)
        if counts is None or not (isinstance(times, ast.Constant)
                                  and isinstance(times.value, int)):
            return None
        return {k: v * times.value for k, v in counts.items()}
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _argtype_counts(node.left)
        right = _argtype_counts(node.right)
        if left is None or right is None:
            return None
        out = dict(left)
        for k, v in right.items():
            out[k] = out.get(k, 0) + v
        return out
    return None


def _module_values(tree: ast.Module) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.value
    return out


def _launch_columns(root: str) -> Dict[str, Dict[str, Dict[str, int]]]:
    """Per kernel module, per launch symbol, the ctypes argument counts
    of every ``_kernels.function(kernel, symbol, argtypes)`` binding: the
    device tensors (pointers) and shape scalars each wrapper stages for
    its CUDA launch."""
    out: Dict[str, Dict[str, Dict[str, int]]] = {}
    dirpath = os.path.join(root, KERNEL_GLOB_DIR)
    if not os.path.isdir(dirpath):
        return out
    for fn in sorted(os.listdir(dirpath)):
        if not fn.endswith(".py"):
            continue
        rel = f"{KERNEL_GLOB_DIR}/{fn}"
        tree = _parse(root, rel)
        if tree is None:
            continue
        consts = _module_values(tree)
        launches: Dict[str, Dict[str, int]] = {}
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and (dotted_name(node.func) or "").endswith(
                        "_kernels.function")
                    and len(node.args) == 3):
                continue
            sym, argtypes = node.args[1], node.args[2]
            if isinstance(sym, ast.Name):
                sym = consts.get(sym.id, sym)
            if isinstance(argtypes, ast.Name):
                argtypes = consts.get(argtypes.id, argtypes)
            counts = _argtype_counts(argtypes)
            if (isinstance(sym, ast.Constant) and isinstance(sym.value, str)
                    and counts):
                launches[sym.value] = counts
        if launches:
            out[rel] = launches
    return out


def _launch_lines(root: str) -> Dict[str, int]:
    """Per kernel module, the line of its first launch binding's
    argtypes (where a drift is read and repaired)."""
    out: Dict[str, int] = {}
    dirpath = os.path.join(root, KERNEL_GLOB_DIR)
    if not os.path.isdir(dirpath):
        return out
    for fn in sorted(os.listdir(dirpath)):
        rel = f"{KERNEL_GLOB_DIR}/{fn}"
        tree = _parse(root, rel) if fn.endswith(".py") else None
        if tree is None:
            continue
        consts = _module_values(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and (dotted_name(node.func) or "").endswith(
                        "_kernels.function") and len(node.args) == 3):
                arg = node.args[2]
                if isinstance(arg, ast.Name) and arg.id in consts:
                    arg = consts[arg.id]
                line = getattr(arg, "lineno", node.lineno)
                out[rel] = min(out.get(rel, line), line)
    return out


def _series_line(root: str, name: str) -> int:
    """The line that declares a pinned series (1 when not found)."""
    rel = {"scatter-series": BATCH_FILE,
           "step-buckets": CONFIG_FILE}.get(name)
    tree = _parse(root, rel) if rel else None
    if tree is None:
        return 1
    for node in ast.walk(tree):
        target = (node.targets[0] if isinstance(node, ast.Assign)
                  and len(node.targets) == 1 else
                  node.target if isinstance(node, ast.AnnAssign) else None)
        if isinstance(target, ast.Name) and target.id in (
                "PREFILL_BUCKET_BASE", "step_buckets"):
            return node.lineno
    return 1


def harvest_contracts(root: str) -> Optional[dict]:
    """The live declared-series state; None when none of the declaring
    files exist under ``root`` (temp trees — nothing to pin)."""
    out: dict = {}
    batch = _parse(root, BATCH_FILE)
    if batch is not None:
        base = _module_const(batch, "PREFILL_BUCKET_BASE")
        factor = _scatter_factor(batch)
        if base is not None and factor is not None:
            out["scatter-series"] = {"file": BATCH_FILE, "base": base,
                                     "factor": factor, "depth": 6}
    cfg = _parse(root, CONFIG_FILE)
    if cfg is not None:
        buckets = _step_buckets(cfg)
        if buckets:
            out["step-buckets"] = {"file": CONFIG_FILE,
                                   "buckets": buckets}
    launch = _launch_columns(root)
    if launch:
        out["launch-op-columns"] = launch
    return out or None


def check_shape_pins(root: str, pins_path: str,
                     update: bool = False) -> List[Finding]:
    """TCR-K002: live harvested series vs the committed pin; with
    ``update=True`` rewrite the pin instead (the --update-pins
    discipline)."""
    live = harvest_contracts(root)
    if live is None:
        return []
    pins_rel = os.path.relpath(pins_path, root).replace(os.sep, "/")
    if update:
        with open(pins_path, "w") as f:
            json.dump({"comment":
                       "tcrlint TCR-K shape contracts — the declared "
                       "bucket series (scatter geometric series, "
                       "serve step buckets, CUDA kernel launch "
                       "arguments) harvested from the live AST; "
                       "regenerate with "
                       "python -m text_crdt_rust_tpu_torch.analysis.lint "
                       "--update-pins and commit alongside the series "
                       "change that motivated it",
                       "contracts": live}, f, indent=1, sort_keys=True)
            f.write("\n")
        return []
    if not os.path.exists(pins_path):
        return [Finding(
            check="TCR-K002", path=pins_rel, line=1, scope="<pins>",
            message="shape contracts pin file missing — run the lint "
                    "with --update-pins and commit it")]
    with open(pins_path) as f:
        pinned = json.load(f)["contracts"]
    out: List[Finding] = []
    for name in sorted(set(live) | set(pinned)):
        if name not in pinned:
            out.append(Finding(
                check="TCR-K002", path=pins_rel, line=1, scope="<pins>",
                message=f"shape surface {name!r} has no pin — run "
                        f"--update-pins and commit the diff"))
        elif name not in live:
            out.append(Finding(
                check="TCR-K002", path=pins_rel, line=1, scope="<pins>",
                message=f"pinned shape surface {name!r} no longer "
                        f"harvests from the tree — re-pin "
                        f"(--update-pins) or restore the series"))
        elif name == "launch-op-columns":
            lines = _launch_lines(root)
            for rel in sorted(set(live[name]) | set(pinned[name])):
                have, want = live[name].get(rel), pinned[name].get(rel)
                if have == want:
                    continue
                out.append(Finding(
                    check="TCR-K002", path=rel if have else pins_rel,
                    line=lines.get(rel, 1), scope="<module>",
                    message=f"kernel launch arguments of {rel} drifted "
                            f"from their pin ({want} -> {have}) — a "
                            f"wrapper's argument list must change with "
                            f"its kernel's C interface; re-pin "
                            f"(--update-pins) in this same change so the "
                            f"diff shows it"))
        elif live[name] != pinned[name]:
            where = (live[name].get("file", pins_rel)
                     if isinstance(live[name], dict) else pins_rel)
            out.append(Finding(
                check="TCR-K002", path=where,
                line=_series_line(root, name), scope="<module>",
                message=f"declared shape series {name!r} drifted from "
                        f"its pin ({pinned[name]} -> {live[name]}) — "
                        f"a bucket-series change re-keys the serve "
                        f"shapes; re-pin (--update-pins) in this same "
                        f"change so the diff shows it"))
    return out


# -- TCR-K001: static call-site shapes ---------------------------------------


def load_series(pins_path: str = SHAPE_PINS_PATH) -> Optional[dict]:
    if not os.path.exists(pins_path):
        return None
    with open(pins_path) as f:
        return json.load(f)["contracts"]


def _scatter_series(contract: dict) -> List[int]:
    base, factor = contract["base"], contract["factor"]
    return [base * factor ** k for k in range(contract.get("depth", 6))]


def _shape_arg(call: ast.Call, pos: Optional[int],
               kw: Optional[str]) -> Optional[ast.AST]:
    if pos is not None and len(call.args) > pos:
        return call.args[pos]
    if kw is not None:
        for k in call.keywords:
            if k.arg == kw:
                return k.value
    return None


def check(ctx: FileContext,
          series: Optional[dict] = None) -> List[Finding]:
    if series is None:
        series = load_series()
    if not series:
        return []
    steps = (series.get("step-buckets") or {}).get("buckets") or []
    scatter = (_scatter_series(series["scatter-series"])
               if "scatter-series" in series else [])
    sites = []
    if steps:
        sites.append((STEP_SITES, steps, "step-bucket series",
                      "ServeConfig.step_buckets"))
    if scatter:
        sites.append((SCATTER_SITES, scatter, "scatter-bucket series",
                      "ops.batch.scatter_bucket"))
    if not sites:
        return []
    out: List[Finding] = []
    for _qual, fn in iter_functions(ctx.tree):
        flow: Optional[FunctionFlow] = None
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            leaf = call_leaf(node)
            for table, allowed, label, source in sites:
                if leaf not in table:
                    continue
                arg = _shape_arg(node, *table[leaf])
                if arg is None:
                    continue
                if flow is None:
                    flow = FunctionFlow(fn)
                at = flow.stmt_of(node, ctx.parents)
                value = (flow.const_int(arg, at)
                         if at is not None else None)
                if value is None or value in allowed:
                    continue
                out.append(ctx.finding(
                    "TCR-K001", node,
                    f"{leaf}(...) pads to static shape {value}, off "
                    f"the pinned {label} {allowed} ({source}) — an "
                    f"off-series shape is a serve shape of its own; draw "
                    f"the shape from the declared series or extend the "
                    f"series and re-pin (--update-pins)"))
    return out
