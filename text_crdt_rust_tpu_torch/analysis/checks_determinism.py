"""TCR-D00x: determinism hazards.

Four hazard shapes, each one a way a run stops being a pure function
of its seed:

- **TCR-D001** builtin ``hash()``: salted per process since Python 3.3
  (PYTHONHASHSEED), so any value derived from it differs across runs.
  Stable digests exist (``zlib.crc32``, ``hashlib``) — use those.
- **TCR-D002** order-sensitive set iteration: ``for x in {...}`` /
  ``set(...)``, or ``list``/``tuple``/``enumerate``/``join`` over a
  set expression.  Set iteration order is insertion-and-hash dependent;
  anything it feeds (serialization, trace emission, frame order) drifts
  across processes.  ``sorted(set(...))`` and order-free consumers
  (``len``/``sum``/``min``/``max``/``any``/``all``/set algebra) pass.
- **TCR-D003** unsorted directory walks: ``os.listdir`` / ``glob.glob``
  / ``iglob`` / ``Path.glob`` / ``iterdir`` / ``scandir`` return OS
  order — checkpoint-chain walks and obs-segment walks must wrap them
  in ``sorted(...)`` *directly* (a sort three lines later is invisible
  to the lint and to the next reader).
- **TCR-D004** unseeded global randomness: module-level ``random.*`` /
  ``np.random.*`` draws share interpreter-global state no seed in this
  repo controls.  Seeded instances (``random.Random(seed)``,
  ``np.random.default_rng(seed)``, ``RandomState(seed)``) pass.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from .tcrlint import FileContext, Finding, dotted_name

#: Consumers for which the argument's iteration order cannot matter.
ORDER_FREE = {"sorted", "len", "sum", "min", "max", "any", "all",
              "frozenset", "set"}

#: Order-sensitive consumers of an iterable argument.
ORDER_SENSITIVE = {"list", "tuple", "enumerate", "iter", "zip", "map"}

DIR_WALKS = {"os.listdir": "os.listdir", "glob.glob": "glob.glob",
             "glob.iglob": "glob.iglob", "os.scandir": "os.scandir"}
DIR_WALK_METHODS = {"glob", "rglob", "iterdir"}  # pathlib spellings

#: ``random`` module-level draw functions (not the Random class).
RANDOM_FNS = {"random", "randint", "randrange", "choice", "choices",
              "shuffle", "sample", "uniform", "gauss", "betavariate",
              "expovariate", "getrandbits", "randbytes", "triangular"}

SEEDED_NP = {"default_rng", "RandomState", "Generator", "SeedSequence",
             "PCG64", "Philox"}


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "set")


def _consumer(ctx: FileContext, node: ast.AST) -> Optional[str]:
    """Name of the call directly consuming ``node`` as an argument."""
    parent = ctx.parent_of(node)
    if (isinstance(parent, ast.Call) and node in parent.args
            and isinstance(parent.func, ast.Name)):
        return parent.func.id
    # "".join(set_expr) — attribute call consumer.
    if (isinstance(parent, ast.Call) and node in parent.args
            and isinstance(parent.func, ast.Attribute)):
        return parent.func.attr
    return None


def _check_set_order(ctx: FileContext, out: List[Finding]) -> None:
    for node in ast.walk(ctx.tree):
        if not _is_set_expr(node):
            continue
        parent = ctx.parent_of(node)
        # for x in {…} / comprehension iteration.
        if ((isinstance(parent, (ast.For, ast.AsyncFor))
             and parent.iter is node)
                or (isinstance(parent, ast.comprehension)
                    and parent.iter is node)):
            out.append(ctx.finding(
                "TCR-D002", node,
                "iteration over a set — order is hash/insertion "
                "dependent; wrap in sorted(...) before it can feed "
                "serialization, trace or frame order"))
            continue
        consumer = _consumer(ctx, node)
        if consumer in ORDER_SENSITIVE or consumer == "join":
            out.append(ctx.finding(
                "TCR-D002", node,
                f"{consumer}(<set>) materializes set order — wrap in "
                f"sorted(...) (order-free reducers like len/sum/min "
                f"pass unflagged)"))


def _check_dir_walks(ctx: FileContext, out: List[Finding]) -> None:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        label = DIR_WALKS.get(name or "")
        if (label is None and isinstance(node.func, ast.Attribute)
                and node.func.attr in DIR_WALK_METHODS
                and name is not None
                and name.split(".")[0] not in ("glob", "os")):
            # p.glob(...) / p.iterdir() — pathlib spelling; the root
            # guard keeps glob.glob from double-reporting here.
            label = f"<path>.{node.func.attr}"
        if label is None:
            continue
        if _consumer(ctx, node) == "sorted":
            continue
        out.append(ctx.finding(
            "TCR-D003", node,
            f"{label}(...) returns OS order — wrap the call directly "
            f"in sorted(...); checkpoint-chain and obs-segment walks "
            f"must not depend on filesystem enumeration order"))


def _check_randomness(ctx: FileContext, out: List[Finding]) -> None:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name is None:
            continue
        parts = name.split(".")
        # random.<draw>() on the MODULE (seeded instances have a
        # non-"random" root: self.rng.choice, rng.random, ...).
        if (parts[0] == "random" and len(parts) == 2
                and parts[1] in RANDOM_FNS):
            out.append(ctx.finding(
                "TCR-D004", node,
                f"module-global random.{parts[1]}() is unseeded shared "
                f"state — draw from a random.Random(seed) instance"))
        elif parts[0] == "random" and parts[-1] == "seed":
            out.append(ctx.finding(
                "TCR-D004", node,
                "random.seed() mutates interpreter-global state — use "
                "a random.Random(seed) instance instead"))
        # np.random.<fn>() legacy global (np.random.default_rng(seed)
        # and the seeded constructors pass).
        elif (len(parts) >= 3 and parts[-2] == "random"
              and parts[0] in ("np", "numpy")
              and parts[-1] not in SEEDED_NP):
            out.append(ctx.finding(
                "TCR-D004", node,
                f"legacy numpy global RNG {name}() — use "
                f"np.random.default_rng(seed)"))
        elif (len(parts) >= 3 and parts[-2] == "random"
              and parts[0] in ("np", "numpy")
              and parts[-1] in ("default_rng", "RandomState")
              and not node.args and not node.keywords):
            out.append(ctx.finding(
                "TCR-D004", node,
                f"{name}() without a seed is entropy-seeded — pass an "
                f"explicit seed"))


def _check_hash(ctx: FileContext, out: List[Finding]) -> None:
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "hash"):
            out.append(ctx.finding(
                "TCR-D001", node,
                "builtin hash() is salted per process "
                "(PYTHONHASHSEED) — use zlib.crc32 or hashlib for any "
                "value that outlives the interpreter"))


def check(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    _check_hash(ctx, out)
    _check_set_order(ctx, out)
    _check_dir_walks(ctx, out)
    _check_randomness(ctx, out)
    return out
