"""TCR-F401: unused module-level imports (the ruff fallback).

The ruff baseline (``pyproject.toml [tool.ruff]``) is the third-party
half of the tier-1 lint gate, but this container may not ship ruff and
the gate must not silently weaken when it is absent — so the most
load-bearing pyflakes rule (F401, unused imports: the one that hides
real dead code and stale dependencies) has a built-in AST
implementation.  When ruff IS installed the CLI runs it too; this
module keeps the floor either way.

Scope is deliberately narrow to stay false-positive-free:

- module-level ``import``/``from import`` only (function-local imports
  are often lazy-load-by-design here — triton, the kernel builds — and
  cheap to eyeball);
- ``__init__.py`` files are exempt (re-export surface);
- a ``# noqa`` on the import line is honored (ruff parity);
- ``__all__`` membership counts as a use.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from .tcrlint import FileContext, Finding


def _used_names(tree: ast.Module) -> set:
    used: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            # the chain root is collected via its Name node anyway
            pass
    # __all__ = ["name", ...] re-exports.
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets)):
            for elt in ast.walk(node.value):
                if (isinstance(elt, ast.Constant)
                        and isinstance(elt.value, str)):
                    used.add(elt.value)
    return used


def check(ctx: FileContext) -> List[Finding]:
    if ctx.rel.endswith("__init__.py"):
        return []
    binds: Dict[str, ast.AST] = {}
    for node in ctx.tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                binds[name] = node
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                binds[alias.asname or alias.name] = node
    if not binds:
        return []
    used = _used_names(ctx.tree)
    out: List[Finding] = []
    for name, node in sorted(binds.items(),
                             key=lambda kv: kv[1].lineno):
        if name in used:
            continue
        line = ctx.lines[node.lineno - 1] if (
            node.lineno - 1 < len(ctx.lines)) else ""
        if "noqa" in line:
            continue
        out.append(ctx.finding(
            "TCR-F401", node,
            f"{name!r} imported but unused"))
    return out
