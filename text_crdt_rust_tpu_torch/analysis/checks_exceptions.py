"""TCR-X001: no silent exception swallowing on the serving path.

The serving stack's error discipline: a fault is either **re-raised** (or converted to
a typed error), **counted** (a metrics counter or an explicit tally),
or **reported** (a trace event / flight-recorder notification).  A
``try/except`` under ``serve/`` or ``net/`` that does none of these is
a black hole — the byzantine loadgen class and the crash harness both
exist to prove faults are LOUD, and a swallowing handler un-proves it
one call site at a time.

A handler passes when its body (recursively) contains any of:

- a ``raise`` statement (re-raise or typed conversion);
- a notifier call: ``.incr`` / ``.hiwater`` / ``.sample`` / ``.event``
  / ``.on_failure`` / ``.on_divergence`` (the metrics registry, the
  tracer, and the flight recorder — the repo's three reporting
  surfaces), a ``logging``-style ``.warning``/``.error``/
  ``.exception``, or a rejection recorder (any method whose name
  contains ``reject`` — the router's flow-span rejection path);
- a typed-error CONSTRUCTION (a call to a ``*Error`` name) — the
  by-value conversion idiom of scanners that return ``(records,
  typed_error)`` instead of raising mid-stream;
- an augmented assignment (``stats["x"] += 1``, ``self.rejections += 1``
  — the inline-tally idiom recovery and the loadgen use).

Anything else is a finding; deliberate swallows (a filename-pattern
filter skipping foreign files, a harness catching its own injected
kill signal) are granted in ``LINT_ALLOWLIST.json`` with a
justification, like every other check.
"""
from __future__ import annotations

import ast
from typing import List

from .tcrlint import FileContext, Finding

#: Only the serving path carries the loud-fault contract; ops/ kernels
#: and analysis tooling have their own disciplines.
TARGET_DIRS = ("/serve/", "/net/")

#: Method names whose call counts as "the fault was reported".
NOTIFY_CALLS = {"incr", "hiwater", "sample", "event", "on_failure",
                "on_divergence", "warning", "error", "exception"}


def _handler_reports(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.AugAssign)):
            return True
        if not isinstance(node, ast.Call):
            continue
        if (isinstance(node.func, ast.Attribute)
                and (node.func.attr in NOTIFY_CALLS
                     or "reject" in node.func.attr)):
            return True
        # Typed conversion by value: constructing SomethingError to
        # hand upward (the scan() ``(records, error)`` idiom).
        if (isinstance(node.func, ast.Name)
                and node.func.id.endswith("Error")):
            return True
    return False


def _caught_name(handler: ast.ExceptHandler) -> str:
    if handler.type is None:
        return "<bare except>"
    try:
        return ast.unparse(handler.type)
    except Exception:
        return "<exception>"


def check(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    if not any(d in "/" + ctx.rel for d in TARGET_DIRS):
        return out
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if _handler_reports(node):
            continue
        out.append(ctx.finding(
            "TCR-X001", node,
            f"except {_caught_name(node)}: handler neither re-raises, "
            f"raises a typed error, counts, nor notifies the "
            f"tracer/recorder — a swallowed fault on the serving path "
            f"(grant deliberate swallows in the allowlist)"))
    return out
