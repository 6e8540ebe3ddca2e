"""TCR-W001: wall-clock segregation.

The whole-repo determinism story rests on one rule: wall
time may be *measured* anywhere, but the measurement may only land in
an obs ``"w"`` field or an explicitly-perf surface — never in a value
that reaches a logical trace event, a ledger metric, a bench-row
logical field, or a wire byte.  Static taint tracking through the
whole serving loop is out of scope for a lint; what IS in scope, and
what actually ratchets, is naming every wall-clock *read* and making
each one pass an audit: every call site is a finding unless a
committed allowlist entry grants its (file, scope) with a one-line
justification.  A new ``perf_counter()`` anywhere in the package then
fails CI until someone has looked at where its value flows — which is
exactly the review moment that was missing while the ``"w"``
convention was kept by convention alone.  In the port no module reads
the clock at all: callers pass ``clock=`` from outside.
"""
from __future__ import annotations

import ast
from typing import List

from .tcrlint import FileContext, Finding, dotted_name

CHECK = "TCR-W001"

#: Attribute chains that read the wall clock.  ``monotonic`` counts:
#: logical determinism does not care that it never jumps backwards.
WALL_CALLS = {
    "time.time", "time.time_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

#: Bare names that are wall reads when imported directly
#: (``from time import perf_counter``).
WALL_BARE = {"perf_counter", "perf_counter_ns", "monotonic",
             "monotonic_ns", "process_time", "time_ns"}


def check(ctx: FileContext) -> List[Finding]:
    # Track ``from time import perf_counter``-style names so bare calls
    # are caught; a bare ``time()`` is too ambiguous to flag without it.
    imported_bare: set = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom) and node.module in (
                "time", "datetime"):
            for alias in node.names:
                name = alias.asname or alias.name
                if alias.name in WALL_BARE | {"time"}:
                    imported_bare.add(name)

    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        hit = None
        if name in WALL_CALLS:
            hit = name
        elif (isinstance(node.func, ast.Name)
              and node.func.id in imported_bare):
            hit = node.func.id
        if hit:
            out.append(ctx.finding(
                CHECK, node,
                f"wall-clock read {hit}() — wall time may only feed obs "
                f'"w" fields or allowlisted perf probes (audit the flow '
                f"and add a justified LINT_ALLOWLIST.json entry for "
                f"scope {ctx.scope_of(node)!r})"))
    return out
