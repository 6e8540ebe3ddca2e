"""TCR-P001: dispatch-buffer escape analysis — the static twin of the
runtime pipeline aliasing sanitizer (the port's counterpart of the JAX
package's family).

The pipelined tick lets a device step stay in flight through the next
host tick: the batcher hands ``stack_ops``-built op tensors to
``backend.apply``, and on the CPU ``torch.from_numpy`` shares storage
with the numpy buffers host code still holds, while on the card the
pinned staging copies run behind the stream.  A host write into any of
those buffers between dispatch and that entry's staged sync silently
corrupts the in-flight step.  The runtime sanitizer
(``PipelineAliasingError``) catches this by CRC-fingerprinting the
dispatched tensors; this check catches it at LINT time by escape
analysis:

1. a **dispatch site** is a call that hands buffers to the device
   asynchronously — ``<...backend...>.apply(stream)``, the flat
   engine's launch and scatter (``flat_replay``/``flat_replay_cuda``/
   ``scatter_delta_``/``apply_prefill_delta``) and the blocked lanes
   replayer (``make_replayer_lanes_mixed_blocked``);
2. the dispatched buffer's **alias closure** (``dataflow.
   alias_closure``: reaching definitions chased through the
   pad/stack/concat/asarray family) is tainted;
3. any statement **reachable after the dispatch without passing a
   sync** (``barrier``/``flush_pipeline``/``_sync_entry``/
   ``_sync_shard_inflight``/``_block_token``, ``torch.cuda.synchronize``
   and ``Event.synchronize`` — sync statements kill propagation in the
   CFG walk, loop back edges included) that writes THROUGH a tainted
   name is a finding: subscript stores and aug-assigns on tainted
   roots, ndarray or tensor in-place mutator methods (``fill``,
   ``copy_``, ``index_put_``, ...), ``np.copyto``-family calls, or a
   call handing a tainted buffer to a summarized function that mutates
   that parameter (one interprocedural level, ``dataflow.
   summarize_module``).

Calibrations that keep the clean tree quiet (each one deliberate):
``self``-rooted state is excluded (that discipline is TCR-M's); a
tainted name whose every reaching definition constructs a fresh host
container (dict/list literal) may take subscript stores — that rebinds
a slot, not array storage; unknown callees are assumed alias-pure (the
one-level summary horizon — the runtime sanitizer stays on as
defense-in-depth for exactly what a lint cannot see).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .dataflow import (
    MUTATOR_FNS,
    MUTATOR_METHODS,
    FnSummary,
    FunctionFlow,
    call_leaf,
    expr_roots,
    iter_functions,
    stmt_calls,
)
from .tcrlint import FileContext, Finding

CHECK = "TCR-P001"

#: Tensor in-place methods, beside ``dataflow.MUTATOR_METHODS`` (the
#: ndarray ones, kept equal to the JAX package's engine).
TENSOR_MUTATORS = {"copy_", "index_put_", "index_copy_", "index_fill_",
                   "index_add_", "masked_fill_", "masked_scatter_",
                   "scatter_", "scatter_add_", "fill_", "zero_", "add_",
                   "sub_", "mul_", "put_"}

#: Module-level / attribute-leaf callables that enqueue device work on
#: their tensor arguments.
DISPATCH_FNS = {"flat_replay", "flat_replay_cuda", "scatter_delta_",
                "apply_prefill_delta", "make_replayer_lanes_mixed_blocked"}

#: ``<recv>.apply(stream)`` dispatches when the receiver smells like a
#: lane backend (the serve surface).  Receiver-name heuristic on
#: purpose: ``mirror.apply`` (net/session's synchronous DeviceMirror)
#: and pandas-style ``.apply`` must not taint.
DISPATCH_METHOD = "apply"
DISPATCH_RECEIVERS = ("backend",)

#: Calls that complete in-flight device work: the staged sync family.
SYNC_CALLS = {"barrier", "flush_pipeline", "_sync_entry",
              "_sync_shard_inflight", "_block_token", "synchronize"}


def _is_dispatch(call: ast.Call) -> Optional[List[ast.AST]]:
    """The dispatched-buffer argument expressions when ``call`` is a
    dispatch site, else None."""
    leaf = call_leaf(call)
    if leaf in DISPATCH_FNS:
        args = list(call.args) + [k.value for k in call.keywords]
        return args
    if (leaf == DISPATCH_METHOD
            and isinstance(call.func, ast.Attribute)):
        recv = call.func.value
        recv_name = ""
        if isinstance(recv, ast.Name):
            recv_name = recv.id
        elif isinstance(recv, ast.Attribute):
            recv_name = recv.attr
        if any(h in recv_name.lower() for h in DISPATCH_RECEIVERS):
            return list(call.args)
    return None


def _is_sync_stmt(stmt: ast.stmt) -> bool:
    """Only a statement that ITSELF performs the sync call blocks
    propagation — compound statements contribute their headers alone
    (``_own_exprs``), so an ``if``/``for`` that merely CONTAINS a sync
    in one branch does not mask mutations on its other branches (the
    sync statements inside are their own CFG nodes and block their own
    successors)."""
    return any(call_leaf(c) in SYNC_CALLS for c in _own_calls(stmt))


def _own_exprs(stmt: ast.stmt) -> List[ast.AST]:
    """The expressions a statement evaluates ITSELF — compound
    statements (For/If/While/With/Try) contribute only their headers,
    their bodies are separate CFG statements (walking the whole subtree
    here would double-report every nested mutation at the header)."""
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.While, ast.If)):
        return [stmt.test]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [item.context_expr for item in stmt.items]
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef, ast.Try)):
        return []
    return [stmt]


def _own_calls(stmt: ast.stmt) -> List[ast.Call]:
    out: List[ast.Call] = []
    for expr in _own_exprs(stmt):
        out.extend(stmt_calls(expr))
    return out


def _subscript_base(node: ast.AST) -> Optional[ast.AST]:
    """Innermost non-subscript base of a subscript chain."""
    if not isinstance(node, ast.Subscript):
        return None
    cur = node.value
    while isinstance(cur, ast.Subscript):
        cur = cur.value
    return cur


def _mutations(stmt: ast.stmt, taint: Set[str], containers: Set[str],
               summaries: Dict[str, FnSummary]) -> List[ast.AST]:
    """Nodes in ``stmt`` that write through a tainted buffer."""
    hits: List[ast.AST] = []
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    for t in targets:
        if isinstance(t, ast.Subscript):
            base = _subscript_base(t)
            # a plain-name container slot store rebinds, array-safe;
            # anything deeper (attr/subscript chains) writes storage.
            if (isinstance(base, ast.Name) and base.id in containers
                    and isinstance(t.value, ast.Name)):
                continue
            if base is not None and expr_roots(base) & taint:
                hits.append(t)
        elif isinstance(t, ast.Name) and isinstance(stmt, ast.AugAssign):
            if t.id in taint and t.id not in containers:
                hits.append(t)
    for call in _own_calls(stmt):
        leaf = call_leaf(call)
        if (leaf in MUTATOR_METHODS | TENSOR_MUTATORS
                and isinstance(call.func, ast.Attribute)):
            recv = call.func.value
            roots = expr_roots(recv)
            if roots & taint and not roots <= containers:
                hits.append(call)
                continue
        if leaf in MUTATOR_FNS and call.args:
            if expr_roots(call.args[0]) & taint:
                hits.append(call)
                continue
        summary = summaries.get(leaf)
        if summary is not None and summary.mutated_params:
            for idx, arg in enumerate(call.args):
                if summary.mutates(idx) and expr_roots(arg) & taint:
                    hits.append(call)
                    break
            for kw in call.keywords:
                if (kw.arg in summary.mutated_params
                        and expr_roots(kw.value) & taint):
                    hits.append(call)
                    break
    return hits


def check(ctx: FileContext,
          summaries: Optional[Dict[str, FnSummary]] = None
          ) -> List[Finding]:
    from .dataflow import summarize_module

    # This module's own defs overlay the cross-module summary map: a
    # same-file helper is the nearest (and most precise) resolution of
    # a leaf-name callee.
    merged = dict(summaries or {})
    merged.update(summarize_module(ctx.tree))
    summaries = merged
    out: List[Finding] = []
    for qual, fn in iter_functions(ctx.tree):
        # cheap pre-filter: any dispatch call at all?
        disp_calls = [c for c in stmt_calls(fn)
                      if _is_dispatch(c) is not None]
        if not disp_calls:
            continue
        flow = FunctionFlow(fn)
        sync_idx = {i for i, s in enumerate(flow.stmts)
                    if _is_sync_stmt(s)}
        reported: Set[int] = set()
        for call in disp_calls:
            args = _is_dispatch(call)
            at = flow.stmt_of(call, ctx.parents)
            if at is None or not args:
                continue
            taint, containers = flow.alias_closure(args, at)
            if not taint:
                continue
            # the dispatch statement itself runs before the flight
            # starts; everything CFG-reachable after it (minus sync-
            # killed paths) races the in-flight step.
            reach = flow.reachable_from(at, blocked=sync_idx)
            # Forward alias propagation: a POST-dispatch binding whose
            # RHS may share tainted storage (``col = stacked.pos``) is
            # itself tainted — small fixpoint over the reachable set.
            for _round in range(5):
                grew = False
                for i in sorted(reach):
                    stmt = flow.stmts[i]
                    if not isinstance(stmt, ast.Assign):
                        continue
                    if not expr_roots(stmt.value) & taint:
                        continue
                    for t in stmt.targets:
                        for name in sorted(
                                FunctionFlow._bound_names_of_target(t)):
                            if name not in taint:
                                taint.add(name)
                                grew = True
                if not grew:
                    break
            for i in sorted(reach):
                if i in reported:
                    continue
                hits = _mutations(flow.stmts[i], taint, containers,
                                  summaries)
                if hits:
                    reported.add(i)
                    out.append(ctx.finding(
                        CHECK, hits[0],
                        f"host write into a buffer dispatched at line "
                        f"{getattr(call, 'lineno', '?')} "
                        f"({qual}) may race the in-flight device step "
                        f"— move the write past the staged sync, copy "
                        f"the buffer before dispatch, or justify an "
                        f"allowlist grant (the runtime sanitizer "
                        f"would raise PipelineAliasingError here)"))
    return out
