"""TCR-M00x: device-state / host-mirror pairing (the port's counterpart
of the JAX package's family, over in-place tensor writes).

The serve capacity contract reads HOST MIRRORS: the flat backend's
``_n_host``/``_next_order_host`` (and the lanes backend's
``_lane_rows``/``_rkl``/``_resident_fresh``) must track the device
state exactly, because every pre-dispatch probe reads the mirror and
never the device.  The failure mode is structural: someone lands a new
device-state write site (a lane column ``copy_``, a new
``scatter_delta_`` call, a residency path) and forgets the paired
mirror update — nothing crashes, the mirrors drift, and the capacity
check silently reasons about a state that no longer exists.  This check
makes the pairing a LINT contract:

- **TCR-M001** — in a registered backend class (``MIRROR_CONTRACTS``,
  keyed by class name so injected copies of the real files stay
  checkable), every method that performs a device-state write must
  also write at least one of the class's mirror attributes — directly,
  or via a one-level call to another method of the same class that
  writes one — or carry a scoped ``LINT_ALLOWLIST.json`` grant.

  A *device-state write* is: an assignment to a registered device
  attribute (``self.docs = ...``); an in-place tensor write through one
  — a subscript store or an in-place method (``copy_``, ``index_put_``,
  ``fill_``, ...) on ``self.<device attr>`` or on a local name bound
  from it (``d = self.docs``, ``for s in self._state``); a call to one
  of the flat engine's device-writing producers — harvested from
  ``ops/flat.py``'s AST when it is in the linted tree (functions that
  write tensors in place or launch the flat kernel, closed over the
  module's own call graph), with a pinned fallback list for partial
  trees; or a call to a same-class method that writes device state
  without pairing a mirror itself (a lane-write helper: its callers
  own the pairing).

- **TCR-M002** — a class in ``serve/`` that writes tensors in place on
  ``self`` state but is NOT registered in ``MIRROR_CONTRACTS``: a new
  lane backend landed without declaring its mirror contract.

- **TCR-M003** — tick trains defer T device writes behind a buffered
  train, and the mirrors true up by the buffered column sums at the
  TRAIN boundary.  That true-up site is registered per class
  (``train_sync``), and the contract is ATOMICITY: the registered
  method must perform the device write AND a mirror write directly in
  its own body — no one-level helper delegation, which M001 would
  accept.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set

from .dataflow import call_leaf, iter_functions, stmt_calls
from .tcrlint import FileContext, Finding, dotted_name

#: The registered backend mirror contracts, by CLASS name (path-free so
#: the injection corpus can lint mutated copies of the real files).
MIRROR_CONTRACTS = {
    "FlatLaneBackend": {
        "device": ("docs",),
        "mirror": ("_n_host", "_next_order_host"),
        # TCR-M003: the train-boundary mirror true-up must live in the
        # same method as the train's device write (see module header).
        "train_sync": ("_dispatch_train",),
    },
    "LanesMixedLaneBackend": {
        "device": ("_state",),
        "mirror": ("_lane_rows", "_rkl", "_resident_fresh"),
    },
}

#: In-place tensor methods: a call on a device tensor (or a view of
#: one) writes device state.
INPLACE_METHODS = frozenset({
    "copy_", "index_put_", "index_copy_", "index_fill_", "index_add_",
    "masked_fill_", "masked_scatter_", "scatter_", "scatter_add_",
    "fill_", "zero_", "add_", "sub_", "mul_", "put_",
})

#: Fallback device-write producer names for partial trees where
#: ``ops/flat.py`` is absent (the harvest supersedes this when it can
#: run — see ``harvest_producers``).
DEFAULT_PRODUCERS = frozenset({
    "scatter_delta_", "apply_prefill_delta", "flat_replay",
    "flat_replay_cuda", "flat_replay_plain", "apply_ops",
    "apply_ops_batch", "apply_train", "step",
})

PRODUCER_SOURCE = "text_crdt_rust_tpu_torch/ops/flat.py"

#: Directory prefix where M002 (unregistered device-state class)
#: applies — new lane backends land here.
M002_PREFIX = "text_crdt_rust_tpu_torch/serve/"


def _base(node: ast.AST) -> Optional[ast.AST]:
    """The object an in-place write lands on: through subscripts,
    attribute reads, method-call results (``x.view(-1)``) and
    ``getattr(x, f)`` down to the first name or ``self`` attribute."""
    cur = node
    while True:
        if isinstance(cur, ast.Subscript):
            cur = cur.value
        elif isinstance(cur, ast.Call):
            if (isinstance(cur.func, ast.Name) and cur.func.id == "getattr"
                    and cur.args):
                cur = cur.args[0]
            elif isinstance(cur.func, ast.Attribute):
                cur = cur.func.value
            else:
                return None
        elif isinstance(cur, ast.Attribute):
            if (isinstance(cur.value, ast.Name)
                    and cur.value.id in ("self", "cls")):
                return cur
            cur = cur.value
        elif isinstance(cur, ast.Name):
            return cur
        else:
            return None


def _self_attrs_in(node: ast.AST) -> Set[str]:
    return {n.attr for n in ast.walk(node)
            if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name)
            and n.value.id in ("self", "cls")}


def _bound_names(target: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}


def _aliases(fn: ast.AST, device: Optional[Set[str]]) -> Set[str]:
    """Local names bound from a device attribute (``device=None``: from
    any ``self`` attribute) by an assignment or a ``for`` loop."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            targets, value = [node.target], node.iter
        else:
            continue
        attrs = _self_attrs_in(value)
        if attrs and (device is None or attrs & device):
            for t in targets:
                out |= _bound_names(t)
    return out


def _writes_through(target: ast.AST, device: Optional[Set[str]],
                    aliases: Set[str]) -> bool:
    base = _base(target)
    if isinstance(base, ast.Attribute):
        return device is None or base.attr in device
    return isinstance(base, ast.Name) and base.id in aliases


def _inplace_writes(fn: ast.AST, device: Optional[Set[str]]
                    ) -> List[ast.AST]:
    """In-place tensor writes through ``device`` attributes (or any
    ``self`` attribute when None) in one method: subscript stores and
    in-place method calls, on the attribute or a local alias of it.
    With ``device=None`` only method calls count (subscript stores into
    host arrays on ``self`` are everyday bookkeeping)."""
    aliases = _aliases(fn, device)
    hits: List[ast.AST] = []
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in INPLACE_METHODS
                and _writes_through(node.func.value, device, aliases)):
            hits.append(node)
        elif device is not None and isinstance(
                node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Subscript)
                        and _writes_through(t, device, aliases)):
                    hits.append(t)
    return hits


def harvest_producers(root: str) -> frozenset:
    """Device-writing callables of the flat engine, from its AST: defs
    whose body writes a tensor in place (an in-place method, a subscript
    store into a view or into an argument) or binds a
    kernel launch (``_kernels.function``), closed over the module's own
    call graph.  Falls back to the pinned list when the source file is
    not under ``root`` (temp trees)."""
    path = os.path.join(root, PRODUCER_SOURCE)
    if not os.path.exists(path):
        return DEFAULT_PRODUCERS
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=PRODUCER_SOURCE)
    direct: Set[str] = set()
    calls: Dict[str, Set[str]] = {}
    for qual, fn in iter_functions(tree):
        calls[fn.name] = {call_leaf(c) for c in stmt_calls(fn)}
        if _writes_device(fn):
            direct.add(fn.name)
    out = set(direct)
    grew = True
    while grew:
        grew = False
        for name, leafs in sorted(calls.items()):
            if name not in out and leafs & out:
                out.add(name)
                grew = True
    return frozenset(out)


def _writes_device(fn: ast.AST) -> bool:
    for call in stmt_calls(fn):
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in INPLACE_METHODS):
            return True
        if (dotted_name(call.func) or "").endswith("_kernels.function"):
            return True
    params = {a.arg for a in ast.walk(fn.args) if isinstance(a, ast.arg)}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                # A store into a view or an element of something
                # (``x.view(-1)[i] =``, ``st["n"][b] =``) or into a
                # tensor the function was handed; a slot store into a
                # local container (``out[k] = ...``) is bookkeeping.
                if isinstance(t, ast.Subscript) and isinstance(
                        _base(t), ast.Name) and (
                        not isinstance(t.value, ast.Name)
                        or t.value.id in params):
                    return True
    return False


def _self_attr_target(t: ast.AST) -> Optional[str]:
    """``attr`` when ``t`` is ``self.attr`` or ``self.attr[...]``."""
    cur = t
    while isinstance(cur, ast.Subscript):
        cur = cur.value
    if (isinstance(cur, ast.Attribute)
            and isinstance(cur.value, ast.Name)
            and cur.value.id in ("self", "cls")):
        return cur.attr
    return None


def _method_mirror_writes(fn: ast.AST, mirrors: Set[str]) -> bool:
    for node in ast.walk(fn):
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            attr = _self_attr_target(t)
            if attr in mirrors:
                return True
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and _self_attr_target(node.func.value) in mirrors
                and node.func.attr in INPLACE_METHODS | {"fill"}):
            return True
    return False


def _method_device_writes(fn: ast.AST, device: Set[str]) -> List[ast.AST]:
    """Nodes performing a device-state write in one method: device-attr
    assignments and in-place writes through a device attribute (producer
    calls are a separate detection in ``check``)."""
    hits: List[ast.AST] = []
    for node in ast.walk(fn):
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for t in targets:
            if _self_attr_target(t) in device:
                hits.append(t)
    return hits + _inplace_writes(fn, device)


def _self_method_calls(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for call in stmt_calls(fn):
        if (isinstance(call.func, ast.Attribute)
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id in ("self", "cls")):
            out.add(call.func.attr)
    return out


def _self_calls_to(fn: ast.AST, names: Set[str]) -> List[ast.AST]:
    return [c for c in stmt_calls(fn)
            if isinstance(c.func, ast.Attribute)
            and isinstance(c.func.value, ast.Name)
            and c.func.value.id in ("self", "cls")
            and c.func.attr in names]


def check(ctx: FileContext,
          producers: Optional[frozenset] = None) -> List[Finding]:
    if producers is None:
        producers = DEFAULT_PRODUCERS
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        contract = MIRROR_CONTRACTS.get(node.name)
        methods = {m.name: m for m in node.body
                   if isinstance(m, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        if contract is None:
            # TCR-M002: unregistered serve-side device-state class.
            if not ctx.rel.startswith(M002_PREFIX):
                continue
            for m in methods.values():
                writes = _inplace_writes(m, None)
                if writes:
                    out.append(ctx.finding(
                        "TCR-M002", writes[0],
                        f"class {node.name} writes tensors in place on "
                        f"its own state but is not registered in "
                        f"checks_mirror.MIRROR_CONTRACTS — declare its "
                        f"device/mirror attribute contract so TCR-M001 "
                        f"can watch new write sites"))
                    break
            continue
        device = set(contract["device"])
        mirrors = set(contract["mirror"])
        mirror_methods = {name for name, m in sorted(methods.items())
                          if _method_mirror_writes(m, mirrors)}
        direct = {}
        for name, m in sorted(methods.items()):
            writes = _method_device_writes(m, device) + [
                c for c in stmt_calls(m) if call_leaf(c) in producers]
            if writes:
                direct[name] = sorted(
                    writes, key=lambda n: getattr(n, "lineno", 0))
        # A same-class method that writes device state and pairs no
        # mirror itself hands the pairing to its callers (one level).
        unpaired = {name for name in direct if name not in mirror_methods}
        # Registered train-boundary sync sites are their own contract
        # (TCR-M003) and do NOT excuse other methods via the one-level
        # pairing rule.
        pairing = mirror_methods - set(contract.get("train_sync", ()))
        for name in contract.get("train_sync", ()):
            m = methods.get(name)
            if m is None:
                continue
            writes = direct.get(name, [])
            if writes and name in mirror_methods:
                continue
            out.append(ctx.finding(
                "TCR-M003", writes[0] if writes else m,
                f"{node.name}.{name} is the registered train-boundary "
                f"sync site but does not perform the device write and "
                f"the mirror true-up ({', '.join(sorted(mirrors))}) in "
                f"its own body — the train contract is atomic: T "
                f"ticks' occupancy moves in one method, no helper "
                f"delegation (a split true-up drifts T ticks at a "
                f"time)"))
        for name, m in sorted(methods.items()):
            writes = list(direct.get(name, []))
            if not writes:
                writes = _self_calls_to(m, unpaired - {name})
            if not writes:
                continue
            if name in mirror_methods:
                continue
            if _self_method_calls(m) & pairing:
                continue  # one-level pairing via a same-class helper
            writes.sort(key=lambda n: getattr(n, "lineno", 0))
            out.append(ctx.finding(
                "TCR-M001", writes[0],
                f"{node.name}.{name} writes device state but never "
                f"updates a host mirror ({', '.join(sorted(mirrors))})"
                f" — the capacity contract reads mirrors, not the "
                f"device; pair the write or add a justified allowlist "
                f"grant for this scope"))
    return out
