"""The tcrlint dataflow engine: per-function CFGs, reaching
definitions, alias closures, and one-level call summaries (a copy of
``text_crdt_rust_tpu/analysis/dataflow.py``; its results equal the JAX
package's on every file).

The per-statement checks look at one AST node in isolation.  The v2
families (TCR-P pipeline escape,
TCR-M mirror pairing, TCR-K shape contracts) need *flow* facts — "can
this statement execute after that dispatch without passing a sync",
"which buffers may this name alias at that point", "does every path
that writes device state also write its host mirror" — so this module
grows the three classic intraprocedural analyses over the stdlib
``ast``, plus the one interprocedural level the serve/ops call graph
actually needs:

- **CFG** (`FunctionFlow.succ`): statement-level control-flow graph of
  one function body — If/While/For/Try/With lowered to edges,
  break/continue/return/raise resolved, loop back edges included (a
  mutation *before* a dispatch in a loop body still races it via the
  back edge).
- **Reaching definitions** (`FunctionFlow.defs_in`): the classic
  forward may-analysis, per statement: which binding sites may a
  name's value come from HERE.  Feeds constant resolution
  (`FunctionFlow.const_int`: all reaching defs agree on one int
  literal) and the alias closure.
- **Alias closure** (`FunctionFlow.alias_closure`): the set of local
  names whose storage may be shared with a seed expression, computed
  by chasing reaching definitions through alias-propagating forms
  (bare names, attribute/subscript reads, and the project's
  pad/stack/concat/asarray family — ``torch.from_numpy`` and CPU
  tensors share storage with the numpy buffers they came from, so "may
  share storage" is the load-bearing relation the runtime sanitizer
  checks dynamically).  ``self`` is never an
  alias root: backend self-state discipline is TCR-M's contract, and
  folding it in here would drown TCR-P in its own mirrors.
- **Call summaries** (`summarize_module`): per function/method, which
  parameters it may mutate in place, which ``self`` attributes it
  writes, and what it calls — ONE level deep, which is exactly the
  depth the serve tick's helper calls (`_op_fingerprints`,
  `_merge_rank_prefill`, `B.pad_ops`) need; an unknown callee is
  assumed alias-pure (documented per check).

Everything here is pure stdlib-``ast``; nothing imports torch.  The
checks stay deterministic: all iteration orders are list/insertion
order or explicitly sorted.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .tcrlint import dotted_name

#: Calls whose RESULT may share storage with their arguments — the
#: project's padding/stacking family plus numpy's aliasing converters
#: (``np.asarray`` of an ndarray is the same buffer; ``stack_ops``/
#: ``pad_ops`` feed zero-copy device conversion on CPU).
ALIAS_FNS = {
    "stack_ops", "pad_ops", "concat_ops", "tile_ops", "fuse_steps",
    "asarray", "ascontiguousarray", "atleast_1d", "ravel", "squeeze",
}

#: Attribute-call methods that pass their receiver's storage through
#: (``d.get(k, v)`` returns a stored element; view-producing ndarray
#: methods share the base buffer).
ALIAS_METHODS = {"get", "view", "reshape", "transpose", "astype"}

#: ndarray in-place mutator METHODS (container list ops like append/
#: extend/add are deliberately absent: rebinding a container slot to a
#: fresh value does not touch the in-flight array storage).
MUTATOR_METHODS = {"fill", "sort", "put", "partition", "setflags",
                   "resize", "byteswap", "itemset"}

#: Module-level functions that mutate their FIRST argument in place.
MUTATOR_FNS = {"copyto", "put", "place", "putmask", "fill_diagonal"}


def stmt_calls(node: ast.AST) -> List[ast.Call]:
    """Every Call expression inside ``node`` (document order)."""
    return [n for n in ast.walk(node) if isinstance(n, ast.Call)]


def call_leaf(call: ast.Call) -> str:
    """Leaf name of a call: ``b`` for ``a.b(...)`` and ``b(...)``."""
    name = dotted_name(call.func)
    if name:
        return name.split(".")[-1]
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return ""


# -- expression roots ---------------------------------------------------------


def expr_roots(node: ast.AST) -> Set[str]:
    """Local names whose storage the value of ``node`` may share.

    Conservative along alias-producing forms only: a ``BinOp`` always
    allocates (numpy/jnp semantics), so arithmetic results root
    nothing; ``self``/``cls`` are excluded by design (module
    docstring)."""
    out: Set[str] = set()
    _roots_into(node, out)
    out.discard("self")
    out.discard("cls")
    return out


def _roots_into(node: ast.AST, out: Set[str]) -> None:
    if isinstance(node, ast.Name):
        out.add(node.id)
    elif isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        _roots_into(node.value, out)
    elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for elt in node.elts:
            _roots_into(elt, out)
    elif isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
        _roots_into(node.elt, out)
        for gen in node.generators:
            _roots_into(gen.iter, out)
    elif isinstance(node, ast.IfExp):
        _roots_into(node.body, out)
        _roots_into(node.orelse, out)
    elif isinstance(node, ast.NamedExpr):
        _roots_into(node.value, out)
    elif isinstance(node, ast.Call):
        leaf = call_leaf(node)
        if leaf in ALIAS_FNS:
            for arg in list(node.args) + [k.value for k in node.keywords]:
                _roots_into(arg, out)
        elif (leaf in ALIAS_METHODS
              and isinstance(node.func, ast.Attribute)):
            _roots_into(node.func.value, out)
            for arg in node.args:
                _roots_into(arg, out)
        # any other call: assumed to allocate fresh storage


def is_container_ctor(node: ast.AST) -> bool:
    """True when ``node`` constructs a fresh host container (dict/list/
    set literal or comprehension, or the bare constructors) — subscript
    stores into one rebind a SLOT, they do not write array storage."""
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                         ast.ListComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("dict", "list", "set", "defaultdict",
                                "OrderedDict", "deque")
    return False


# -- per-function control/data flow -------------------------------------------


class FunctionFlow:
    """CFG + reaching definitions for one function body.

    Statements are indexed in document order (``stmts``); ``succ[i]``
    is the set of indices that may execute immediately after statement
    i.  ``defs_in[i]`` maps each name to the set of statement indices
    whose binding may reach the ENTRY of statement i."""

    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.stmts: List[ast.stmt] = []
        self.index: Dict[ast.stmt, int] = {}
        self.succ: Dict[int, Set[int]] = {}
        self._collect(fn.body)
        self._build_cfg(fn.body)
        self._reaching()

    # CFG construction --------------------------------------------------------

    def _collect(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self.index[stmt] = len(self.stmts)
            self.stmts.append(stmt)
            self.succ[self.index[stmt]] = set()
            for field in ("body", "orelse", "finalbody"):
                self._collect(getattr(stmt, field, []) or [])
            for handler in getattr(stmt, "handlers", []) or []:
                self._collect(handler.body)

    def _build_cfg(self, body: Sequence[ast.stmt]) -> None:
        # _link returns the exit set of a block: statement indices whose
        # fallthrough continues after the block.  EXIT is the virtual
        # function exit (dropped), loop contexts thread (break, continue)
        # targets.
        self._link(body, after=None, loop=None)

    def _edge(self, src: int, dst: Optional[int]) -> None:
        if dst is not None:
            self.succ[src].add(dst)

    def _first(self, body: Sequence[ast.stmt]) -> Optional[int]:
        return self.index[body[0]] if body else None

    def _link(self, body: Sequence[ast.stmt], after: Optional[int],
              loop: Optional[Tuple[int, Optional[int]]]) -> None:
        """Wire ``body``'s internal edges; each statement's fallthrough
        goes to the next statement, the last one to ``after``.  ``loop``
        is (head index, after-loop index) for break/continue."""
        for pos, stmt in enumerate(body):
            i = self.index[stmt]
            nxt = (self.index[body[pos + 1]] if pos + 1 < len(body)
                   else after)
            if isinstance(stmt, (ast.Return, ast.Raise)):
                continue  # no fallthrough
            if isinstance(stmt, ast.Break):
                if loop is not None:
                    self._edge(i, loop[1])
                continue
            if isinstance(stmt, ast.Continue):
                if loop is not None:
                    self._edge(i, loop[0])
                continue
            if isinstance(stmt, ast.If):
                self._edge(i, self._first(stmt.body) or nxt)
                self._edge(i, self._first(stmt.orelse) or nxt)
                self._link(stmt.body, after=nxt, loop=loop)
                self._link(stmt.orelse, after=nxt, loop=loop)
                continue
            if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
                self._edge(i, self._first(stmt.body) or nxt)
                self._edge(i, self._first(stmt.orelse) or nxt)
                # loop body falls through back to the head (back edge)
                self._link(stmt.body, after=i, loop=(i, nxt))
                self._link(stmt.orelse, after=nxt, loop=loop)
                continue
            if isinstance(stmt, ast.Try):
                self._edge(i, self._first(stmt.body) or nxt)
                # any statement in the try body may transfer to any
                # handler (conservative may-edges)
                for handler in stmt.handlers:
                    h0 = self._first(handler.body)
                    if h0 is not None:
                        self._edge(i, h0)
                        for s in stmt.body:
                            self._edge(self.index[s], h0)
                fin0 = self._first(stmt.finalbody)
                cont = fin0 if fin0 is not None else nxt
                # the try body falls through to the ELSE block first
                # (it only runs when no exception fired), then on to
                # finally/next — without this edge, else-block
                # statements are CFG-orphans and every flow fact
                # (taint reach, reaching defs) goes silent there.
                body_after = self._first(stmt.orelse)
                self._link(stmt.body,
                           after=cont if body_after is None
                           else body_after, loop=loop)
                for handler in stmt.handlers:
                    self._link(handler.body, after=cont, loop=loop)
                self._link(stmt.finalbody, after=nxt, loop=loop)
                self._link(stmt.orelse, after=cont, loop=loop)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._edge(i, self._first(stmt.body) or nxt)
                self._link(stmt.body, after=nxt, loop=loop)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                # nested defs: a straight-line node (the BODY runs at
                # call time, not here); still indexed so inner stmts
                # don't dangle, but unreachable from this flow.
                self._edge(i, nxt)
                continue
            self._edge(i, nxt)

    # reaching definitions ----------------------------------------------------

    @staticmethod
    def _bound_names(stmt: ast.stmt) -> Set[str]:
        """Names (re)bound directly by ``stmt`` (not in nested blocks)."""
        out: Set[str] = set()

        def targets(t: ast.AST) -> None:
            if isinstance(t, ast.Name):
                out.add(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for elt in t.elts:
                    targets(elt)
            elif isinstance(t, ast.Starred):
                targets(t.value)

        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                targets(t)
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets(stmt.target)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            targets(stmt.target)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if item.optional_vars is not None:
                    targets(item.optional_vars)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            out.add(stmt.name)
        elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
            for alias in stmt.names:
                out.add((alias.asname or alias.name).split(".")[0])
        return out

    def _reaching(self) -> None:
        n = len(self.stmts)
        gen: List[Set[str]] = [self._bound_names(s) for s in self.stmts]
        self.defs_in: List[Dict[str, Set[int]]] = [{} for _ in range(n)]
        defs_out: List[Dict[str, Set[int]]] = [{} for _ in range(n)]
        pred: Dict[int, Set[int]] = {i: set() for i in range(n)}
        for i, succs in self.succ.items():
            for j in succs:
                pred[j].add(i)
        work = list(range(n))
        while work:
            i = work.pop(0)
            merged: Dict[str, Set[int]] = {}
            for p in sorted(pred[i]):
                for name, sites in defs_out[p].items():
                    merged.setdefault(name, set()).update(sites)
            self.defs_in[i] = merged
            out: Dict[str, Set[int]] = {
                name: set(sites) for name, sites in merged.items()}
            for name in gen[i]:
                out[name] = {i}
            if out != defs_out[i]:
                defs_out[i] = out
                for j in sorted(self.succ[i]):
                    if j not in work:
                        work.append(j)

    # queries -----------------------------------------------------------------

    def reachable_from(self, start: int,
                       blocked: Optional[Set[int]] = None) -> Set[int]:
        """Statement indices reachable AFTER ``start`` (successors,
        transitively) without traversing THROUGH a ``blocked`` index —
        a blocked statement is itself reachable (its own content runs)
        but kills further propagation (the sync semantics TCR-P
        needs)."""
        blocked = blocked or set()
        seen: Set[int] = set()
        work = sorted(self.succ.get(start, ()))
        while work:
            i = work.pop(0)
            if i in seen:
                continue
            seen.add(i)
            if i in blocked:
                continue
            for j in sorted(self.succ.get(i, ())):
                if j not in seen:
                    work.append(j)
        return seen

    def _def_rhs(self, i: int, name: str) -> Optional[ast.AST]:
        """The RHS expression binding ``name`` at statement ``i`` (None
        for loop targets / with-targets / imports)."""
        stmt = self.stmts[i]
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if name in self._bound_names_of_target(t):
                    return stmt.value
        elif isinstance(stmt, ast.AnnAssign):
            if (isinstance(stmt.target, ast.Name)
                    and stmt.target.id == name):
                return stmt.value
        elif isinstance(stmt, ast.AugAssign):
            if (isinstance(stmt.target, ast.Name)
                    and stmt.target.id == name):
                return stmt.target  # x op= e keeps x's storage
        return None

    @staticmethod
    def _bound_names_of_target(t: ast.AST) -> Set[str]:
        out: Set[str] = set()

        def walk(n: ast.AST) -> None:
            if isinstance(n, ast.Name):
                out.add(n.id)
            elif isinstance(n, (ast.Tuple, ast.List)):
                for elt in n.elts:
                    walk(elt)
            elif isinstance(n, ast.Starred):
                walk(n.value)

        walk(t)
        return out

    def alias_closure(self, seeds: Sequence[ast.AST],
                      at: int) -> Tuple[Set[str], Set[str]]:
        """(tainted names, container names): the fixpoint of chasing
        reaching definitions at statement ``at`` from the ``seeds``
        expressions through alias-producing RHS forms.  ``container``
        marks tainted names ALL of whose reaching defs construct fresh
        host containers (their subscript stores rebind slots, not
        array storage)."""
        taint: Set[str] = set()
        for seed in seeds:
            taint |= expr_roots(seed)
        containers: Set[str] = set()
        defs = self.defs_in[at] if at < len(self.defs_in) else {}
        work = sorted(taint)
        seen_defs: Set[Tuple[str, int]] = set()
        while work:
            name = work.pop(0)
            sites = defs.get(name, set())
            ctor_flags: List[bool] = []
            for site in sorted(sites):
                rhs = self._def_rhs(site, name)
                if rhs is None:
                    ctor_flags.append(False)
                    continue
                ctor_flags.append(is_container_ctor(rhs))
                if (name, site) in seen_defs:
                    continue
                seen_defs.add((name, site))
                for root in sorted(expr_roots(rhs)):
                    if root not in taint:
                        taint.add(root)
                        work.append(root)
            if ctor_flags and all(ctor_flags):
                containers.add(name)
        return taint, containers

    def const_int(self, node: ast.AST, at: int) -> Optional[int]:
        """Resolve ``node`` to an int: a literal, or a name ALL of whose
        reaching definitions at statement ``at`` bind the same int
        literal (one step of constant propagation — the TCR-K
        call-site resolver)."""
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool):
            return node.value
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            inner = self.const_int(node.operand, at)
            return -inner if inner is not None else None
        if not isinstance(node, ast.Name):
            return None
        defs = self.defs_in[at] if at < len(self.defs_in) else {}
        sites = defs.get(node.id)
        if not sites:
            return None
        values: Set[int] = set()
        for site in sorted(sites):
            rhs = self._def_rhs(site, node.id)
            if (isinstance(rhs, ast.Constant)
                    and isinstance(rhs.value, int)
                    and not isinstance(rhs.value, bool)):
                values.add(rhs.value)
            else:
                return None
        return values.pop() if len(values) == 1 else None

    def stmt_of(self, node: ast.AST,
                parents: Dict[ast.AST, ast.AST]) -> Optional[int]:
        """Index of the statement containing ``node`` (via a parent
        map), restricted to this function's statements."""
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, ast.stmt) and cur in self.index:
                return self.index[cur]
            cur = parents.get(cur)
        return None


# -- one-level call summaries -------------------------------------------------


@dataclasses.dataclass
class FnSummary:
    """What one function does to the storage it is handed — the single
    interprocedural level the v2 checks consume."""

    name: str                 # dotted scope ("Cls.method" / "fn")
    params: Tuple[str, ...]
    mutated_params: Tuple[str, ...]   # params written THROUGH in place
    writes_self_attrs: Tuple[str, ...]  # self.<attr> assign/aug/store
    mirror_self_attrs: Tuple[str, ...]  # self.<attr>[...] subscript sets
    calls: Tuple[str, ...]            # leaf names of calls made

    def mutates(self, param_index: int) -> bool:
        return (param_index < len(self.params)
                and self.params[param_index] in self.mutated_params)


def summarize_function(fn: ast.AST, qualname: str) -> FnSummary:
    params = tuple(a.arg for a in fn.args.args
                   if a.arg not in ("self", "cls"))
    mutated: Set[str] = set()
    self_writes: Set[str] = set()
    self_stores: Set[str] = set()
    calls: Set[str] = set()

    def self_attr(node: ast.AST) -> Optional[str]:
        """``attr`` when node reads/writes ``self.attr`` (possibly
        through subscripts)."""
        cur = node
        while isinstance(cur, ast.Subscript):
            cur = cur.value
        if (isinstance(cur, ast.Attribute)
                and isinstance(cur.value, ast.Name)
                and cur.value.id in ("self", "cls")):
            return cur.attr
        return None

    def param_base(node: ast.AST) -> Optional[str]:
        cur = node
        while isinstance(cur, (ast.Subscript, ast.Attribute)):
            cur = cur.value
        if isinstance(cur, ast.Name) and cur.id in params:
            return cur.id
        return None

    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            leaf = call_leaf(node)
            if leaf:
                calls.add(leaf)
            if (leaf in MUTATOR_METHODS
                    and isinstance(node.func, ast.Attribute)):
                p = param_base(node.func.value)
                if p:
                    mutated.add(p)
            if leaf in MUTATOR_FNS and node.args:
                p = param_base(node.args[0])
                if p:
                    mutated.add(p)
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            attr = self_attr(t)
            if attr is not None:
                self_writes.add(attr)
                if isinstance(t, ast.Subscript):
                    self_stores.add(attr)
            if isinstance(t, ast.Subscript) or isinstance(
                    node, ast.AugAssign):
                p = param_base(t)
                if p:
                    mutated.add(p)
    return FnSummary(
        name=qualname, params=params,
        mutated_params=tuple(sorted(mutated)),
        writes_self_attrs=tuple(sorted(self_writes)),
        mirror_self_attrs=tuple(sorted(self_stores)),
        calls=tuple(sorted(calls)))


def summarize_module(tree: ast.Module) -> Dict[str, FnSummary]:
    """Summaries for every function/method in a module, keyed BOTH by
    bare name and by ``Cls.method`` (bare-name collisions keep the
    first in document order — callee resolution is by leaf name, one
    level, best effort)."""
    out: Dict[str, FnSummary] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}" if prefix else child.name
                summary = summarize_function(child, qual)
                out.setdefault(child.name, summary)
                out[qual] = summary
                visit(child, qual + ".")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")

    visit(tree, "")
    return out


def iter_functions(tree: ast.Module):
    """(qualname, FunctionDef) for every def in the module, methods
    included, document order."""
    out: List[Tuple[str, ast.AST]] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}" if prefix else child.name
                out.append((qual, child))
                visit(child, qual + ".")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")

    visit(tree, "")
    return out
