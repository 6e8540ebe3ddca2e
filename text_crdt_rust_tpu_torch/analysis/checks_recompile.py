"""TCR-R00x: rebuild and reload hazards — the torch analog of the JAX
package's recompile rule.

The port's kernels are hand-written CUDA built by ``nvcc`` into shared
libraries and loaded with ``ctypes``; the native baseline is built by
``g++`` the same way.  A build or a ``CDLL`` load reached from a plain
function runs again on every call: a fresh ``nvcc`` is seconds to
minutes, and a second ``CDLL`` of the same path hands back a new handle
whose argument types were never set.  The sanctioned shapes are:

- a **memoised build function**: one decorated ``@functools.lru_cache``
  / ``@functools.cache``, or one that stores its result in a
  module-level memo — a subscript store into a module-level name
  (``_libs[name] = lib``, ``ops/_kernels.library``) or a ``global``
  name it assigns (``global _lib``, ``models/native._load``);
- an audited build function with a memo of its own that the rule
  cannot see (a library named by the hash of its source, compiled only
  when the file is absent), allowlisted with its justification.

**TCR-R001** flags a ``CDLL``/``LoadLibrary`` call, a
``torch.utils.cpp_extension`` build, and a ``subprocess``/``os.system``
call whose command starts with a compiler (``nvcc``, ``g++``, ``gcc``,
``clang++``, ...: a literal list, a name bound to one in the same
function, or a call such as ``nvcc()``), outside every memoised build
function.  **TCR-R002** flags ``torch.compile``, ``torch.jit.script`` and
``torch.jit.trace`` called inside an uncached function (decorator use
and module level pass: they build once).
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from .tcrlint import FileContext, Finding, dotted_name

CACHING_DECORATORS = {"lru_cache", "cache"}

#: Executables whose invocation is a native build.
COMPILERS = {"nvcc", "g++", "gcc", "c++", "cc", "clang", "clang++"}

#: Calls that run a command line.
RUN_CALLS = {"subprocess.run", "subprocess.Popen", "subprocess.call",
             "subprocess.check_call", "subprocess.check_output",
             "os.system"}

#: Library loads.
LOAD_LEAVES = {"CDLL", "LoadLibrary"}

#: ``torch.utils.cpp_extension`` build calls.
EXT_LEAVES = {"load", "load_inline"}

#: Trace/compile entry points that build a fresh program per call.
JIT_CALLS = {"torch.compile", "torch.jit.script", "torch.jit.trace"}


def _module_names(tree: ast.Module) -> Set[str]:
    """Names bound at module level (the candidates for a memo)."""
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif (isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)):
            out.add(node.target.id)
    return out


def _own_nodes(fn: ast.AST):
    """Nodes of ``fn``'s body, nested defs excluded (their memo is their
    own)."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            todo.extend(ast.iter_child_nodes(node))


def _is_memoised(fn: ast.AST, module_names: Set[str]) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(target) or ""
        if name.split(".")[-1] in CACHING_DECORATORS:
            return True
    globals_: Set[str] = set()
    for node in _own_nodes(fn):
        if isinstance(node, ast.Global):
            globals_.update(node.names)
    for node in _own_nodes(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name) and t.id in globals_:
                    return True
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id in module_names):
                    return True
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "setdefault"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in module_names):
            return True
    return False


def _in_memo(ctx: FileContext, node: ast.AST,
             module_names: Set[str]) -> bool:
    return any(_is_memoised(fn, module_names)
               for fn in ctx.enclosing_functions(node))


def _is_compiler(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        words = node.value.split()
        return bool(words) and words[0].split("/")[-1] in COMPILERS
    if isinstance(node, ast.Call):
        name = dotted_name(node.func) or ""
        return name.split(".")[-1] in COMPILERS
    if isinstance(node, ast.Name):
        return node.id in COMPILERS
    return False


def _command_heads(ctx: FileContext, call: ast.Call) -> List[ast.AST]:
    """First elements of the command lines ``call`` may run."""
    arg: Optional[ast.AST] = call.args[0] if call.args else None
    for kw in call.keywords:
        if kw.arg == "args":
            arg = kw.value
    if arg is None:
        return []
    values = [arg]
    if isinstance(arg, ast.Name):
        fns = ctx.enclosing_functions(call)
        scope = fns[0] if fns else ctx.tree
        values = [n.value for n in ast.walk(scope)
                  if isinstance(n, ast.Assign)
                  and any(isinstance(t, ast.Name) and t.id == arg.id
                          for t in n.targets)]
    heads: List[ast.AST] = []
    for v in values:
        if isinstance(v, (ast.List, ast.Tuple)) and v.elts:
            heads.append(v.elts[0])
        elif isinstance(v, ast.Constant):
            heads.append(v)
    return heads


def _build_kind(ctx: FileContext, node: ast.Call) -> Optional[str]:
    name = dotted_name(node.func) or ""
    leaf = name.split(".")[-1] if name else (
        node.func.attr if isinstance(node.func, ast.Attribute) else "")
    if leaf in LOAD_LEAVES:
        return f"{leaf}() library load"
    if leaf in EXT_LEAVES and "cpp_extension" in name:
        return f"cpp_extension.{leaf}() build"
    if name in RUN_CALLS and any(_is_compiler(h)
                                 for h in _command_heads(ctx, node)):
        return f"{name}() compiler build"
    return None


def _in_decorator(ctx: FileContext, node: ast.AST) -> bool:
    """True when ``node`` sits inside a decorator expression."""
    cur = node
    parent = ctx.parent_of(cur)
    while parent is not None:
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            return cur in parent.decorator_list
        cur, parent = parent, ctx.parent_of(parent)
    return False


def _is_cached(ctx: FileContext, node: ast.AST) -> bool:
    for fn in ctx.enclosing_functions(node):
        for dec in fn.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if (dotted_name(target) or "").split(".")[-1] \
                    in CACHING_DECORATORS:
                return True
    return False


def check(ctx: FileContext) -> List[Finding]:
    module_names = _module_names(ctx.tree)
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        kind = _build_kind(ctx, node)
        if kind is not None:
            if not _in_memo(ctx, node, module_names):
                out.append(ctx.finding(
                    "TCR-R001", node,
                    f"{kind} outside a memoised build function — every load "
                    f"and native build must be reached through an lru-cached "
                    f"function or one that keeps its result in a "
                    f"module-level memo, or it rebuilds/reloads per call"))
            continue
        name = dotted_name(node.func) or ""
        if name in JIT_CALLS:
            if _in_decorator(ctx, node) or not ctx.enclosing_functions(
                    node):
                continue
            if not _is_cached(ctx, node):
                out.append(ctx.finding(
                    "TCR-R002", node,
                    f"{name}(...) inside an uncached function — each "
                    f"call builds a fresh program that re-traces; cache "
                    f"the build by static shape or allowlist the audited "
                    f"one-shot build"))
    return out
