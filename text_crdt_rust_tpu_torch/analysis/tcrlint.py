"""The tcrlint engine of the port: file walking, AST context,
allowlist, runner (counterpart of ``text_crdt_rust_tpu/analysis/
tcrlint.py``, aimed at ``text_crdt_rust_tpu_torch``).

Design points (shared by every check module):

- **Findings name file:line + check id** — the CLI prints
  ``path:line: TCR-X000 message`` and exits 1, so a violation reads
  like a compiler error, not a style nag.
- **The allowlist is scoped, not line-pinned.**  Entries match
  ``(check, path, scope)`` where scope is the dotted enclosing
  class/function chain (``ContinuousBatcher.tick``; ``<module>`` for
  module level, ``*`` for the whole file).  Line numbers churn on every
  edit; scopes only churn when the audited code actually moves — and a
  *stale* entry (matching nothing anymore) is itself a finding
  (TCR-A001), so dead grants cannot accumulate.
- **Deterministic by construction**: files walk sorted, findings sort
  by (path, line, check) — the lint's own output is diffable, which is
  what lets the self-test pin exact findings.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import subprocess
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: Committed allowlist + schema pins live next to the engine (the
#: port's own; the JAX package's files are not read).
ALLOWLIST_PATH = os.path.join(os.path.dirname(__file__),
                              "LINT_ALLOWLIST.json")
PINS_PATH = os.path.join(os.path.dirname(__file__), "SCHEMA_PINS.json")

#: Bump on any change to check logic or finding shapes: invalidates
#: every incremental-cache entry (the cache key hashes this together
#: with the allowlist/pins content and the call-summary digest).
LINT_VERSION = 1

#: Directories never walked (build junk; native/ holds generated .so
#: trees; spool dirs can appear under a dev checkout).
SKIP_DIRS = {"__pycache__", ".git", "build", ".pytest_cache", "node_modules"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding; sorts by (path, line, check) for stable output."""

    check: str       # "TCR-W001"
    path: str        # root-relative, forward slashes
    line: int
    scope: str       # dotted enclosing defs, "<module>" at top level
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.check} {self.message}"

    def sort_key(self) -> Tuple[str, int, str]:
        return (self.path, self.line, self.check)


class FileContext:
    """Parsed module + the scope/parent maps the checks share."""

    def __init__(self, rel: str, source: str, tree: ast.Module):
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.scopes: Dict[ast.AST, str] = {}
        self._annotate()

    def _annotate(self) -> None:
        def walk(node: ast.AST, scope: List[str]) -> None:
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
                self.scopes[child] = ".".join(scope) or "<module>"
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    walk(child, scope + [child.name])
                else:
                    walk(child, scope)

        walk(self.tree, [])

    def scope_of(self, node: ast.AST) -> str:
        return self.scopes.get(node, "<module>")

    def parent_of(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)

    def enclosing_functions(self, node: ast.AST) -> List[ast.FunctionDef]:
        """Innermost-first chain of enclosing function defs."""
        out: List[ast.FunctionDef] = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(cur)
            cur = self.parents.get(cur)
        return out

    def finding(self, check: str, node: ast.AST, message: str) -> Finding:
        return Finding(check=check, path=self.rel,
                       line=getattr(node, "lineno", 1),
                       scope=self.scope_of(node), message=message)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# -- file walking -------------------------------------------------------------


def iter_py_files(root: str, paths: Optional[Sequence[str]] = None
                  ) -> Iterable[str]:
    """Root-relative .py paths under ``paths`` (files or directories),
    sorted — the lint practices the determinism it preaches.  An empty
    ``paths`` list means NO per-file targets (the ``--changed`` mode
    with a clean diff: project-level passes still run)."""
    if paths is not None and len(paths) == 0:
        return []
    targets = ([os.path.join(root, p) for p in paths]
               if paths is not None else [root])
    out: List[str] = []
    for target in targets:
        if os.path.isfile(target):
            out.append(os.path.relpath(target, root))
            continue
        for dirpath, dirnames, filenames in os.walk(target):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in SKIP_DIRS
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.relpath(
                        os.path.join(dirpath, fn), root))
    return sorted(dict.fromkeys(p.replace(os.sep, "/") for p in out))


# -- allowlist ----------------------------------------------------------------


def load_allowlist(path: str = ALLOWLIST_PATH) -> List[dict]:
    """Entries ``{"check", "path", "scope", "why"}``; ``scope`` ``"*"``
    grants the whole file.  Every field is required — an unjustified
    grant is refused at load time."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        data = json.load(f)
    entries = data["allow"] if isinstance(data, dict) else data
    for e in entries:
        missing = [k for k in ("check", "path", "scope", "why")
                   if not e.get(k)]
        if missing:
            raise ValueError(
                f"allowlist entry {e!r} missing {missing} — every grant "
                f"needs a check id, a path, a scope and a justification")
    return entries


def _entry_matches(entry: dict, finding: Finding) -> bool:
    if entry["check"] != finding.check or entry["path"] != finding.path:
        return False
    if entry["scope"] == "*":
        return True
    # Exact scope, or a grant on an enclosing scope ("Cls" covers
    # "Cls.method"): audits grant functions or whole classes, and a
    # nested helper inside an audited function is the same audit.
    return (finding.scope == entry["scope"]
            or finding.scope.startswith(entry["scope"] + "."))


def apply_allowlist(findings: List[Finding], entries: List[dict],
                    allowlist_rel: str,
                    check_stale: bool = True) -> List[Finding]:
    """Filter allowlisted findings; a stale entry (granting nothing this
    run) becomes a TCR-A001 finding on the allowlist file itself.
    ``check_stale=False`` for partial-tree lints, where an unused grant
    just means its file wasn't walked."""
    used = [False] * len(entries)
    kept: List[Finding] = []
    for f in findings:
        granted = False
        for i, e in enumerate(entries):
            if _entry_matches(e, f):
                used[i] = True
                granted = True
        if not granted:
            kept.append(f)
    for i, e in enumerate(entries):
        if check_stale and not used[i]:
            kept.append(Finding(
                check="TCR-A001", path=allowlist_rel, line=1,
                scope="<allowlist>",
                message=(f"stale allowlist entry: {e['check']} "
                         f"{e['path']}::{e['scope']} matched no finding "
                         f"— delete it or re-justify")))
    return kept


# -- changed-file selection (incremental mode) --------------------------------


def changed_files(root: str, base: Optional[str] = None
                  ) -> Optional[List[str]]:
    """Root-relative .py files changed vs ``base`` (default: the
    merge-base with main/master, falling back to HEAD — i.e. just the
    working tree), union the untracked files.  None when git is
    unavailable or ``root`` is not a work tree (callers fall back to
    the full walk and say so); a CALLER-SUPPLIED base that git refuses
    raises ``ValueError`` instead — a typo'd ref must be a usage
    error, not a silent full walk blamed on git."""
    def git(*args: str) -> Optional[str]:
        try:
            r = subprocess.run(["git", "-C", root, *args],
                               capture_output=True, text=True,
                               timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        return r.stdout if r.returncode == 0 else None

    if git("rev-parse", "--git-dir") is None:
        return None
    explicit = base is not None
    if base is None:
        for cand in ("main", "master"):
            mb = git("merge-base", "HEAD", cand)
            if mb:
                base = mb.strip()
                break
        base = base or "HEAD"
    diff = git("diff", "--name-only", base)
    if diff is None:
        if explicit:
            raise ValueError(
                f"--changed base {base!r} is not a ref git can diff "
                f"against (typo, or an unfetched remote ref?)")
        return None
    untracked = git("ls-files", "--others", "--exclude-standard") or ""
    out = sorted({p for p in diff.splitlines() + untracked.splitlines()
                  if p.endswith(".py")
                  and os.path.exists(os.path.join(root, p))})
    return out


# -- incremental cache --------------------------------------------------------
# Content-hash keyed per-file findings under <root>/.tcrlint_torch_cache/
# (a directory of its own: the JAX package's engine keeps its cache under
# .tcrlint_cache/ with another digest, and one file would flip between
# them) so
# the tier-1 gate's cost tracks the DIFF, not the tree: a file whose
# content hash matches reuses its raw findings; the config digest
# (engine version + allowlist + pins + call-summary sources) guards
# cross-file invalidation — a summary-source edit re-lints everything,
# which is exactly the interprocedural soundness boundary.

CACHE_DIR_NAME = ".tcrlint_torch_cache"

#: Modules whose one-level call summaries feed the interprocedural
#: checks (TCR-P callee mutation, TCR-M producer harvest).  Their
#: content is part of the cache config digest.
SUMMARY_SOURCES = (
    "text_crdt_rust_tpu_torch/ops/batch.py",
    "text_crdt_rust_tpu_torch/ops/flat.py",
    "text_crdt_rust_tpu_torch/serve/batcher.py",
    "text_crdt_rust_tpu_torch/serve/lanes_backend.py",
    "text_crdt_rust_tpu_torch/serve/residency.py",
)


def _file_sha(path: str) -> str:
    h = hashlib.sha256()
    try:
        with open(path, "rb") as f:
            h.update(f.read())
    except OSError:
        h.update(b"<absent>")
    return h.hexdigest()


def _config_digest(root: str, allowlist_path: str, pins_path: str,
                   shape_pins_path: str) -> str:
    h = hashlib.sha256(f"tcrlint-torch-v{LINT_VERSION}".encode())
    for path in (allowlist_path, pins_path, shape_pins_path):
        h.update(_file_sha(path).encode())
    for rel in SUMMARY_SOURCES:
        h.update(_file_sha(os.path.join(root, rel)).encode())
    # The engine's OWN source: an edited check module must invalidate
    # every cached verdict its old logic produced — "a stale hit is
    # structurally impossible" has to hold without anyone remembering
    # to bump LINT_VERSION by hand (the version stays as the knob for
    # semantic changes that live outside this package, e.g. pin-file
    # format migrations).
    engine_dir = os.path.dirname(os.path.abspath(__file__))
    for fn in sorted(os.listdir(engine_dir)):
        if fn.endswith(".py"):
            h.update(_file_sha(os.path.join(engine_dir, fn)).encode())
    return h.hexdigest()


class _Cache:
    def __init__(self, root: str, digest: str,
                 cache_dir: Optional[str] = None):
        self.path = os.path.join(cache_dir or os.path.join(
            root, CACHE_DIR_NAME), "cache.json")
        self.digest = digest
        self.hits = 0
        self.misses = 0
        self.entries: Dict[str, dict] = {}
        try:
            with open(self.path) as f:
                data = json.load(f)
            if data.get("digest") == digest:
                self.entries = data.get("files", {})
        except (OSError, ValueError):
            pass

    def get(self, rel: str, sha: str) -> Optional[List[Finding]]:
        entry = self.entries.get(rel)
        if entry is None or entry["sha"] != sha:
            self.misses += 1
            return None
        self.hits += 1
        return [Finding(**f) for f in entry["findings"]]

    def put(self, rel: str, sha: str, findings: List[Finding]) -> None:
        self.entries[rel] = {
            "sha": sha,
            "findings": [dataclasses.asdict(f) for f in findings]}

    def save(self) -> None:
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            with open(self.path, "w") as f:
                json.dump({"digest": self.digest, "files": self.entries},
                          f, sort_keys=True)
        except OSError:
            pass  # a read-only tree still lints, just uncached


# -- runner -------------------------------------------------------------------


def _check_modules():
    from . import (checks_determinism, checks_exceptions, checks_pyflakes,
                   checks_recompile, checks_schema, checks_wallclock)

    return (checks_wallclock, checks_determinism, checks_schema,
            checks_recompile, checks_exceptions, checks_pyflakes)


def _summary_map(root: str) -> Dict[str, "object"]:
    """One-level call summaries over the summary-source modules present
    under ``root`` (leaf-name keyed; first definition wins per the
    dataflow module's contract)."""
    from .dataflow import summarize_module

    out: Dict[str, object] = {}
    for rel in SUMMARY_SOURCES:
        full = os.path.join(root, rel)
        if not os.path.exists(full):
            continue
        try:
            with open(full, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=rel)
        except (SyntaxError, UnicodeDecodeError):
            continue
        for name, summary in sorted(summarize_module(tree).items()):
            out.setdefault(name, summary)
    return out


def run_lint(root: str, paths: Optional[Sequence[str]] = None, *,
             allowlist_path: str = ALLOWLIST_PATH,
             pins_path: str = PINS_PATH,
             shape_pins_path: Optional[str] = None,
             update_pins: bool = False,
             check_stale_allowlist: Optional[bool] = None,
             use_cache: bool = False,
             cache_dir: Optional[str] = None
             ) -> Tuple[List[Finding], dict]:
    """Lint ``paths`` (default: the whole root; an explicit empty list
    lints no files but still runs the project-level passes) and return
    ``(findings, stats)``.  Findings are sorted and allowlist-filtered;
    ``stats`` counts files/raw findings per check for the CLI summary.
    ``use_cache`` enables the content-hash incremental cache under
    ``<root>/.tcrlint_torch_cache/`` (or ``cache_dir``).
    """
    from . import checks_claims, checks_mirror, checks_pipeline, \
        checks_schema, checks_shape

    if shape_pins_path is None:
        shape_pins_path = checks_shape.SHAPE_PINS_PATH
    modules = _check_modules()
    raw: List[Finding] = []
    files = list(iter_py_files(root, paths))
    skipped: List[str] = []
    cache = None
    if use_cache:
        cache = _Cache(root, _config_digest(
            root, allowlist_path, pins_path, shape_pins_path),
            cache_dir=cache_dir)
    summaries = _summary_map(root)
    producers = checks_mirror.harvest_producers(root) \
        | checks_mirror.DEFAULT_PRODUCERS
    shape_series = checks_shape.load_series(shape_pins_path)
    for rel in files:
        full = os.path.join(root, rel)
        if cache is not None:
            sha = _file_sha(full)
            hit = cache.get(rel, sha)
            if hit is not None:
                raw.extend(hit)
                continue
        try:
            with open(full, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=rel)
        except (SyntaxError, UnicodeDecodeError) as e:
            raw.append(Finding(check="TCR-E001", path=rel,
                               line=getattr(e, "lineno", 1) or 1,
                               scope="<module>",
                               message=f"unparseable: {e}"))
            skipped.append(rel)
            continue
        ctx = FileContext(rel, source, tree)
        file_raw: List[Finding] = []
        for mod in modules:
            file_raw.extend(mod.check(ctx))
        file_raw.extend(checks_pipeline.check(ctx, summaries=summaries))
        file_raw.extend(checks_mirror.check(ctx, producers=producers))
        file_raw.extend(checks_shape.check(ctx, series=shape_series))
        if cache is not None:
            cache.put(rel, sha, file_raw)
        raw.extend(file_raw)
    if cache is not None:
        cache.save()
    # Project-level passes: schema fingerprints + shape contracts vs
    # their committed pins, and the docs claims cross-check.
    raw.extend(checks_schema.check_pins(root, pins_path,
                                        update=update_pins))
    raw.extend(checks_shape.check_shape_pins(root, shape_pins_path,
                                             update=update_pins))
    raw.extend(checks_claims.check_claims(root))

    entries = load_allowlist(allowlist_path)
    allowlist_rel = os.path.relpath(allowlist_path, root).replace(
        os.sep, "/")
    if check_stale_allowlist is None:
        # Default: stale-grant findings only on full-tree lints — a
        # partial lint never walked most granted files.
        check_stale_allowlist = paths is None
    findings = apply_allowlist(sorted(raw, key=Finding.sort_key),
                               entries, allowlist_rel,
                               check_stale=check_stale_allowlist)
    findings.sort(key=Finding.sort_key)
    per_check: Dict[str, int] = {}
    for f in findings:
        per_check[f.check] = per_check.get(f.check, 0) + 1
    stats = {"files": len(files), "skipped": skipped,
             "raw_findings": len(raw), "findings": len(findings),
             "allow_entries": len(entries), "per_check": per_check,
             "cache": ({"hits": cache.hits, "misses": cache.misses}
                       if cache is not None else None)}
    return findings, stats
