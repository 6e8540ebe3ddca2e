"""tcrlint CLI of the port — ``python -m
text_crdt_rust_tpu_torch.analysis.lint`` (lints ``text_crdt_rust_tpu_torch``
by default, with the port's own allowlist and pins).

One entry point for ALL of the port's static gates (the tier-1 lint
test runs exactly this module):

1. **tcrlint** — the project-invariant families (wall-clock
   segregation, determinism hazards, schema drift, recompile hazards,
   F401 fallback) plus the v2 dataflow families (pipeline escape,
   mirror pairing, shape contracts, claims consistency) over the
   package;
2. **ruff** — the third-party baseline (``pyproject.toml
   [tool.ruff]``, pyflakes+isort-level rules) when the binary is
   installed; its absence downgrades to the built-in TCR-F401
   fallback, reported in the summary so the gate's coverage is never
   silently ambiguous.

Exit codes: 0 clean, 1 findings (each printed as
``path:line: CHECK-ID message``), 2 usage/config error.

``--update-pins`` rewrites ``SCHEMA_PINS.json`` AND
``SHAPE_CONTRACTS.json`` from the live surfaces (commit them together
with the change that motivated the re-pin).

**Incremental mode**: ``--changed [BASE]`` lints only the
.py files git reports changed vs BASE (default: the merge-base with
main/master, else the working tree) — the project-level passes (schema
pins, shape contracts, docs claims) always run, they are cheap.  The
content-hash cache under ``.tcrlint_torch_cache/`` makes even full-tree
re-runs diff-priced; ``--no-cache`` disables it (the cache key folds
in the engine version, allowlist, pins and the interprocedural
summary sources, so a stale hit is structurally impossible).  The
full-tree walk (no ``--changed``) is the weekly-style fallback and
the authoritative clean-tree proof.

The port's package reads no wall clock, this CLI included: the summary
names files, findings and cache hits, not the lint's own wall time.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from typing import List, Optional

from .checks_shape import SHAPE_PINS_PATH
from .tcrlint import ALLOWLIST_PATH, PINS_PATH, changed_files, run_lint

#: Default lint target, relative to the repo root.
DEFAULT_TARGET = "text_crdt_rust_tpu_torch"


def repo_root() -> str:
    """The repo root = the parent of the installed package directory
    (bench.py and pyproject.toml live there)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def run_ruff(root: str, paths: List[str]) -> Optional[dict]:
    """Run ruff over ``paths`` when installed; None when unavailable
    (the caller reports the downgrade).  Findings come back in the
    same path:line shape tcrlint uses."""
    exe = shutil.which("ruff")
    argv = None
    if exe:
        argv = [exe, "check", "--output-format", "concise", *paths]
    else:
        try:  # pip-installed module without a PATH shim
            import ruff  # noqa: F401

            argv = [sys.executable, "-m", "ruff", "check",
                    "--output-format", "concise", *paths]
        except ImportError:
            return None
    r = subprocess.run(argv, capture_output=True, text=True, cwd=root,
                       timeout=300)
    lines = [ln for ln in r.stdout.splitlines()
             if ln.strip() and not ln.startswith(("Found ", "warning:"))]
    return {"rc": r.returncode, "lines": lines,
            "stderr": r.stderr.strip()}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m text_crdt_rust_tpu_torch.analysis.lint",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint, relative to --root "
                         f"(default: {DEFAULT_TARGET})")
    ap.add_argument("--root", default=None,
                    help="repo root (default: derived from the package "
                         "location)")
    ap.add_argument("--allowlist", default=None,
                    help="allowlist JSON (default: the committed "
                         "text_crdt_rust_tpu_torch/analysis/"
                         "LINT_ALLOWLIST.json)")
    ap.add_argument("--pins", default=None,
                    help="schema pins JSON (default: the committed "
                         "text_crdt_rust_tpu_torch/analysis/"
                         "SCHEMA_PINS.json)")
    ap.add_argument("--update-pins", action="store_true",
                    help="rewrite the schema pins AND shape contracts "
                         "from the live surfaces instead of checking "
                         "them")
    ap.add_argument("--shape-pins", default=None,
                    help="shape contracts JSON (default: the committed "
                         "text_crdt_rust_tpu_torch/analysis/"
                         "SHAPE_CONTRACTS.json)")
    ap.add_argument("--changed", nargs="?", const="auto", default=None,
                    metavar="BASE",
                    help="incremental mode: lint only .py files git "
                         "reports changed vs BASE (default: merge-base "
                         "with main/master); project-level passes "
                         "always run")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the .tcrlint_torch_cache content-hash "
                         "cache")
    ap.add_argument("--cache-dir", default=None,
                    help="cache directory (default: "
                         "<root>/.tcrlint_torch_cache)")
    ap.add_argument("--no-ruff", action="store_true",
                    help="skip the third-party ruff baseline")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    a = ap.parse_args(argv)

    root = os.path.abspath(a.root) if a.root else repo_root()
    if not os.path.isdir(root):
        print(f"lint root {root!r} is not a directory", file=sys.stderr)
        return 2
    paths = a.paths or [DEFAULT_TARGET]
    for p in paths:
        if not os.path.exists(os.path.join(root, p)):
            print(f"lint target {p!r} not found under {root}",
                  file=sys.stderr)
            return 2
    mode = "full"
    full_walk = True
    if a.changed is not None:
        from .tcrlint import SUMMARY_SOURCES

        base = None if a.changed == "auto" else a.changed
        try:
            changed = changed_files(root, base)
        except ValueError as e:  # typo'd/unfetched explicit base
            print(f"tcrlint usage error: {e}", file=sys.stderr)
            return 2
        if changed is None:
            # No git (tarball checkout): the weekly-style fallback is
            # the full walk, and the summary says so.
            mode = "full (--changed fell back: no git work tree)"
        elif set(changed) & set(SUMMARY_SOURCES):
            # A summary-source edit can induce cross-file TCR-P/TCR-M
            # findings in UNCHANGED dependents (a new device-write
            # producer in ops/flat.py makes an old call site in the
            # batcher a finding) — the interprocedural soundness
            # boundary demands the full walk, and the cache (whose
            # digest just rotated on the same edit) keeps it cheap.
            mode = ("full (--changed touched an interprocedural "
                    "summary source)")
        else:
            prefixes = tuple(paths)
            paths = [p for p in changed
                     if p.startswith(prefixes) or p in prefixes]
            mode = f"changed ({len(paths)} file(s) vs merge-base)"
            full_walk = False

    try:
        findings, stats = run_lint(
            root, paths,
            allowlist_path=a.allowlist or ALLOWLIST_PATH,
            pins_path=a.pins or PINS_PATH,
            shape_pins_path=a.shape_pins or SHAPE_PINS_PATH,
            update_pins=a.update_pins,
            use_cache=not a.no_cache,
            cache_dir=a.cache_dir,
            # Stale-grant findings only for full default-target walks:
            # a partial lint never walked most granted files.  Boolean,
            # not a mode-string compare — the --changed fallbacks ARE
            # full walks and must keep the stale check.
            check_stale_allowlist=not a.paths and full_walk)
    except ValueError as e:  # malformed allowlist
        print(f"tcrlint config error: {e}", file=sys.stderr)
        return 2

    stats["mode"] = mode
    ruff = (None if a.no_ruff or not paths
            else run_ruff(root, paths))
    ruff_lines = ruff["lines"] if ruff else []

    if a.as_json:
        print(json.dumps({
            "ok": not findings and not ruff_lines,
            "findings": [f.format() for f in findings],
            "ruff": (None if ruff is None
                     else {"rc": ruff["rc"], "findings": ruff_lines}),
            "ruff_available": ruff is not None,
            "stats": stats,
        }, indent=1))
    else:
        for f in findings:
            print(f.format())
        for ln in ruff_lines:
            print(f"{ln}  [ruff]")
        ruff_note = ("ruff baseline clean" if ruff and not ruff_lines
                     else f"ruff: {len(ruff_lines)} finding(s)" if ruff
                     else "ruff not installed — built-in TCR-F401 "
                          "fallback covered the F-level floor")
        cache = stats.get("cache")
        cache_note = (f", cache {cache['hits']}h/{cache['misses']}m"
                      if cache else "")
        print(f"tcrlint[{mode}]: {stats['files']} files{cache_note}, "
              f"{len(findings)} finding(s), "
              f"{stats['allow_entries']} allowlist grants; {ruff_note}",
              file=sys.stderr)
    if a.update_pins and not a.as_json:
        print(f"schema pins rewritten: {a.pins or PINS_PATH}; shape "
              f"contracts rewritten: {a.shape_pins or SHAPE_PINS_PATH}",
              file=sys.stderr)
    return 1 if (findings or ruff_lines) else 0


if __name__ == "__main__":
    raise SystemExit(main())
