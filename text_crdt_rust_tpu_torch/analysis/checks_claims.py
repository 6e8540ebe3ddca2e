"""TCR-C00x: claims consistency — the port's docs against the files they
cite (the port's counterpart of the JAX package's family).

A number is only a claim when the script that produced it and the code
it measured are in the tree.  Claims rot structurally: a kernel source
is renamed, a test file merged into another, a script moved, and the
prose keeps citing the old name.  Nothing executes markdown, so no test
catches it — a docs cross-check does:

- **TCR-C001** — a file cited in backticks in README.md's port section
  (``## The PyTorch port ...`` up to the next ``## ``) or anywhere in
  PERF.md that does not exist: the cited evidence is gone.  A citation
  is a backticked path with a file extension (``chip_smoke.py``,
  ``tests/test_torch_flat.py``, ``serve/batcher.py:1218``,
  ``ops/rle.py::_rle_kernel``); it resolves against the repo root, the
  port's package, the JAX package, the port's ``ops/csrc/`` and
  ``tests/``, the places the docs cite from.  Line and ``::name`` suffixes are dropped;
  absolute paths, globs and commands are not citations.
- **TCR-C003** — a row of a PERF.md table whose status cell says
  "ported" (not "to be ported") but whose ``ops/csrc/`` source does
  not exist, or which names no ``.cu`` source at all: a kernel claimed
  ported with no committed kernel.

The JAX package's TCR-C002 (a superseded TPU recovery-watcher script in
README's claims table) has no counterpart: the port has no such
scripts.  Pure project-level pass (markdown is not walked by the .py
file iterator); temp trees without the doc files skip silently.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

from .tcrlint import Finding

PORT = "text_crdt_rust_tpu_torch"
CSRC = f"{PORT}/ops/csrc"

#: Where a cited path may resolve, in order.
CITE_ROOTS = ("", f"{PORT}/", "text_crdt_rust_tpu/", f"{CSRC}/", "tests/")

PORT_HEADING = "## The PyTorch port"

_TICKED = re.compile(r"`([^`\s]+)`")
_PATHLIKE = re.compile(
    r"^[A-Za-z0-9_.\-/]*[A-Za-z0-9_\-]\.(?:py|cu|cuh|cpp|json|jsonl|md|sh|"
    r"npz|txt)$")
_SOURCE = re.compile(r"([A-Za-z0-9_\-/]+\.cu)\b")
_PORTED = re.compile(r"\bported\b", re.I)
_NOT_PORTED = re.compile(r"\b(?:to be|not|not yet|still to be)\s+ported\b",
                         re.I)


def _port_section(lines: List[str]) -> Optional[Tuple[int, int]]:
    """[start, end) line span (0-based) of README's port section."""
    start = None
    for i, line in enumerate(lines):
        if start is None:
            if line.startswith(PORT_HEADING):
                start = i
        elif line.startswith("## "):
            return (start, i)
    return (start, len(lines)) if start is not None else None


def cited_path(token: str) -> Optional[str]:
    """The file a backticked token cites, or None when it is no
    citation."""
    path = token.split("::")[0]
    path = re.sub(r"(?::\d[\d\-,]*)+$", "", path)
    if path.startswith(("/", "~", ".")) or not _PATHLIKE.match(path):
        return None
    return path


def resolves(root: str, path: str) -> bool:
    return any(os.path.exists(os.path.join(root, base + path))
               for base in CITE_ROOTS)


def _check_citations(root: str, doc: str, lines: List[str],
                     span: Tuple[int, int], out: List[Finding]) -> None:
    for i in range(*span):
        for m in _TICKED.finditer(lines[i]):
            path = cited_path(m.group(1))
            if path is None or resolves(root, path):
                continue
            out.append(Finding(
                check="TCR-C001", path=doc, line=i + 1, scope="<doc>",
                message=f"cites {path} which does not exist — the "
                        f"evidence was renamed, moved or never "
                        f"committed; fix the reference or commit the "
                        f"file"))


def _check_kernel_rows(root: str, doc: str, lines: List[str],
                       out: List[Finding]) -> None:
    for i, line in enumerate(lines):
        if not line.lstrip().startswith("|"):
            continue
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        status = [c for c in cells if _PORTED.search(c)
                  and not _NOT_PORTED.search(c)]
        if not status:
            continue
        sources = sorted({m.group(1).split("/")[-1]
                          for m in _SOURCE.finditer(line)})
        if not sources:
            out.append(Finding(
                check="TCR-C003", path=doc, line=i + 1, scope="<doc>",
                message=f"kernel row {cells[0][:40]!r} is marked ported "
                        f"but names no ops/csrc/*.cu source — cite the "
                        f"committed kernel or mark the row to be "
                        f"ported"))
            continue
        for src in sources:
            if not os.path.exists(os.path.join(root, CSRC, src)):
                out.append(Finding(
                    check="TCR-C003", path=doc, line=i + 1,
                    scope="<doc>",
                    message=f"kernel row {cells[0][:40]!r} is marked "
                            f"ported but {CSRC}/{src} does not exist — "
                            f"commit the kernel or mark the row to be "
                            f"ported"))


def check_claims(root: str) -> List[Finding]:
    out: List[Finding] = []
    readme = os.path.join(root, "README.md")
    if os.path.exists(readme):
        with open(readme, encoding="utf-8") as f:
            lines = f.read().splitlines()
        span = _port_section(lines)
        if span is not None:
            _check_citations(root, "README.md", lines, span, out)
    perf = os.path.join(root, "PERF.md")
    if os.path.exists(perf):
        with open(perf, encoding="utf-8") as f:
            lines = f.read().splitlines()
        _check_citations(root, "PERF.md", lines, (0, len(lines)), out)
        _check_kernel_rows(root, "PERF.md", lines, out)
    return out
