"""The port's tcrlint (``text_crdt_rust_tpu_torch.analysis``): the JAX
package's per-family cases aimed at the port, the shared families'
findings equal to the JAX linter's on the same sources, the port's
schema pins equal to the JAX package's, and the gate itself — the
port's linter over ``text_crdt_rust_tpu_torch`` exits 0 with the
committed allowlist and pins, and exits 1 naming ``path:line`` on an
injected violation of each retargeted family (S003, R001, R002, C001)
in a temporary copy of a port file (the dataflow families' injections
are in ``test_torch_analysis_dataflow.py``)."""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from text_crdt_rust_tpu.analysis import run_lint as jax_run_lint
from text_crdt_rust_tpu_torch.analysis import run_lint
from text_crdt_rust_tpu_torch.analysis.checks_schema import (
    SURFACES,
    surface_state,
)
from text_crdt_rust_tpu_torch.analysis.tcrlint import (
    ALLOWLIST_PATH,
    PINS_PATH,
    load_allowlist,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "text_crdt_rust_tpu_torch"
JAX_PINS = os.path.join(REPO, "text_crdt_rust_tpu/analysis/SCHEMA_PINS.json")
CLI = [sys.executable, "-m", "text_crdt_rust_tpu_torch.analysis.lint"]


def lint_tree(tmp_path, files, allow=None, linter=run_lint):
    """Write ``files`` ({rel: source}) into a temp tree and lint it
    in-process (no committed allowlist/pins unless provided)."""
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    allow_path = str(tmp_path / "allow.json")
    if allow is not None:
        (tmp_path / "allow.json").write_text(json.dumps({"allow": allow}))
    return linter(str(tmp_path), allowlist_path=allow_path,
                  pins_path=str(tmp_path / "pins.json"),
                  shape_pins_path=str(tmp_path / "shape.json"))


def the(findings, check):
    hits = [f for f in findings if f.check == check]
    assert hits, f"no {check} finding in {[f.format() for f in findings]}"
    return hits


def copy_port_file(tmp_path, rel, edit=None):
    """A copy of the port's ``rel`` at the same relative path under
    ``tmp_path``, with ``edit(source) -> source`` applied."""
    src = open(os.path.join(REPO, rel)).read()
    if edit is not None:
        out = edit(src)
        assert out != src, "the injection's anchor drifted"
        src = out
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(src)
    return src


def line_of(src, needle):
    lines = src.splitlines()
    hits = [i + 1 for i, ln in enumerate(lines) if needle in ln]
    assert len(hits) == 1, (needle, hits)
    return hits[0]


# -- the shared families: the JAX package's synthetic sources ------------------

#: The JAX package's own test sources for the families that carry over
#: unchanged (``tests/test_analysis_lint.py``), as {rel: source}.
SHARED_SOURCES = {
    "wall.py": """\
        import time


        def emit(tracer):
            tracer_field = time.time()
            return tracer_field
        """,
    "wall2.py": """\
        from time import perf_counter
        import datetime


        def f():
            return perf_counter(), datetime.datetime.now()
        """,
    "hash.py": """\
        def key(x):
            return hash(x) % 16
        """,
    "sets.py": """\
        def emit(names):
            for n in set(names):
                print(n)
            ordered = list({1, 2, 3})
            fine = sorted(set(names))
            count = len(set(names))
            return ordered, fine, count
        """,
    "walks.py": """\
        import glob
        import os


        def walk(d):
            bad = os.listdir(d)
            worse = glob.glob(d + "/*.npz")
            good = sorted(os.listdir(d))
            return bad, worse, good
        """,
    "rand.py": """\
        import random

        import numpy as np


        def gen():
            rng = random.Random(7)          # fine: seeded instance
            a = rng.random()
            b = random.random()             # global state
            c = np.random.rand(3)           # legacy global
            d = np.random.default_rng(7)    # fine: seeded
            e = np.random.default_rng()     # entropy-seeded
            return a, b, c, d, e
        """,
    "serve/swallow.py": """\
        def ingest(frame):
            try:
                return frame.decode()
            except ValueError:
                pass
        """,
    "ops/swallow.py": """\
        def probe(x):
            try:
                return x()
            except ValueError:
                pass
        """,
    "net/reported.py": """\
        class WireError(Exception):
            pass


        def a(frame):
            try:
                return frame.decode()
            except ValueError:
                raise WireError("bad frame")


        def b(frame, counters):
            try:
                return frame.decode()
            except ValueError:
                counters.incr("frames_rejected")


        def c(frame, stats):
            try:
                return frame.decode()
            except ValueError:
                stats["rejected"] += 1


        def d(frame, router):
            try:
                return frame.decode()
            except ValueError as e:
                router.reject_frame(str(e))


        def e(frame):
            try:
                return frame.decode(), None
            except ValueError as exc:
                return None, WireError(str(exc))
        """,
    "imports.py": """\
        import json
        import os  # noqa: F401
        import sys

        print(sys.argv)
        """,
    "pkg/__init__.py": "from .mod_a import used_fn\n",
    "pkg/mod_a.py": """\
        import json
        import os  # noqa
        import sys
        from collections import OrderedDict, deque

        __all__ = ["deque"]


        def used_fn():
            return sys.argv
        """,
}

SHARED = ("TCR-W", "TCR-D", "TCR-X", "TCR-F")


def _shared(findings):
    return [(f.check, f.path, f.line, f.scope, f.message)
            for f in findings if f.check.startswith(SHARED)]


def test_shared_families_equal_the_jax_linter(tmp_path):
    port, _ = lint_tree(tmp_path / "p", SHARED_SOURCES)
    jax, _ = lint_tree(tmp_path / "j", SHARED_SOURCES, linter=jax_run_lint)
    assert _shared(port) == _shared(jax)
    checks = {f[0] for f in _shared(port)}
    assert checks == {"TCR-W001", "TCR-D001", "TCR-D002", "TCR-D003",
                      "TCR-D004", "TCR-X001", "TCR-F401"}


def test_shared_families_equal_on_the_port_tree():
    """The shared families' check modules, the port's and the JAX
    package's, give the same findings on every file of the port: none
    (the port grants no shared-family finding)."""
    import ast
    import importlib

    from text_crdt_rust_tpu.analysis.tcrlint import (
        FileContext as JFileContext,
    )
    from text_crdt_rust_tpu_torch.analysis.tcrlint import (
        FileContext,
        iter_py_files,
    )

    names = ("checks_wallclock", "checks_determinism", "checks_exceptions",
             "checks_pyflakes")
    port = [importlib.import_module(f"{PORT}.analysis.{n}") for n in names]
    jax = [importlib.import_module(f"text_crdt_rust_tpu.analysis.{n}")
           for n in names]
    files = list(iter_py_files(REPO, [PORT]))
    assert len(files) > 80
    got, want = [], []
    for rel in files:
        src = open(os.path.join(REPO, rel), encoding="utf-8").read()
        tree = ast.parse(src, filename=rel)
        ctx, jctx = FileContext(rel, src, tree), JFileContext(rel, src, tree)
        for mod, jmod in zip(port, jax):
            got += [f.format() for f in mod.check(ctx)]
            want += [f.format() for f in jmod.check(jctx)]
    assert got == want == []


# -- family 1: wall-clock --------------------------------------------------------


def test_wallclock_leak_named_by_file_and_line(tmp_path):
    findings, _ = lint_tree(tmp_path, {"wall.py": SHARED_SOURCES["wall.py"]})
    f = the(findings, "TCR-W001")[0]
    assert (f.path, f.line, f.scope) == ("wall.py", 5, "emit")


def test_wallclock_allowlisted_scope_passes(tmp_path):
    findings, _ = lint_tree(
        tmp_path,
        {"mod.py": "import time\n\n\ndef probe():\n"
                   "    return time.perf_counter()\n"},
        allow=[{"check": "TCR-W001", "path": "mod.py", "scope": "probe",
                "why": "test probe"}])
    assert not [f for f in findings if f.check == "TCR-W001"]


def test_stale_allowlist_entry_is_a_finding(tmp_path):
    findings, _ = lint_tree(
        tmp_path, {"mod.py": "X = 1\n"},
        allow=[{"check": "TCR-W001", "path": "mod.py", "scope": "gone",
                "why": "stale"}])
    assert the(findings, "TCR-A001")


def test_unjustified_allowlist_entry_refused(tmp_path):
    with pytest.raises(ValueError, match="justification"):
        lint_tree(tmp_path, {"mod.py": "X = 1\n"},
                  allow=[{"check": "TCR-W001", "path": "mod.py",
                          "scope": "f", "why": ""}])


@pytest.mark.parametrize("rel,check,lines", [
    ("hash.py", "TCR-D001", [2]),
    ("sets.py", "TCR-D002", [2, 4]),
    ("walks.py", "TCR-D003", [6, 7]),
    ("rand.py", "TCR-D004", [9, 10, 12]),
    ("imports.py", "TCR-F401", [1]),
])
def test_determinism_and_f401_lines(tmp_path, rel, check, lines):
    findings, _ = lint_tree(tmp_path, {rel: SHARED_SOURCES[rel]})
    assert [f.line for f in the(findings, check)] == lines


def test_swallow_rules(tmp_path):
    findings, _ = lint_tree(tmp_path, {
        k: SHARED_SOURCES[k] for k in ("serve/swallow.py", "ops/swallow.py",
                                       "net/reported.py")})
    hits = the(findings, "TCR-X001")
    assert [(f.path, f.line) for f in hits] == [("serve/swallow.py", 4)]
    findings, _ = lint_tree(
        tmp_path / "g", {"serve/swallow.py": SHARED_SOURCES[
            "serve/swallow.py"]},
        allow=[{"check": "TCR-X001", "path": "serve/swallow.py",
                "scope": "ingest", "why": "test grant"}])
    assert not [f for f in findings if f.check == "TCR-X001"]


# -- family 3: schema drift on the port's surfaces -------------------------------


def test_unknown_trace_kind_and_ledger_family_flagged(tmp_path):
    findings, _ = lint_tree(tmp_path, {"mod.py": """\
        from text_crdt_rust_tpu_torch.obs.ledger import metric

        GOOD = metric(1, "steps")
        BAD = metric(1, "nonsense")


        def f(tracer):
            tracer.event("tick.drain", shard=0, events=1, steps=1)
            tracer.event("bogus.kind", x=1)
        """})
    f = the(findings, "TCR-S002")[0]
    assert f.line == 4 and "nonsense" in f.message
    f = the(findings, "TCR-S001")[0]
    assert f.line == 9 and "bogus.kind" in f.message


def test_schema_pins_match_live_surfaces_and_the_jax_pins():
    """The port's pins agree with its live field sets, and each
    fingerprint (a CRC of the literals' AST, no path folded in) equals
    the JAX package's pin of the same surface: the port's trace events,
    ledger families and wire kinds are the JAX package's."""
    pins = json.load(open(PINS_PATH))["pins"]
    jpins = json.load(open(JAX_PINS))["pins"]
    assert {s["name"] for s in SURFACES} == set(pins) == {
        "trace-events", "ledger-families", "wire-kinds"}
    for s in SURFACES:
        st = surface_state(REPO, s)
        assert st["fingerprint"] == pins[s["name"]]["fingerprint"]
        assert st["version"] == pins[s["name"]]["version"]
        assert pins[s["name"]]["file"].startswith(PORT + "/")
        assert (pins[s["name"]]["fingerprint"], pins[s["name"]]["version"]) \
            == (jpins[s["name"]]["fingerprint"], jpins[s["name"]]["version"])


def test_schema_drift_injection_named_by_lint(tmp_path):
    """TCR-S003: a copy of the port's ``obs/trace.py`` with one more
    required field on a kind and the version unbumped."""
    rel = f"{PORT}/obs/trace.py"
    src = copy_port_file(tmp_path, rel, lambda s: s.replace(
        '"trace.header": ("schema",),',
        '"trace.header": ("schema", "host"),'))
    findings, _ = run_lint(str(tmp_path), [rel],
                           allowlist_path=str(tmp_path / "a.json"))
    f = the(findings, "TCR-S003")[0]
    assert f.path == rel
    assert f.line == line_of(src, "EVENT_SCHEMA: Dict")
    assert "bump the version" in f.message


# -- family 4: rebuild and reload hazards -----------------------------------------


def test_uncached_build_and_load_flagged_memoised_passes(tmp_path):
    findings, _ = lint_tree(tmp_path, {"mod.py": """\
        import ctypes
        import functools
        import subprocess

        import torch

        _libs = {}
        _lib = None


        def load_bad(path):
            return ctypes.CDLL(path)


        def build_bad(src, out):
            cmd = ["nvcc", "-shared", "-o", out, src]
            subprocess.run(cmd, check=True)


        def load_memo(name, path):
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(path)
                _libs[name] = lib
            return lib


        def load_global(path):
            global _lib
            if _lib is None:
                _lib = ctypes.CDLL(path)
            return _lib


        @functools.lru_cache(maxsize=None)
        def build_cached(src, out):
            subprocess.run(["g++", "-O3", src, "-o", out], check=True)
            return out


        def run_tool(args):
            return subprocess.run(["git", *args])


        def jit_bad(fn):
            return torch.compile(fn)


        @functools.lru_cache(maxsize=8)
        def jit_cached(fn):
            return torch.jit.script(fn)


        top = torch.compile(abs)


        @torch.compile
        def decorated(x):
            return x
        """})
    assert [f.line for f in the(findings, "TCR-R001")] == [12, 17]
    assert [f.line for f in the(findings, "TCR-R002")] == [46]


def test_rebuild_injection_in_a_port_copy(tmp_path):
    """TCR-R001 on a copy of ``ops/_kernels.py`` whose ``library()`` no
    longer keeps its CDLL in ``_libs``; TCR-R002 on a copy of
    ``ops/flat.py`` that compiles the plain step inside a function."""
    rel = f"{PORT}/ops/_kernels.py"
    src = copy_port_file(tmp_path, rel, lambda s: s.replace(
        "        _libs[name] = lib\n", ""))
    findings, _ = run_lint(str(tmp_path), [rel],
                           allowlist_path=ALLOWLIST_PATH,
                           check_stale_allowlist=False)
    f = the(findings, "TCR-R001")
    assert [(x.path, x.line) for x in f] == [
        (rel, line_of(src, "lib = ctypes.CDLL("))]
    rel = f"{PORT}/ops/flat.py"
    src = copy_port_file(tmp_path, rel, lambda s: s.replace(
        "    cols = op_stack(ops)\n",
        "    cols = op_stack(ops)\n"
        "    plain = torch.compile(flat_replay_plain)\n", 1))
    findings, _ = run_lint(str(tmp_path), [rel],
                           allowlist_path=ALLOWLIST_PATH,
                           check_stale_allowlist=False)
    f = the(findings, "TCR-R002")[0]
    assert (f.path, f.line) == (rel, line_of(src, "torch.compile("))


# -- family: claims ---------------------------------------------------------------


def test_claims_injection_names_the_missing_file(tmp_path):
    """TCR-C001 on copies of the real README.md and PERF.md citing files
    that do not exist; TCR-C003 on a kernel row marked ported whose
    ``ops/csrc/`` source is gone."""
    for doc in ("README.md", "PERF.md"):
        shutil.copy(os.path.join(REPO, doc), tmp_path / doc)
    shutil.copytree(os.path.join(REPO, PORT), tmp_path / PORT,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree(os.path.join(REPO, "tests"), tmp_path / "tests",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("chip_smoke.py", "chip_blocked_timing.py", "bench.py",
                 "BASELINE.json"):
        shutil.copy(os.path.join(REPO, name), tmp_path / name)
    shutil.copytree(os.path.join(REPO, "text_crdt_rust_tpu"),
                    tmp_path / "text_crdt_rust_tpu",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    if os.path.isdir(os.path.join(REPO, "perf")):
        shutil.copytree(os.path.join(REPO, "perf"), tmp_path / "perf")
    from text_crdt_rust_tpu_torch.analysis.checks_claims import check_claims

    assert [f.format() for f in check_claims(str(tmp_path))] == []
    readme = (tmp_path / "README.md").read_text().splitlines()
    at = next(i for i, ln in enumerate(readme)
              if ln.startswith("## The PyTorch port")) + 2
    readme.insert(at, "Timed by `tests/test_torch_nowhere.py`.")
    (tmp_path / "README.md").write_text("\n".join(readme) + "\n")
    perf = (tmp_path / "PERF.md").read_text()
    perf += "\nSee `text_crdt_rust_tpu_torch/ops/gone.py:12`.\n"
    (tmp_path / "PERF.md").write_text(perf)
    findings = check_claims(str(tmp_path))
    c1 = the(findings, "TCR-C001")
    assert [(f.path, f.line) for f in c1] == [
        ("README.md", at + 1), ("PERF.md", len(perf.splitlines()))]
    assert "test_torch_nowhere.py" in c1[0].message
    assert "ops/gone.py" in c1[1].message
    assert not [f for f in findings if f.check == "TCR-C003"]
    os.remove(tmp_path / PORT / "ops" / "csrc" / "flat_replay.cu")
    findings = check_claims(str(tmp_path))
    c3 = the(findings, "TCR-C003")
    assert c3 and all("flat_replay.cu" in f.message for f in c3)
    assert all(f.path == "PERF.md" for f in c3)


def test_claims_rules_on_a_small_tree(tmp_path):
    tree = {
        "README.md": """\
            # x
            ## The PyTorch port for the H100
            Run `chip_smoke.py`, see `ops/flat.py:506` and
            `tests/test_torch_flat.py`; `ghost/missing.py` is gone.
            Not citations: `/abs/x.py`, `*.py`, `python -m a.b`.

            ## Later
            `outside/section.py` is not the port's section.
            """,
        "PERF.md": """\
            | # | kernel | status | route |
            |---|---|---|---|
            | A1 | `ops/rle.py::_rle_kernel` | ported, slice 1 | `rle_replay.cu` |
            | A2 | x | ported, slice 5 | `rle_gone.cu` |
            | A3 | x | ported | CUDA |
            | A4 | x | still to be ported | none |
            """,
        "chip_smoke.py": "",
        "text_crdt_rust_tpu_torch/ops/flat.py": "",
        "text_crdt_rust_tpu_torch/ops/rle.py": "",
        "text_crdt_rust_tpu_torch/ops/csrc/rle_replay.cu": "",
        "tests/test_torch_flat.py": "",
    }
    findings, _ = lint_tree(tmp_path, tree)
    c1 = the(findings, "TCR-C001")
    assert [(f.path, f.line) for f in c1] == [("PERF.md", 4),
                                             ("README.md", 4)]
    assert "rle_gone.cu" in c1[0].message
    c3 = the(findings, "TCR-C003")
    assert [(f.path, f.line) for f in c3] == [("PERF.md", 4), ("PERF.md", 5)]


# -- the committed allowlist and the gate ----------------------------------------


def test_committed_allowlist_loads_and_every_entry_justified():
    entries = load_allowlist()
    assert entries
    for e in entries:
        assert e["path"].startswith(PORT + "/"), e
        assert len(e["why"]) > 40, f"thin justification: {e}"
    assert not [e for e in entries if e["check"] == "TCR-W001"]


def test_lint_gate_clean_tree_exits_zero():
    """THE port's lint gate, full-tree flavor: the CLI over
    ``text_crdt_rust_tpu_torch`` (its default target) with the committed
    allowlist and pins exits 0, and every grant is used."""
    r = subprocess.run(CLI + ["--json", "--no-cache"], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, (r.stdout[-4000:], r.stderr[-2000:])
    out = json.loads(r.stdout)
    assert out["ok"] and not out["findings"]
    assert out["stats"]["files"] > 80
    assert out["stats"]["allow_entries"] == len(load_allowlist())
    assert out["stats"]["raw_findings"] == len(load_allowlist())


def test_lint_gate_fails_loud_through_the_cli(tmp_path):
    """One violating tree through the real CLI: exit 1, each finding
    ``path:line``-named on stdout."""
    (tmp_path / "bad.py").write_text(textwrap.dedent("""\
        import ctypes
        import time

        import torch


        def leak():
            return time.time()


        def key(x):
            return hash(x)


        def emit(names):
            return list(set(names))


        def load(path):
            return ctypes.CDLL(path)


        def jit(fn):
            return torch.jit.trace(fn, ())
        """))
    r = subprocess.run(
        CLI + ["--root", str(tmp_path), "--allowlist",
               str(tmp_path / "none.json"), "--pins",
               str(tmp_path / "none_pins.json"), "bad.py"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 1, (r.stdout, r.stderr)
    for want in ("bad.py:8: TCR-W001", "bad.py:12: TCR-D001",
                 "bad.py:16: TCR-D002", "bad.py:20: TCR-R001",
                 "bad.py:24: TCR-R002"):
        assert want in r.stdout, (want, r.stdout)


def test_lint_gate_fails_loud_on_schema_drift(tmp_path):
    """The port's pins with one fingerprint flipped: the CLI exits 1
    naming the surface's file."""
    pins = json.load(open(PINS_PATH))
    pins["pins"]["wire-kinds"]["fingerprint"] ^= 0xBEEF
    mutated = tmp_path / "pins.json"
    mutated.write_text(json.dumps(pins))
    r = subprocess.run(
        CLI + ["--pins", str(mutated), "--no-cache",
               f"{PORT}/analysis"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 1, (r.stdout, r.stderr)
    assert f"{PORT}/net/codec.py" in r.stdout and "TCR-S003" in r.stdout
    assert "bump the version" in r.stdout
