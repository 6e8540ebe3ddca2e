"""The port's tcrlint dataflow engine and its flow-aware families
(``text_crdt_rust_tpu_torch.analysis``): the JAX package's dataflow cases
aimed at the port, the engine's summaries, CFGs and reaching
definitions equal to the JAX ``dataflow`` on every ``*.py`` of both
packages, each retargeted family (P001, M001-M003, K001/K002) loud on an
injected violation in a temporary copy of a port file and quiet on the
real one, and the incremental machinery (cache, ``--changed`` in a
scratch git repo)."""
import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from text_crdt_rust_tpu.analysis import dataflow as JD
from text_crdt_rust_tpu_torch.analysis import dataflow as TD
from text_crdt_rust_tpu_torch.analysis import run_lint
from text_crdt_rust_tpu_torch.analysis.checks_shape import (
    SHAPE_PINS_PATH,
    harvest_contracts,
)
from text_crdt_rust_tpu_torch.analysis.tcrlint import (
    ALLOWLIST_PATH,
    SUMMARY_SOURCES,
    changed_files,
    load_allowlist,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "text_crdt_rust_tpu_torch"
CLI = [sys.executable, "-m", "text_crdt_rust_tpu_torch.analysis.lint"]
BATCHER = f"{PORT}/serve/batcher.py"
LANES = f"{PORT}/serve/lanes_backend.py"


def lint_tree(tmp_path, files, allow=None, shape_pins=None, **kw):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    allow_path = str(tmp_path / "allow.json")
    if allow is not None:
        (tmp_path / "allow.json").write_text(json.dumps({"allow": allow}))
    return run_lint(str(tmp_path), allowlist_path=allow_path,
                    pins_path=str(tmp_path / "pins.json"),
                    shape_pins_path=shape_pins or str(
                        tmp_path / "shape_pins.json"), **kw)


def lint_copy(tmp_path, rel, edit, **kw):
    """Lint a copy of the port's ``rel`` (``edit`` applied) with the
    committed allowlist and shape pins; returns (findings, source)."""
    src = open(os.path.join(REPO, rel)).read()
    out = edit(src)
    assert out != src, "the injection's anchor drifted"
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(out)
    findings, _ = run_lint(str(tmp_path), [rel],
                           allowlist_path=ALLOWLIST_PATH,
                           pins_path=str(tmp_path / "pins.json"),
                           check_stale_allowlist=False, **kw)
    return findings, out


def line_of(src, needle):
    hits = [i + 1 for i, ln in enumerate(src.splitlines()) if needle in ln]
    assert len(hits) == 1, (needle, hits)
    return hits[0]


def the(findings, check):
    hits = [f for f in findings if f.check == check]
    assert hits, f"no {check} finding in {[f.format() for f in findings]}"
    return hits


def none_of(findings, check):
    hits = [f.format() for f in findings if f.check == check]
    assert not hits, hits


# -- the dataflow engine: the JAX package's cases ------------------------------


def _flow(src, name):
    tree = ast.parse(textwrap.dedent(src))
    for node in ast.walk(tree):
        if getattr(node, "name", None) == name:
            return TD.FunctionFlow(node)
    raise AssertionError(name)


def test_cfg_loop_back_edge_reaches_earlier_statement():
    flow = _flow("""\
        def f(xs):
            for x in xs:
                a = 1
                b = 2
            return a
        """, "f")
    reach = flow.reachable_from(1)
    assert 1 in reach and 2 in reach and 3 in reach


def test_cfg_sync_statement_blocks_propagation():
    from text_crdt_rust_tpu_torch.analysis.checks_pipeline import (
        _is_sync_stmt,
    )

    flow = _flow("""\
        def f(backend, s):
            backend.apply(s)
            torch.cuda.synchronize()
            s.pos[0] = 1
        """, "f")
    sync = {i for i, s in enumerate(flow.stmts) if _is_sync_stmt(s)}
    assert sync == {1}
    assert 2 not in flow.reachable_from(0, blocked=sync)


def test_reaching_defs_const_resolution():
    flow = _flow("""\
        def f(cond):
            a = 48
            b = 48 if cond else 7
            if cond:
                c = 8
            else:
                c = 48
            use(a)
            use(b)
            use(c)
        """, "f")
    uses = [s for s in flow.stmts if isinstance(s, ast.Expr)]
    got = [flow.const_int(u.value.args[0], flow.index[u]) for u in uses]
    assert got == [48, None, None]


def test_alias_closure_chases_stack_and_pad():
    flow = _flow("""\
        def f(streams, apply):
            per_lane = [pad_ops(s, 8) for s in streams]
            stacked = stack_ops(per_lane)
            apply(stacked)
        """, "f")
    call = [s for s in flow.stmts if isinstance(s, ast.Expr)][-1]
    taint, containers = flow.alias_closure(call.value.args,
                                           flow.index[call])
    assert {"stacked", "per_lane", "streams"} <= taint
    assert "per_lane" in containers


def test_summaries_mark_mutating_params():
    tree = ast.parse(textwrap.dedent("""\
        def scrub(a, b):
            a[0] = 0
            return b


        def reader(a):
            return a.sum()


        class K:
            def touch(self):
                self._n_host[0] = 1
        """))
    s = TD.summarize_module(tree)
    assert s["scrub"].mutated_params == ("a",)
    assert s["reader"].mutated_params == ()
    assert "_n_host" in s["K.touch"].writes_self_attrs


# -- the engine equals the JAX package's on both packages --------------------------


def _flow_facts(flow):
    return ({i: sorted(v) for i, v in flow.succ.items()},
            [{k: sorted(v) for k, v in d.items()} for d in flow.defs_in],
            sorted(flow.reachable_from(0)) if flow.stmts else [])


@pytest.mark.parametrize("package", ["text_crdt_rust_tpu", PORT])
def test_dataflow_equals_the_jax_engine_on_every_file(package):
    files = sorted(Path(REPO, package).rglob("*.py"))
    assert len(files) > 50
    functions = 0
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        js = {k: dataclasses.asdict(v)
              for k, v in JD.summarize_module(tree).items()}
        ts = {k: dataclasses.asdict(v)
              for k, v in TD.summarize_module(tree).items()}
        assert ts == js, path
        jq = [q for q, _ in JD.iter_functions(tree)]
        tq = [(q, fn) for q, fn in TD.iter_functions(tree)]
        assert [q for q, _ in tq] == jq, path
        for qual, fn in tq:
            assert _flow_facts(TD.FunctionFlow(fn)) == \
                _flow_facts(JD.FunctionFlow(fn)), (path, qual)
            functions += 1
    assert functions > 500


# -- TCR-P: pipeline escape ------------------------------------------------------


def test_post_dispatch_mutations_flagged(tmp_path):
    findings, _ = lint_tree(tmp_path, {
        "mod.py": """\
            def tick(backend, stacked):
                backend.apply(stacked)
                stacked.pos[0] = 7


            def scrub(a):
                a[0] = 0


            def helper_tick(backend, stacked):
                backend.apply(stacked)
                scrub(stacked.pos)


            def tensor_tick(docs, train, F):
                F.flat_replay(docs, train, skip_idle=True)
                train.ins_len.zero_()


            def scatter_tick(docs, delta, F):
                F.scatter_delta_(docs, delta)
                delta.ins_pos.copy_(delta.or_pos)
            """})
    assert [f.line for f in the(findings, "TCR-P001")] == [3, 12, 17, 22]


def test_staged_syncs_pass(tmp_path):
    findings, _ = lint_tree(tmp_path, {"mod.py": """\
        import torch


        def a(backend, stacked):
            backend.apply(stacked)
            backend.barrier()
            stacked.pos[0] = 7


        def b(docs, train, F, event):
            F.flat_replay(docs, train, skip_idle=True)
            event.synchronize()
            train.ins_len.zero_()


        def c(self, backend, lane_streams):
            stacked = stack_ops(
                [pad_ops(s, 8) for s in lane_streams.values()])
            backend.apply(stacked)
            lane_streams[0] = None
            self.counters["ticks"] += 1
        """})
    none_of(findings, "TCR-P001")


def test_pipeline_injection_in_the_port_batcher(tmp_path):
    """A host write through the dispatched stack's per-lane streams,
    right after ``backend.apply`` in a copy of the port's batcher."""
    anchor = "                disp = self._wall_ms(t_dev)\n"
    findings, src = lint_copy(tmp_path, BATCHER, lambda s: s.replace(
        anchor, anchor + "                per_lane[0].pos[0] = 0\n", 1))
    f = the(findings, "TCR-P001")
    assert [(x.path, x.line) for x in f] == [
        (BATCHER, line_of(src, "per_lane[0].pos[0] = 0"))]
    assert f"dispatched at line {line_of(src, 'backend.apply(stacked)')}" \
        in f[0].message


def test_real_serve_tick_is_the_known_clean_corpus():
    findings, _ = run_lint(REPO, [BATCHER, LANES, f"{PORT}/ops/flat.py",
                                  f"{PORT}/serve/residency.py"])
    none_of(findings, "TCR-P001")


# -- TCR-M: mirror pairing -----------------------------------------------------

MIRROR_CUT = """\
        self._n_host += np.asarray(
            stacked.ins_len, dtype=np.int64).sum(axis=0)
        self._next_order_host += np.asarray(
            stacked.order_advance, dtype=np.int64).sum(axis=0)
"""
TRAIN_SYNC_CUT = """\
        self._n_host = self._n_host + self._pending_n
        self._next_order_host = self._next_order_host + self._pending_o
"""


def test_mirror_skip_injection_named_by_lint(tmp_path):
    """The port's ``FlatLaneBackend.apply`` with both mirror advances
    cut (the serial block and the train true-up)."""
    findings, src = lint_copy(tmp_path, BATCHER, lambda s: s.replace(
        MIRROR_CUT, "").replace(TRAIN_SYNC_CUT, ""))
    hits = [f for f in the(findings, "TCR-M001")
            if f.scope == "FlatLaneBackend.apply"]
    assert hits and "_n_host" in hits[0].message
    assert hits[0].line == line_of(src, "F.scatter_delta_(self.docs, delta)")
    assert the(findings, "TCR-M003")[0].scope == \
        "FlatLaneBackend._dispatch_train"


def test_train_sync_split_injection_named_by_lint(tmp_path):
    findings, src = lint_copy(tmp_path, BATCHER,
                              lambda s: s.replace(TRAIN_SYNC_CUT, ""))
    hits = the(findings, "TCR-M003")
    assert hits[0].scope == "FlatLaneBackend._dispatch_train"
    assert hits[0].line == line_of(src, "F.scatter_delta_(docs, delta)")
    assert "atomic" in hits[0].message


def test_lane_write_pairing_injection(tmp_path):
    """The lane-write helper's callers own the pairing: cutting
    ``clear_lane``'s mirror resets makes ``clear_lane`` a finding, on
    both backends."""
    findings, src = lint_copy(tmp_path, BATCHER, lambda s: s.replace(
        "        self._write_lane(b, self._empty)\n"
        "        self._n_host[b] = 0\n"
        "        self._next_order_host[b] = 0\n",
        "        self._write_lane(b, self._empty)\n"))
    hits = [f for f in the(findings, "TCR-M001")
            if f.scope == "FlatLaneBackend.clear_lane"]
    assert hits and hits[0].line == line_of(
        src, "self._write_lane(b, self._empty)")
    findings, src = lint_copy(tmp_path, LANES, lambda s: s.replace(
        "        self._rkl[:, b] = rkl\n"
        "        self._lane_rows[b] = len(starts)\n"
        "        self._resident_fresh[b] = True\n", ""))
    hits = [f for f in the(findings, "TCR-M001")
            if f.scope == "LanesMixedLaneBackend.upload_lane"]
    assert hits and hits[0].path == LANES


def test_unregistered_serve_backend_class_flagged(tmp_path):
    """TCR-M002: a copy of the port's residency module with a new lane
    backend class that writes its tensors in place."""
    rel = f"{PORT}/serve/residency.py"
    add = ("\n\nclass ShinyLaneBackend:\n"
           "    def clear_lane(self, b):\n"
           "        for plane in self.planes:\n"
           "            plane[:, b].zero_()\n")
    findings, src = lint_copy(tmp_path, rel, lambda s: s + add)
    f = the(findings, "TCR-M002")[0]
    assert (f.path, f.line) == (rel, line_of(src, "plane[:, b].zero_()"))
    assert "MIRROR_CONTRACTS" in f.message


def test_mirror_rules_on_small_classes(tmp_path):
    findings, _ = lint_tree(tmp_path, {
        "mod.py": """\
            class FlatLaneBackend:
                def _bump(self, b):
                    self._n_host[b] += 1

                def clear_lane(self, b):
                    self.docs.signed[b].zero_()
                    self._bump(b)

                def _true_up(self):
                    self._n_host = self._n_host + self._pending_n

                def _dispatch_train(self):
                    d = self.docs
                    d.n[0] = 0
                    self._true_up()

                def bad(self, b):
                    for t in (self.docs.signed, self.docs.ol_log):
                        t[b].copy_(t[0])
            """})
    hits = the(findings, "TCR-M001")
    assert [f.scope for f in hits] == ["FlatLaneBackend.bad"]
    assert the(findings, "TCR-M003")[0].scope == \
        "FlatLaneBackend._dispatch_train"


def test_clean_backends_pass_with_committed_allowlist():
    findings, _ = run_lint(REPO, [BATCHER, LANES])
    for check in ("TCR-M001", "TCR-M002", "TCR-M003"):
        none_of(findings, check)
    grants = {e["scope"] for e in load_allowlist()
              if e["check"] == "TCR-M001"}
    assert grants == {"FlatLaneBackend._write_lane",
                      "FlatLaneBackend.remap_lane_ranks",
                      "LanesMixedLaneBackend._write_lane"}


def test_producers_harvested_from_the_port_flat_engine():
    from text_crdt_rust_tpu_torch.analysis.checks_mirror import (
        harvest_producers,
    )

    got = harvest_producers(REPO)
    assert {"scatter_delta_", "apply_prefill_delta", "flat_replay",
            "flat_replay_cuda", "apply_train", "apply_ops_batch"} <= got
    assert "op_stack" not in got and "_delta_writes" not in got


# -- TCR-K: shape contracts ------------------------------------------------------


def test_off_series_literal_and_const_prop_flagged(tmp_path):
    findings, _ = lint_tree(tmp_path, {"mod.py": """\
        def stage(stream, pad_ops, PrefillDelta, cols):
            bkt = 48
            ok = pad_ops(stream, 8)
            bad = pad_ops(stream, 48)
            worse = pad_ops(stream, bkt)
            dyn = pad_ops(stream, len(stream))
            kw_ok = pad_ops(stream, num_steps=32)
            kw_bad = pad_ops(stream, num_steps=48)
            good = PrefillDelta(*cols, bucket=128)
            off = PrefillDelta(*cols, bucket=100)
            return ok, bad, worse, dyn, kw_ok, kw_bad, good, off
        """}, shape_pins=SHAPE_PINS_PATH)
    hits = the(findings, "TCR-K001")
    assert [f.line for f in hits] == [4, 5, 8, 10]
    assert "step-bucket series" in hits[0].message
    assert "scatter-bucket series" in hits[-1].message


def test_off_series_chunk_injection_in_the_lanes_backend(tmp_path):
    findings, src = lint_copy(tmp_path, LANES, lambda s: s.replace(
        "order_capacity=self.order_capacity, chunk=S,",
        "order_capacity=self.order_capacity, chunk=48,"),
        shape_pins_path=SHAPE_PINS_PATH)
    f = the(findings, "TCR-K001")[0]
    assert f.path == LANES
    assert f.line == line_of(src, "run = RLM.make_replayer_lanes_mixed")


def test_shape_contracts_pin_matches_live_tree():
    live = harvest_contracts(REPO)
    pinned = json.load(open(SHAPE_PINS_PATH))["contracts"]
    assert live == pinned
    assert live["scatter-series"]["base"] == 32
    assert live["scatter-series"]["factor"] == 4
    assert live["step-buckets"]["buckets"] == [8, 32, 128]
    cols = live["launch-op-columns"]
    assert len([s for m in cols.values() for s in m]) == 11
    assert cols[f"{PORT}/ops/flat.py"] == {
        "flat_replay_launch": {"c_void_p": 11, "c_int": 8}}


def test_shape_drift_injections_named_by_lint(tmp_path):
    """TCR-K002 on copies of the port's ``config.py`` (a fourth step
    bucket) and ``ops/rle.py`` (one pointer argument fewer)."""
    rel = f"{PORT}/config.py"
    findings, src = lint_copy(tmp_path, rel, lambda s: s.replace(
        "step_buckets: tuple = (8, 32, 128)",
        "step_buckets: tuple = (8, 32, 128, 512)"),
        shape_pins_path=SHAPE_PINS_PATH)
    f = [x for x in the(findings, "TCR-K002") if x.path == rel][0]
    assert f.line == line_of(src, "step_buckets: tuple")
    assert "--update-pins" in f.message
    rel = f"{PORT}/ops/rle.py"
    findings, src = lint_copy(tmp_path, rel, lambda s: s.replace(
        "_ARGTYPES = [ctypes.c_void_p] * 16", "_ARGTYPES = [ctypes.c_void_p] * 15"),
        shape_pins_path=SHAPE_PINS_PATH)
    f = [x for x in the(findings, "TCR-K002") if x.path == rel]
    assert f and f[0].line == line_of(src, "_ARGTYPES = [ctypes")
    assert "rle_replay_launch" in f[0].message


def test_update_pins_rewrites_shape_contracts(tmp_path):
    out = tmp_path / "shape_pins.json"
    run_lint(REPO, [f"{PORT}/analysis/checks_shape.py"],
             shape_pins_path=str(out), update_pins=True,
             pins_path=str(tmp_path / "schema_pins.json"))
    assert json.load(open(out))["contracts"] == \
        json.load(open(SHAPE_PINS_PATH))["contracts"]


# -- incremental: cache + changed ----------------------------------------------


def test_cache_hits_invalidation_and_faithful_reuse(tmp_path):
    files = {"mod.py": "import time\n\n\ndef f():\n"
                       "    return time.time()\n", "other.py": "Y = 2\n"}
    f1, s1 = lint_tree(tmp_path, files, use_cache=True)
    assert s1["cache"] == {"hits": 0, "misses": 2}
    assert (tmp_path / ".tcrlint_torch_cache" / "cache.json").exists()
    f2, s2 = lint_tree(tmp_path, {}, use_cache=True)
    assert s2["cache"] == {"hits": 2, "misses": 0}
    assert [f.format() for f in f1] == [f.format() for f in f2]
    (tmp_path / "other.py").write_text("Y = 3\n")
    _, s3 = lint_tree(tmp_path, {}, use_cache=True)
    assert s3["cache"] == {"hits": 1, "misses": 1}
    f4, s4 = lint_tree(
        tmp_path, {}, use_cache=True,
        allow=[{"check": "TCR-W001", "path": "mod.py", "scope": "f",
                "why": "test probe grant for the cache invalidation"}],
        check_stale_allowlist=False)
    assert s4["cache"]["misses"] == 2
    none_of(f4, "TCR-W001")


def _git(cwd, *args):
    return subprocess.run(["git", "-C", str(cwd), *args],
                          capture_output=True, text=True, check=True)


def _scratch_repo(tmp_path, files):
    repo = tmp_path / "r"
    repo.mkdir()
    _git(repo, "init", "-q", "-b", "main")
    _git(repo, "config", "user.email", "t@t")
    _git(repo, "config", "user.name", "t")
    for rel, src in files.items():
        p = repo / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    _git(repo, "add", "-A")
    _git(repo, "commit", "-qm", "seed")
    return repo


def _cli(capsys, repo, *args):
    """The CLI's ``main`` in this process: (exit code, stdout, stderr)."""
    from text_crdt_rust_tpu_torch.analysis import lint

    rc = lint.main(["--root", str(repo), "--no-cache",
                    "--allowlist", str(repo / "none.json"),
                    "--pins", str(repo / "none_pins.json"),
                    "--shape-pins", str(repo / "none_shape.json"), *args])
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.skipif(shutil.which("git") is None, reason="needs git")
def test_changed_mode_in_a_scratch_git_repo(tmp_path, capsys):
    """``--changed`` lints only the edited file; a changed summary
    source widens to the full walk; a bad explicit base exits 2; a tree
    without git falls back to the full walk."""
    src = f"{PORT}/ops/flat.py"
    assert src in SUMMARY_SOURCES
    repo = _scratch_repo(tmp_path, {"clean.py": "A = 1\n",
                                    "dirty.py": "B = 2\n", src: "C = 1\n"})
    (repo / "dirty.py").write_text(
        "import time\n\n\ndef f():\n    return time.time()\n")
    assert changed_files(str(repo)) == ["dirty.py"]
    rc, so, _ = _cli(capsys, repo, "--changed", "HEAD", "--json",
                     "dirty.py", "clean.py")
    out = json.loads(so)
    assert rc == 1
    assert out["stats"]["files"] == 1
    assert any("dirty.py:5: TCR-W001" in f for f in out["findings"])
    (repo / src).write_text("C = 2\n")
    rc, so, _ = _cli(capsys, repo, "--changed", "HEAD", "--json", PORT,
                     "clean.py")
    out = json.loads(so)
    assert "summary source" in out["stats"]["mode"]
    assert out["stats"]["files"] == 2
    rc, _, se = _cli(capsys, repo, "--changed", "no-such-ref-xyz", "--json")
    assert rc == 2
    assert "usage error" in se and "no-such-ref-xyz" in se
    plain = tmp_path / "plain"
    plain.mkdir()
    (plain / "mod.py").write_text("A = 1\n")
    rc, so, _ = _cli(capsys, plain, "--changed", "--json", "mod.py")
    out = json.loads(so)
    assert out["stats"]["files"] == 1 and "fell back" in out["stats"]["mode"]


def test_lint_gate_loud_through_cli_on_the_flow_families(tmp_path):
    (tmp_path / "bad.py").write_text(textwrap.dedent("""\
        def tick(backend, stacked, pad_ops):
            backend.apply(stacked)
            stacked.pos[0] = 7
            return pad_ops(stacked, 48)
        """))
    (tmp_path / "README.md").write_text(textwrap.dedent("""\
        ## The PyTorch port for the H100
        Timed by `ghost_probe.py`.
        """))
    nb = tmp_path / PORT / "serve" / "nb.py"
    nb.parent.mkdir(parents=True)
    nb.write_text(textwrap.dedent("""\
        class NewBackend:
            def seed(self, b):
                self.state[b].copy_(self.state[0])
        """))
    r = subprocess.run(
        CLI + ["--root", str(tmp_path), "--no-cache",
               "--allowlist", str(tmp_path / "none.json"),
               "--pins", str(tmp_path / "none_pins.json"),
               "--shape-pins", SHAPE_PINS_PATH, "bad.py", PORT],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 1, (r.stdout, r.stderr)
    for want in ("bad.py:3: TCR-P001", "bad.py:4: TCR-K001",
                 "README.md:2: TCR-C001", "nb.py:3: TCR-M002"):
        assert want in r.stdout, (want, r.stdout)
