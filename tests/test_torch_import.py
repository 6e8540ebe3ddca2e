"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and it never runs on the CPU unless the caller asks for it."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from text_crdt_rust_tpu_torch import (
    kevin,
    northstar,
    resolve_device,
    storm,
    stream,
)
from text_crdt_rust_tpu_torch.examples import sync_stream
from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch.ops import blocked as TBL
from text_crdt_rust_tpu_torch.ops import blocked_hbm as TBH
from text_crdt_rust_tpu_torch.ops import blocked_mixed as TBM
from text_crdt_rust_tpu_torch.ops import rle as TR
from text_crdt_rust_tpu_torch.ops import rle_hbm as TH
from text_crdt_rust_tpu_torch.ops import rle_lanes as TL
from text_crdt_rust_tpu_torch.ops import rle_lanes_mixed as TLM
from text_crdt_rust_tpu_torch.ops import rle_mixed as TRM
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA
from text_crdt_rust_tpu_torch.utils.testdata import TestPatch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "text_crdt_rust_tpu_torch"
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) \
    + ["chip_smoke.py"]
FORBIDDEN = ("jax", "text_crdt_rust_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['text_crdt_rust_tpu'] = None\n"
        "import text_crdt_rust_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    P.__path__, 'text_crdt_rust_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for m in ('ops.rle', 'ops.rle_mixed', 'northstar', 'storm',\n"
        "          'models.oracle', 'models.sync', 'config', 'stream',\n"
        "          'ops.rle_lanes_mixed', 'parallel.causal',\n"
        "          'examples.sync_stream', 'ops.rle_lanes', 'convert',\n"
        "          'ops.rle_hbm', 'kevin', 'ops.blocked', 'ops.blocked_hbm',\n"
        "          'ops.blocked_mixed'):\n"
        "    assert 'text_crdt_rust_tpu_torch.' + m in names, m\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 24


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_import_in_source(rel):
    bad = [m for m in _imported_roots(REPO / rel)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def _ops():
    ops, _ = TB.compile_local_patches([TestPatch(0, 0, "ab")], lmax=2)
    return ops


@pytest.mark.parametrize("entry", [
    "resolve_device",
    "make_flat_doc",
    "make_replayer_rle",
    "replay_local_rle",
    "run_northstar",
    "make_replayer_rle_mixed",
    "replay_mixed_rle",
    "run_storm",
    "make_replayer_lanes_mixed",
    "make_replayer_lanes_mixed_blocked",
    "run_stream",
    "sync_stream",
    "make_replayer_lanes",
    "make_replayer_lanes_blocked",
    "run_stream_5",
    "make_replayer_rle_hbm",
    "replay_local_rle_hbm",
    "run_kevin",
    "run_northstar_rle_hbm",
    "make_replayer_blocked",
    "replay_local_blocked",
    "make_replayer_hbm",
    "replay_local_hbm",
    "make_replayer_mixed",
    "replay_mixed",
    "run_northstar_blocked",
    "run_northstar_hbm",
    "run_storm_blocked_mixed",
])
def test_entry_point_without_device_raises_on_cpu_host(entry):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default is valid")
    calls = {
        "resolve_device": lambda: resolve_device(),
        "make_flat_doc": lambda: TSA.make_flat_doc(16),
        "make_replayer_rle": lambda: TR.make_replayer_rle(
            _ops(), capacity=64, batch=2, block_k=8),
        "replay_local_rle": lambda: TR.replay_local_rle(
            _ops(), capacity=64, batch=2, block_k=8),
        "run_northstar": lambda: northstar.run_northstar(
            patches=10, batch=2, capacity=64, block_k=8),
        "make_replayer_rle_mixed": lambda: TRM.make_replayer_rle_mixed(
            _ops(), capacity=64, batch=2, block_k=8),
        "replay_mixed_rle": lambda: TRM.replay_mixed_rle(
            _ops(), capacity=64, batch=2, block_k=8),
        "run_storm": lambda: storm.run_storm(
            n_peers=2, rounds=2, batch=2, block_k=8),
        "make_replayer_lanes_mixed": lambda: TLM.make_replayer_lanes_mixed(
            TB.stack_ops([_ops()]), capacity=64),
        "make_replayer_lanes_mixed_blocked":
            lambda: TLM.make_replayer_lanes_mixed_blocked(
                TB.stack_ops([_ops()]), capacity=64, block_k=8),
        "run_stream": lambda: stream.run_stream(
            n_docs=2, chunks=1, steps_per_chunk=4),
        "sync_stream": lambda: sync_stream.run(docs=1, chunks=1,
                                               ops_per_chunk=2),
        "make_replayer_lanes": lambda: TL.make_replayer_lanes(
            TB.stack_ops([_ops()]), capacity=64),
        "make_replayer_lanes_blocked":
            lambda: TL.make_replayer_lanes_blocked(
                TB.stack_ops([_ops()]), capacity=64, block_k=8),
        "run_stream_5": lambda: stream.run_stream_5(
            n_docs=2, chunks=1, steps_per_chunk=4),
        "make_replayer_rle_hbm": lambda: TH.make_replayer_rle_hbm(
            _ops(), capacity=64, batch=2, block_k=8),
        "replay_local_rle_hbm": lambda: TH.replay_local_rle_hbm(
            _ops(), capacity=64, batch=2, block_k=8),
        "run_kevin": lambda: kevin.run_kevin(n=16, batch=2, fuse_w=4,
                                             block_k=8),
        "run_northstar_rle_hbm": lambda: northstar.run_northstar(
            patches=10, batch=2, block_k=8, engine="rle-hbm"),
        "make_replayer_blocked": lambda: TBL.make_replayer(
            _ops(), capacity=64, batch=2, block_k=8),
        "replay_local_blocked": lambda: TBL.replay_local(
            _ops(), capacity=64, batch=2, block_k=8),
        "make_replayer_hbm": lambda: TBH.make_replayer_hbm(
            _ops(), capacity=64, batch=2, block_k=8),
        "replay_local_hbm": lambda: TBH.replay_local_hbm(
            _ops(), capacity=64, batch=2, block_k=8),
        "make_replayer_mixed": lambda: TBM.make_replayer_mixed(
            _ops(), capacity=64, batch=2, block_k=8),
        "replay_mixed": lambda: TBM.replay_mixed(
            _ops(), capacity=64, batch=2, block_k=8),
        "run_northstar_blocked": lambda: northstar.run_northstar(
            patches=10, batch=2, engine="blocked"),
        "run_northstar_hbm": lambda: northstar.run_northstar(
            patches=10, batch=2, engine="hbm"),
        "run_storm_blocked_mixed": lambda: storm.run_storm(
            n_peers=2, rounds=2, batch=2, engine="blocked-mixed"),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_cpu_is_used_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    res = TR.replay_local_rle(_ops(), capacity=64, batch=2, block_k=8,
                              device="cpu")
    assert res.ordp.device.type == "cpu"
    assert np.asarray(res.lenp[0]).tolist() == [2, 2]
    res = TRM.replay_mixed_rle(_ops(), capacity=64, batch=2, block_k=8,
                               device="cpu")
    assert res.ordp.device.type == "cpu"
    assert np.asarray(res.lenp[0]).tolist() == [2, 2]
    res = TH.replay_local_rle_hbm(_ops(), capacity=64, batch=2, block_k=8,
                                  device="cpu")
    assert res.ordp.device.type == "cpu"
    assert np.asarray(res.lenp[0]).tolist() == [2, 2]
    for replay in (TBL.replay_local, TBH.replay_local_hbm,
                   TBM.replay_mixed):
        res = replay(_ops(), capacity=64, batch=2, block_k=8, device="cpu")
        assert res.signed.device.type == "cpu"
        assert np.asarray(res.signed[:3, 0]).tolist() == [1, 2, 0]


@pytest.mark.parametrize("replay", [TR.rle_replay, TRM.rle_mixed_replay,
                                    TL.lanes_replay,
                                    TL.lanes_blocked_replay,
                                    TH.rle_hbm_replay])
def test_replay_refuses_other_devices(replay):
    col = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no replay for device"):
        replay(*[col] * 5)


@pytest.mark.parametrize("replay, ncols", [
    (TBL.blocked_replay, 4), (TBH.blocked_hbm_replay, 4),
    (TBM.blocked_mixed_replay, 12)])
def test_blocked_replay_refuses_other_devices(replay, ncols):
    col = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no replay for device"):
        replay(*[col] * ncols)


def _smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_a_card():
    out = _smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
