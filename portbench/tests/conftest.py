"""A small copy of the benchmark in a temporary directory: the harness's
files, and tiny cells of both entries that the plain replay runs on the
CPU in about a second."""
import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent

TINY = {
    "tiny-trace": ({"history": {"generator": "trace",
                                "trace": "automerge-paper",
                                "patches": 1500},
                    "entry": "northstar", "engine": "rle", "fuse_w": 8,
                    "block_k": 32, "capacity": 512},
                   {"groups": 2, "batch": 2}),
    "tiny-edits": ({"history": {"generator": "random_change",
                                "patches": 300, "ins_weight": [0.55, 0.45],
                                "short_len": 100, "max_ins": 3,
                                "max_del": 10,
                                "alphabet": "abcdefghijklmnop_"},
                    "entry": "random_edits", "engine": "rle",
                    "block_k": 16, "capacity": 1024, "chunk": 64},
                   {"groups": 2, "batch": 3}),
}


def make_tree(tmp: Path) -> Path:
    """``tmp`` as a checkout root holding a copy of the harness and a
    ``BENCHMARK.json`` of the tiny cells; returns the harness's copy."""
    here = tmp / "portbench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for name, (cfg, traffic) in TINY.items():
        cfg = dict(cfg, name=name, reduced=[])
        (here / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        (here / "traffic" / f"{name}.json").write_text(
            json.dumps(dict(traffic, config=name)))
        bench["configs"].append({"name": name, "source": "tiny",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "a CPU test"})
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": name, "chips": 1,
                                   "why": "a CPU test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (tmp / "benchmark_data").symlink_to(HERE.parent / "benchmark_data")
    return here


@pytest.fixture
def tree(tmp_path):
    return make_tree(tmp_path)
