"""Nothing under ``portbench/`` imports JAX, the JAX package or the old
benchmark, and the reference and the generators import nothing of the
port: every module's imports read from its syntax tree, then every module
imported in a fresh process where those names cannot load. Names are
compared whole by their top-level part, so the port
(``text_crdt_rust_tpu_torch``) is not the JAX package
(``text_crdt_rust_tpu``)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "text_crdt_rust_tpu", "bench",
             "chip_smoke", "chip_blocked_timing", "perf"}
PORT = "text_crdt_rust_tpu_torch"
#: Folders whose modules take nothing from the port.
PLAIN = ("reference", "generators", "roofline")

MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in
                 p.parts)


def top_names(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_top_level_names_compare_whole():
    assert PORT.split(".")[0] not in FORBIDDEN
    assert PORT.startswith("text_crdt_rust_tpu")


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_syntax_tree_imports(path):
    names = top_names(path)
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"
    if path.relative_to(HERE).parts[0] in PLAIN:
        assert PORT not in names, f"{path} imports the port"


BLOCKER = r"""
import importlib.abc, json, sys
from pathlib import Path
BLOCKED = set(json.loads(sys.argv[1]))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
from portbench import spec
here = Path(sys.argv[2])
for rel in json.loads(sys.argv[3]):
    p = here / rel
    kind = p.parent.name
    if p.parent == here:
        __import__("portbench." + p.stem)
    elif kind in ("entries", "metrics", "roofline", "generators") and \
            p.stem != "__init__":
        spec.module(kind, p.stem, here)
    else:
        __import__("portbench." + ".".join(p.relative_to(here).with_suffix("")
                                           .parts))
loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
print(json.dumps(loaded))
"""


def test_every_module_imports_with_jax_blocked():
    rels = [str(p.relative_to(HERE)) for p in MODULES
            if p.relative_to(HERE).parts[0] != "tests"]
    p = subprocess.run(
        [sys.executable, "-c", BLOCKER, json.dumps(sorted(FORBIDDEN)),
         str(HERE), json.dumps(rels)],
        cwd=HERE.parent, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
