"""TCR-S00x: schema-drift cross-checks on the port's surfaces.

The repo's versioned-artifact discipline (modeled on Automerge's binary
format) says: every emitted kind/metric/row validates against a
declared schema, and a schema change ships with a version bump.  Two of
those cross-checks are per-call-site:

- **TCR-S001** every string-literal kind passed to ``.event(...)`` /
  ``.span(...)`` must exist in the port's ``obs.trace.EVENT_SCHEMA`` —
  an emit site for an undeclared kind would raise at runtime *if* that
  path runs in tests; the lint catches it before any path runs.
- **TCR-S002** every string-literal family passed to
  ``obs.ledger.metric(value, family)`` must be a registered
  ``METRIC_FAMILIES`` member.

And one is project-level (**TCR-S003**): the *field sets* of the
schema surfaces — ``EVENT_SCHEMA``, ``METRIC_FAMILIES``, the codec's
frame kinds — are fingerprinted (CRC32 over the AST of the literal, so
comments and formatting don't churn it) and pinned in
``SCHEMA_PINS.json`` together with their version constants.  Editing a
surface without touching its version is a finding; bumping the version
requires re-pinning via ``--update-pins`` in the same change, which
puts the new fingerprint in the diff, where review sees it.  A
fingerprint depends only on the literals, so the port's pins equal the
JAX package's for the same field sets.  The JAX package's fourth
surface, ``bench.py``'s ``ROW_SCHEMA``, has no counterpart until the
port has a bench row.
"""
from __future__ import annotations

import ast
import json
import os
import zlib
from typing import List, Optional

from .tcrlint import FileContext, Finding

#: The pinned schema surfaces: where each field-set literal lives and
#: which version constant must move when it does.
SURFACES = (
    {"name": "trace-events",
     "file": "text_crdt_rust_tpu_torch/obs/trace.py",
     "literals": ("EVENT_SCHEMA",), "version": "TRACE_SCHEMA_VERSION"},
    {"name": "ledger-families",
     "file": "text_crdt_rust_tpu_torch/obs/ledger.py",
     "literals": ("METRIC_FAMILIES",), "version": "LEDGER_SCHEMA_VERSION"},
    {"name": "wire-kinds", "file": "text_crdt_rust_tpu_torch/net/codec.py",
     "literals": ("MAGIC", "_FRAME_VERSIONS", "KIND_TXNS", "KIND_REQUEST",
                  "KIND_DIGEST", "KIND_TXNS_MUX"),
     "version": "FRAME_VERSION_COLUMNAR"},
)


def _trace_kinds() -> set:
    from ..obs.trace import EVENT_SCHEMA

    return set(EVENT_SCHEMA)


def _ledger_families() -> set:
    from ..obs.ledger import METRIC_FAMILIES

    return set(METRIC_FAMILIES)


def check(ctx: FileContext) -> List[Finding]:
    kinds = _trace_kinds()
    families = _ledger_families()
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        attr = node.func.attr
        if attr in ("event", "span") and node.args:
            arg = node.args[0]
            if (isinstance(arg, ast.Constant) and isinstance(arg.value, str)
                    and arg.value not in kinds):
                out.append(ctx.finding(
                    "TCR-S001", node,
                    f"trace kind {arg.value!r} is not declared in "
                    f"obs.trace.EVENT_SCHEMA — declare its required "
                    f"fields (and bump TRACE_SCHEMA_VERSION if the "
                    f"stream contract changes)"))
    # metric(value, "family") — imported bare or as ledger.metric.
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fname = None
        if isinstance(node.func, ast.Name):
            fname = node.func.id
        elif isinstance(node.func, ast.Attribute):
            fname = node.func.attr
        if fname != "metric" or len(node.args) < 2:
            continue
        fam = node.args[1]
        if (isinstance(fam, ast.Constant) and isinstance(fam.value, str)
                and fam.value not in families):
            out.append(ctx.finding(
                "TCR-S002", node,
                f"ledger metric family {fam.value!r} is not registered "
                f"in obs.ledger.METRIC_FAMILIES"))
    return out


# -- TCR-S003: pinned schema fingerprints -------------------------------------


def _module_assign(tree: ast.Module, name: str) -> Optional[ast.AST]:
    """The value node of a module-level ``name = <literal>`` (or
    annotated) assignment."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    return node.value
        elif (isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)
              and node.target.id == name and node.value is not None):
            return node.value
    return None


def surface_state(root: str, surface: dict) -> Optional[dict]:
    """Current ``{"version", "fingerprint", "line"}`` of one surface;
    None when its file is absent under ``root`` (temp trees)."""
    path = os.path.join(root, surface["file"])
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=surface["file"])
    dumps: List[str] = []
    line = 1
    for lit in surface["literals"]:
        value = _module_assign(tree, lit)
        if value is None:
            dumps.append(f"<missing:{lit}>")
        else:
            dumps.append(ast.dump(value))
            line = value.lineno
    version_node = _module_assign(tree, surface["version"])
    version = (version_node.value
               if isinstance(version_node, ast.Constant) else None)
    fp = zlib.crc32("\n".join(dumps).encode()) & 0xFFFFFFFF
    return {"version": version, "fingerprint": fp, "line": line}


def check_pins(root: str, pins_path: str,
               update: bool = False) -> List[Finding]:
    """Compare every surface's live fingerprint/version against the
    committed pins; with ``update=True`` rewrite the pins instead."""
    present = [(s, surface_state(root, s)) for s in SURFACES]
    present = [(s, st) for s, st in present if st is not None]
    if not present:
        return []  # a temp tree with no schema surfaces: nothing to pin
    pins_rel = os.path.relpath(pins_path, root).replace(os.sep, "/")
    if update:
        pins = {s["name"]: {"version": st["version"],
                            "fingerprint": st["fingerprint"],
                            "file": s["file"]}
                for s, st in present}
        with open(pins_path, "w") as f:
            json.dump({"comment":
                       "tcrlint TCR-S003 schema pins — regenerate with "
                       "python -m text_crdt_rust_tpu_torch.analysis.lint "
                       "--update-pins (commit alongside any schema "
                       "change + version bump)",
                       "pins": pins}, f, indent=1, sort_keys=True)
            f.write("\n")
        return []
    if not os.path.exists(pins_path):
        return [Finding(
            check="TCR-S003", path=pins_rel, line=1, scope="<pins>",
            message="schema pins file missing — run the lint with "
                    "--update-pins and commit it")]
    with open(pins_path) as f:
        pins = json.load(f)["pins"]
    out: List[Finding] = []
    for s, st in present:
        pin = pins.get(s["name"])
        if pin is None:
            out.append(Finding(
                check="TCR-S003", path=pins_rel, line=1, scope="<pins>",
                message=f"surface {s['name']!r} has no pin — run "
                        f"--update-pins and commit the diff"))
            continue
        if st["fingerprint"] == pin["fingerprint"]:
            # Version moved with no field change is still a re-pin
            # moment (the pin records the pairing).
            if st["version"] != pin["version"]:
                out.append(Finding(
                    check="TCR-S003", path=s["file"], line=st["line"],
                    scope="<module>",
                    message=f"{s['name']}: {s['version']} bumped "
                            f"{pin['version']} -> {st['version']} — "
                            f"refresh the pin (--update-pins) in this "
                            f"same change"))
            continue
        if st["version"] == pin["version"]:
            out.append(Finding(
                check="TCR-S003", path=s["file"], line=st["line"],
                scope="<module>",
                message=f"{s['name']}: field set changed "
                        f"(fingerprint {pin['fingerprint']} -> "
                        f"{st['fingerprint']}) but {s['version']} is "
                        f"still {st['version']} — bump the version and "
                        f"re-pin (--update-pins)"))
        else:
            out.append(Finding(
                check="TCR-S003", path=s["file"], line=st["line"],
                scope="<module>",
                message=f"{s['name']}: schema and version both moved "
                        f"({pin['version']} -> {st['version']}) — "
                        f"refresh the pin (--update-pins) so the new "
                        f"pairing is committed"))
    return out
