"""Build the native engine's shared library with g++ (counterpart of
``text_crdt_rust_tpu/native/build.py``).

The engine (``tcr_engine.cpp``) is the single-core CPU baseline the
device replays are judged against; it is CPU code by nature, built with
``-march=native`` for the host it runs on. The library lands in
``text_crdt_rust_tpu_torch/_build/native/`` (ignored by git; the CUDA
kernels' libraries beside it are named ``lib<kernel>-<hash>.so`` and never
collide with it), named by a hash of the source, the flags and the host
CPU, so an edited source or another CPU rebuilds.

Usage: ``python -m text_crdt_rust_tpu_torch.native.build``, or import
``text_crdt_rust_tpu_torch.models.native`` (it builds on first use).
"""
from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "tcr_engine.cpp")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build", "native")
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
         "-fno-exceptions", "-fno-rtti")


def _cpu_tag() -> str:
    """The host CPU's model and feature flags (``-march=native`` code may
    not run on another CPU), or the machine type where that is unknown."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f
                     if ln.startswith(("model name", "flags"))][:2]
        return "".join(lines) or platform.machine()
    except OSError:
        return platform.machine()


def _src_hash() -> str:
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    h.update(_cpu_tag().encode())
    return h.hexdigest()[:16]


def lib_path() -> str:
    return os.path.join(BUILD_DIR, f"libtcr_{_src_hash()}.so")


def build(verbose: bool = False) -> str:
    """Compile (if needed) and return the shared library's path."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Compile to a temporary path and rename it into place, so that a
    # concurrent build never leaves a partly written library to load.
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = ["g++", *FLAGS, SRC, "-o", tmp]
    if verbose:
        print(" ".join(cmd), file=sys.stderr)
    subprocess.run(cmd, check=True)
    os.rename(tmp, out)
    return out


if __name__ == "__main__":
    print(build(verbose=True))
