"""Build, load and count the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface and is compiled
by ``nvcc`` into its own shared library under the package's ``_build/``
directory, named by a hash of the source and of the shared headers
(``ops/csrc/*.cuh``) it includes, so an edited kernel is rebuilt.
The libraries are loaded with ``ctypes``; pointers and the CUDA stream
pass as ``c_void_p``. Nothing is built when this module is imported: a
kernel is built at its first launch, or by ``build()`` (all sources at
once, one ``nvcc`` process each, started together).

Every launch function returns ``cudaGetLastError()``; ``check`` raises on
anything but 0 (a refused launch never runs, and a later synchronise
would not report it). ``count_launch`` keeps one plain integer per
kernel, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
ARCH = "arch=compute_90a,code=sm_90a"

#: Launches per kernel name since the last ``reset_launches()``.
launches: Dict[str, int] = {}

_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> its CUDA source in the package."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc() -> str:
    """The ``nvcc`` on PATH, else the one under ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _headers(src: Path):
    """The shared headers (``csrc/*.cuh``) that ``src`` includes, directly
    or through another header, sorted."""
    seen, todo = set(), [src]
    while todo:
        text = todo.pop().read_text()
        for name in re.findall(r'^#include\s+"([^"]+\.cuh)"', text, re.M):
            hdr = CSRC / name
            if hdr not in seen and hdr.exists():
                seen.add(hdr)
                todo.append(hdr)
    return sorted(seen)


def _lib_path(src: Path) -> Path:
    """The library of ``src``, named by a hash of the source and of the
    shared headers it includes."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in _headers(src):
        h.update(hdr.read_bytes())
    return BUILD / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns each
    compiled kernel's ``ptxas`` report (registers, shared memory, spills).
    Raises with the compiler's output if any build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = srcs[name]
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(sources()[name])
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes):
    """Launch function ``symbol`` of kernel ``name``, typed. The returned
    callable refuses a wrong argument count: ctypes would pass surplus
    arguments untyped and shift every pointer after them."""
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int

    def call(*args):
        if len(args) != len(argtypes):
            raise TypeError(f"{symbol} takes {len(argtypes)} arguments, "
                            f"got {len(args)}")
        return fn(*args)

    return call


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = library(name).cuda_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def count_launch(name: str) -> None:
    launches[name] = launches.get(name, 0) + 1


def reset_launches() -> None:
    launches.clear()
