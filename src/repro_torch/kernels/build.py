"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface, so it compiles with ``nvcc``
alone, in seconds, into ``build/repro_torch/lib<name>-<hash>.so`` under the
checkout (git-ignored).  The hash covers the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.  All sources
are compiled in parallel, one ``nvcc`` each, the first time any of them is
needed.  ``nvcc`` runs with ``-Xptxas -v``; its report of registers, shared
memory and spills is kept beside the library (``build_logs``).

Nothing here runs at import: the CPU tests import every module of the port
on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("quantize", "pack", "ssd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()


def build_dir() -> Path:
    """``<checkout>/build/repro_torch`` (this file is
    ``<checkout>/src/repro_torch/kernels/build.py``)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise FileNotFoundError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built")


def _stem(name: str) -> str:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return f"{name}-{h.hexdigest()[:12]}"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel;
    returns {name: library path}.  Raises if any compile fails."""
    with _lock:
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        libs = {n: out / f"lib{_stem(n)}.so" for n in SOURCES}
        todo = [n for n in SOURCES if not libs[n].exists()]
        if not todo:
            return libs
        nvcc = find_nvcc()
        procs = {}
        for n in todo:
            tmp = libs[n].with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        errors = []
        for n, (tmp, p) in procs.items():
            log, _ = p.communicate()
            (out / f"{_stem(n)}.log").write_text(log)
            if p.returncode != 0:
                errors.append(f"nvcc failed on {n}.cu (rc {p.returncode}):\n{log}")
            else:
                os.replace(tmp, libs[n])
        if errors:
            raise RuntimeError("\n".join(errors))
        return libs


def build_logs() -> dict[str, str]:
    """The ``nvcc -Xptxas -v`` report of each built source."""
    build_all()
    return {n: (build_dir() / f"{_stem(n)}.log").read_text() for n in SOURCES}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (building all sources first)."""
    return ctypes.CDLL(str(build_all()[name]))
