"""Build a CUDA source into a shared library with ``nvcc`` and load it.

The kernels have a plain C interface and are bound with ``ctypes``, so the
build needs no PyTorch headers and takes seconds. A library is built at its
first use, from the repository's sources only, into ``kernels/_build/`` (git
ignores it), under a name that hashes the sources and flags: an edited source
builds anew, an unchanged one loads the library already there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parent / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``
    (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.access(candidate, os.X_OK):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build(name: str, sources: Sequence[Path]) -> Path:
    """Compile ``sources`` into ``_build/lib<name>-<hash>.so``; return it.

    The compiler's report (``-Xptxas -v``: registers, shared memory and
    spills of each kernel) is kept beside it as ``lib<name>-<hash>.log``."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent builder of the
    # same sources never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def load(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``sources``."""
    return ctypes.CDLL(str(build(name, sources)))
