"""Builds the package's CUDA sources with nvcc at first use; loads them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled for Hopper
into ``_build/lib<name>_<digest>.so`` inside the package (``.gitignore``
lists the directory), where ``<digest>`` hashes the source and the flags, so
a changed source is rebuilt and a stale library is never loaded. The
compiler's report (registers, shared memory and spills per kernel, from
``-Xptxas -v``) is kept beside the library. A failed build raises; there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -split-compile 0: the kernels of a source (a template instance per dtype) are
# optimised on all cores at once, which cuts a build to a third
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-split-compile", "0",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): cannot build the CUDA kernels")


def library_path(name: str) -> Path:
    """Path of the built library of ``csrc/<name>.cu`` (built or not)."""
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned an error code."""
    if code != 0:
        lib.mvs_error_string.restype = ctypes.c_char_p
        lib.mvs_error_string.argtypes = [ctypes.c_int]
        msg = lib.mvs_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (code {code})")
