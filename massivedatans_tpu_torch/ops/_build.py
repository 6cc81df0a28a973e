"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources are compiled on first use with ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` — no PyTorch headers are
included, so a build takes seconds rather than minutes. The library lands in
``massivedatans_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded. Nothing here runs at import time: the tests import this module
on hosts that have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("neighbors.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of massivedatans_tpu_torch/csrc cannot be built"
    )


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libmdt_kernels_{h.hexdigest()[:16]}.so")


def _compile(out_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name, then rename: concurrent processes never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            "nvcc failed (%d):\n%s\n%s" % (proc.returncode, " ".join(cmd),
                                           proc.stdout + proc.stderr)
        )
    os.replace(tmp, out_path)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mdt_count_within.argtypes = [p, i, p, p, i, i, p, p, p]
    lib.mdt_count_within.restype = i
    lib.mdt_bootstrap_radius.argtypes = [p, p, p, i, i, i, p, p]
    lib.mdt_bootstrap_radius.restype = i


def load() -> ctypes.CDLL:
    """The kernel library, compiled first if this source hash is unbuilt."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
    return _lib
