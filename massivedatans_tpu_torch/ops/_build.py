"""Build and load the native libraries of ``csrc/``.

Two libraries, each compiled on first use into a shared library with a
plain C interface and loaded with ``ctypes``:

- the CUDA kernels (``neighbors.cu``), by ``nvcc`` for ``sm_90a``, on the
  card's machine: ``load()``;
- the host union-find of the subset decomposition (``unionfind.cpp``), by
  the host C++ compiler: ``load_host()``.

No PyTorch headers are included, so a build takes seconds rather than
minutes. A library lands in ``massivedatans_tpu_torch/_build/`` under a name
that carries a hash of its sources and flags, so an edited source is rebuilt
and a stale library is never loaded. Nothing here runs at import time: the
tests import this module on hosts that have no CUDA toolkit.
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
HOST_SOURCES = ("unionfind.cpp",)
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_host_lib = None


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


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        cand = name and shutil.which(name)
        if cand:
            return cand
    raise RuntimeError("no host C++ compiler found ($CXX, c++, g++, clang++)")


def _path(stem: str, flags, sources) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sources:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def library_path() -> str:
    return _path("libmdt_kernels", NVCC_FLAGS, SOURCES)


def host_library_path() -> str:
    return _path("libmdt_host", HOST_FLAGS, HOST_SOURCES)


def _compile(compiler: str, flags, sources, out_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name, then rename: concurrent processes never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp,
           *(os.path.join(CSRC_DIR, s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            "build failed (%d):\n%s\n%s" % (proc.returncode, " ".join(cmd),
                                            proc.stdout + proc.stderr)
        )
    os.replace(tmp, out_path)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mdt_count_within.argtypes = [p, i, p, p, i, i, p, p, p]
    lib.mdt_count_within.restype = i
    lib.mdt_bootstrap_radius.argtypes = [p, p, p, i, i, i, p, p, p]
    lib.mdt_bootstrap_radius.restype = i


def load() -> ctypes.CDLL:
    """The kernel library, compiled first if this source hash is unbuilt."""
    global _lib
    if _lib is not None:  # the launchers' hot path: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(_nvcc(), NVCC_FLAGS, SOURCES, path)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
    return _lib


def load_host() -> ctypes.CDLL:
    """The host library (union-find), compiled first if unbuilt. Its
    functions' argument types are declared by the caller."""
    global _host_lib
    with _lock:
        if _host_lib is None:
            path = host_library_path()
            if not os.path.exists(path):
                _compile(_cxx(), HOST_FLAGS, HOST_SOURCES, path)
            _host_lib = ctypes.CDLL(path)
    return _host_lib
