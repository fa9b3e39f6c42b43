"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface.  On first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``prost_tpu_torch/_build/`` (ignored by git), named by the hash of its
source, of the ``csrc`` headers it includes (``#include "x.cuh"``, followed
recursively) and of the flags, so a stale build is never loaded, and
loaded with ``ctypes``.  ``load`` holds no lock while ``nvcc`` runs, so
threads can build several libraries at once.
Nothing here runs when the package is imported, and nothing falls back:
a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

from ..config import ProstError

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no multiply-add contraction: each expression rounds where the plain
    # PyTorch version of the kernel rounds
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class CudaLibrary:
    """A built kernel library: the ctypes handle, the build's wall time in
    seconds (0.0 when an earlier process had built it) and the compiler's
    report (registers, shared memory, spills per kernel)."""

    def __init__(self, lib, seconds: float, log: str, path: str):
        self.lib = lib
        self.seconds = seconds
        self.log = log
        self.path = path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_digest(name: str, csrc: str = CSRC) -> str:
    """Hash of ``<csrc>/<name>.cu``, the headers it includes from ``csrc``
    (each once, in the order first met) and the nvcc flags."""
    h = hashlib.sha256()
    todo, seen = [f"{name}.cu"], set()
    while todo:
        fname = todo.pop(0)
        if fname in seen:
            continue
        seen.add(fname)
        with open(os.path.join(csrc, fname), "rb") as fh:
            text = fh.read()
        h.update(fname.encode() + b"\0" + text)
        todo += [m.decode() for m in _INCLUDE.findall(text)]
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


_lock = threading.Lock()
_loaded: dict[str, CudaLibrary] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise ProstError("nvcc not found: the CUDA kernels cannot be built.")


def load(name: str) -> CudaLibrary:
    """Build (once per source version) and load ``csrc/<name>.cu``."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
    src = os.path.join(CSRC, f"{name}.cu")
    digest = source_digest(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    log_path = path[:-3] + ".log"
    seconds = 0.0
    if not os.path.exists(path):
        # build to a private name, then rename: concurrent builds
        # (threads, test workers) never load a half-written library
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise ProstError(f"nvcc failed on {src}:\n{proc.stderr}")
        with open(log_path, "w") as fh:
            fh.write(proc.stderr)
        os.replace(tmp, path)
    log = ""
    if os.path.exists(log_path):
        with open(log_path) as fh:
            log = fh.read()
    built = CudaLibrary(ctypes.CDLL(path), seconds, log, path)
    with _lock:
        return _loaded.setdefault(name, built)
