"""ctypes bindings for the native host runtime (counterpart of
``prost_tpu/_native/host.py``; source ``src/prost_host.cpp``).

The library is compiled with ``g++ -O3`` at first use into
``prost_tpu_torch/_build/`` (ignored by git), named by the hash of its
source and flags so that a stale build is never loaded.  One process builds
at a time (a file lock beside the library: test workers import the package
together); the library is written to a private name and then renamed, so
no process loads a half-written file.  Without a toolchain every entry
point falls back to its numpy version: this is problem assembly on the
host, not a device path.  ``available()`` says which of the two runs.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "prost_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# no -march=native: a library built on one host stays loadable on another
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None
_tried = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libprost_host-{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    """Compile the library to ``path`` unless another process has; False
    when g++ is missing or fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libprost_host.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return True
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return False
        os.replace(tmp, path)
        return True


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.ph_coo_sort_perm.argtypes = [ctypes.c_int64, _i32p, _i32p, _i64p]
        lib.ph_coo_sort_perm.restype = None
        lib.ph_check_prox_domain.argtypes = [
            ctypes.c_int64, _i64p, _i64p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ph_check_prox_domain.restype = ctypes.c_int32
        lib.ph_prox_gaps.argtypes = [
            ctypes.c_int64, _i64p, _i64p, ctypes.c_int64, _i64p, _i64p,
        ]
        lib.ph_prox_gaps.restype = ctypes.c_int64
        lib.ph_check_block_overlap.argtypes = [
            ctypes.c_int64, _i64p, _i64p, _i64p, _i64p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ph_check_block_overlap.restype = ctypes.c_int32
        lib.ph_csr_to_csc.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            _i64p, _i32p, _f64p, _i64p, _i32p, _f64p,
        ]
        lib.ph_csr_to_csc.restype = None
        lib.ph_csr_matvec.argtypes = [
            ctypes.c_int64, _i64p, _i32p, _f64p, _f64p, _f64p,
        ]
        lib.ph_csr_matvec.restype = None
        lib.ph_csr_row_alpha_sum.argtypes = [
            ctypes.c_int64, _i64p, _f64p, ctypes.c_double, _f64p,
        ]
        lib.ph_csr_row_alpha_sum.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built and loaded, False when the
    numpy versions run."""
    return _load() is not None


# ---------------------------------------------------------------------------
# public API: native, with the numpy version when the library is missing
# ---------------------------------------------------------------------------

def coo_sort_perm(key1, key2):
    """Permutation sorting COO entries lexicographically by (key1, key2)."""
    key1 = np.ascontiguousarray(key1, np.int32)
    key2 = np.ascontiguousarray(key2, np.int32)
    lib = _load()
    if lib is None:
        return np.lexsort((key2, key1))
    perm = np.empty(key1.size, np.int64)
    lib.ph_coo_sort_perm(key1.size, key1, key2, perm)
    return perm


def check_prox_domain(indices, sizes, total):
    """Returns None if [0, total) is tiled exactly, else the offending
    (a, b) indices (b = -1 for a boundary error)."""
    indices = np.ascontiguousarray(indices, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    lib = _load()
    if lib is None:
        order = np.argsort(indices, kind="stable")
        pos = 0
        for k, i in enumerate(order):
            if indices[i] != pos:
                prev = order[k - 1] if k else -1
                return (int(prev), int(i)) if k else (int(i), -1)
            pos += sizes[i]
        return None if pos == total else (int(order[-1]), -1)
    a = ctypes.c_int64(0)
    b = ctypes.c_int64(0)
    bad = lib.ph_check_prox_domain(indices.size, indices, sizes, total,
                                   ctypes.byref(a), ctypes.byref(b))
    return (a.value, b.value) if bad else None


def prox_gaps(indices, sizes, total):
    """Uncovered (start, size) ranges; raises ValueError on overlap."""
    indices = np.ascontiguousarray(indices, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    lib = _load()
    if lib is None:
        order = np.argsort(indices, kind="stable")
        gaps, pos = [], 0
        for i in order:
            if indices[i] < pos:
                raise ValueError("prox ranges overlap")
            if indices[i] > pos:
                gaps.append((pos, int(indices[i] - pos)))
            pos = int(indices[i] + sizes[i])
        if pos < total:
            gaps.append((pos, int(total - pos)))
        return gaps
    gs = np.empty(indices.size + 1, np.int64)
    gz = np.empty(indices.size + 1, np.int64)
    n = lib.ph_prox_gaps(indices.size, indices, sizes, total, gs, gz)
    if n < 0:
        raise ValueError("prox ranges overlap")
    return [(int(gs[i]), int(gz[i])) for i in range(n)]


def check_block_overlap(rows, cols, nrows, ncols):
    """Returns None if block rectangles are pairwise disjoint, else the
    offending (a, b) pair."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    nrows = np.ascontiguousarray(nrows, np.int64)
    ncols = np.ascontiguousarray(ncols, np.int64)
    lib = _load()
    if lib is None:
        n = rows.size
        for i in range(n):
            for j in range(i + 1, n):
                if (cols[i] < cols[j] + ncols[j]
                        and cols[j] < cols[i] + ncols[i]
                        and rows[i] < rows[j] + nrows[j]
                        and rows[j] < rows[i] + nrows[i]):
                    return (i, j)
        return None
    a = ctypes.c_int64(0)
    b = ctypes.c_int64(0)
    bad = lib.ph_check_block_overlap(rows.size, rows, cols, nrows, ncols,
                                     ctypes.byref(a), ctypes.byref(b))
    return (a.value, b.value) if bad else None


def csr_to_csc(nrows, ncols, indptr, indices, values):
    """CSR -> CSC (csr2csc analog).  Returns (col_ptr, row_ind, vals_t)."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    values = np.ascontiguousarray(values, np.float64)
    nnz = values.size
    lib = _load()
    if lib is None:
        import scipy.sparse as sp

        m = sp.csr_matrix((values, indices, indptr),
                          shape=(nrows, ncols)).tocsc()
        return (m.indptr.astype(np.int64), m.indices.astype(np.int32),
                m.data)
    col_ptr = np.empty(ncols + 1, np.int64)
    row_ind = np.empty(nnz, np.int32)
    vals_t = np.empty(nnz, np.float64)
    lib.ph_csr_to_csc(nrows, ncols, nnz, indptr, indices, values,
                      col_ptr, row_ind, vals_t)
    return col_ptr, row_ind, vals_t


def csr_matvec(nrows, indptr, indices, values, x):
    """Multithreaded host CSR matvec (assembly-time oracle / sums)."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    values = np.ascontiguousarray(values, np.float64)
    x = np.ascontiguousarray(x, np.float64)
    lib = _load()
    if lib is None:
        y = np.zeros(nrows)
        np.add.at(y, np.repeat(np.arange(nrows), np.diff(indptr)),
                  values * x[indices])
        return y
    y = np.empty(nrows, np.float64)
    lib.ph_csr_matvec(nrows, indptr, indices, values, x, y)
    return y


def csr_row_alpha_sum(nrows, indptr, values, alpha):
    """Per-row sum_j |A_ij|^alpha of a CSR matrix."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    values = np.ascontiguousarray(values, np.float64)
    lib = _load()
    if lib is None:
        out = np.zeros(nrows)
        np.add.at(out, np.repeat(np.arange(nrows), np.diff(indptr)),
                  np.abs(values) ** alpha)
        return out
    out = np.empty(nrows, np.float64)
    lib.ph_csr_row_alpha_sum(nrows, indptr, values, float(alpha), out)
    return out
