"""ctypes loader of the host library for multistage structure detection
and block scatter (``piqp_tpu/_native.py``).

Setup-time sparse analysis is scalar pointer-chasing work that belongs on
the host, as in the reference (multistage_kkt.hpp:420-818).  The port keeps
its own copy of the C++ source, ``csrc/structure.cpp``, and builds it with
``g++`` into ``build/piqp_tpu_torch/`` beside the CUDA library at first use
(rebuilt when the source changes).  A failed build raises: there is no
silent fallback.  The numpy functions below (``_detect_structure_np``,
``_scatter_P_np``, ``_scatter_constr_np``) are the plain versions the tests
hold the C++ against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .ops._build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "csrc" / "structure.cpp"
LIB_PATH = BUILD_DIR / "libpiqp_structure.so"
_HASH_PATH = BUILD_DIR / "libpiqp_structure.sha256"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None


def _build(digest: str) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(
            "no C++ compiler (g++ or c++) on PATH: piqp_tpu_torch builds its "
            "structure-detection library from csrc/structure.cpp at first use"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_PATH.name}.{os.getpid()}.tmp"
    out = subprocess.run(
        [cxx, *_FLAGS, str(_SRC), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if out.returncode != 0:
        raise RuntimeError(f"building {_SRC.name} failed:\n{out.stdout}")
    os.replace(tmp, LIB_PATH)
    _HASH_PATH.write_text(digest)


def library() -> ctypes.CDLL:
    """The structure library, built first if it is missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()
    fresh = (LIB_PATH.exists() and _HASH_PATH.exists()
             and _HASH_PATH.read_text().strip() == digest)
    if not fresh:
        _build(digest)
    lib = ctypes.CDLL(str(LIB_PATH))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    I = ctypes.c_int64  # noqa: E741
    lib.piqp_tpu_detect_structure.restype = I
    lib.piqp_tpu_detect_structure.argtypes = [
        I, i64p, i64p, I, u8p, i64p, i64p, ctypes.POINTER(I), ctypes.POINTER(I),
    ]
    lib.piqp_tpu_scatter_P.restype = I
    lib.piqp_tpu_scatter_P.argtypes = [
        I, i64p, i64p, f64p, i64p, i64p, I, I, I, f64p, f64p, f64p, f64p,
    ]
    lib.piqp_tpu_scatter_constr.restype = I
    lib.piqp_tpu_scatter_constr.argtypes = [
        I, I, i64p, i64p, f64p, i64p, i64p, i64p, i64p, I, I, I, I, f64p, f64p, f64p,
    ]
    _lib = lib
    return lib


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def detect_structure(indptr, indices, n, band_cap: int = 0):
    """Arrow columns and the block-tridiagonal partition of a symmetric
    sparsity pattern (CSC).  Returns (is_arrow bool[n], starts, sizes)."""
    lib = library()
    is_arrow = np.zeros(n, np.uint8)
    starts = np.zeros(max(n, 1), np.int64)
    sizes = np.zeros(max(n, 1), np.int64)
    nb = ctypes.c_int64(0)
    aw = ctypes.c_int64(0)
    rc = lib.piqp_tpu_detect_structure(
        n, _i64(indptr), _i64(indices), band_cap, is_arrow, starts, sizes,
        ctypes.byref(nb), ctypes.byref(aw),
    )
    if rc != 0:
        raise RuntimeError(f"piqp_tpu_detect_structure returned {rc}")
    nb = nb.value
    return is_arrow.astype(bool), starts[:nb].copy(), sizes[:nb].copy()


def _detect_structure_np(indptr, indices, n, band_cap=0):
    """Plain numpy version of ``detect_structure`` (the same algorithm as
    csrc/structure.cpp)."""
    indptr, indices = _i64(indptr), _i64(indices)
    if n == 0:
        return np.zeros(0, bool), np.zeros(0, np.int64), np.zeros(0, np.int64)
    cols = np.repeat(np.arange(n), np.diff(indptr))
    rows = indices
    off = rows != cols
    lo = np.minimum(rows, cols)[off]
    hi = np.maximum(rows, cols)[off]
    d = hi - lo
    if band_cap <= 0:
        med = int(np.median(d)) if d.size else 0
        band_cap = max(32, 4 * med)
    # greedy vertex cover of long-range edges
    long = d > band_cap
    llo, lhi = lo[long], hi[long]
    is_arrow = np.zeros(n, bool)
    covered = np.zeros(len(llo), bool)
    while not covered.all():
        cnt = np.bincount(
            np.concatenate([llo[~covered], lhi[~covered]]), minlength=n
        )
        cnt[is_arrow] = 0
        best = int(np.argmax(cnt))
        if cnt[best] == 0:
            break
        is_arrow[best] = True
        covered |= (llo == best) | (lhi == best)

    keep = ~is_arrow
    newidx = np.full(n, -1, np.int64)
    newidx[keep] = np.arange(keep.sum())
    nr = int(keep.sum())
    minc_r = np.arange(nr)
    sel = keep[lo] & keep[hi] & (lo != hi)
    np.minimum.at(minc_r, newidx[hi[sel]], newidx[lo[sel]])

    sufmin = np.empty(nr + 1, np.int64)
    sufmin[nr] = nr
    for i in range(nr - 1, -1, -1):
        sufmin[i] = min(minc_r[i], sufmin[i + 1])

    starts, sizes = [], []
    s = 0
    while s < nr:
        e = s + 1
        while e < nr and sufmin[e] < s:
            e += 1
        starts.append(s)
        sizes.append(e - s)
        s = e
    return is_arrow, np.asarray(starts, np.int64), np.asarray(sizes, np.int64)


def _scatter_args(indptr, indices, values, var_stage, var_off):
    return (_i64(indptr), _i64(indices), np.ascontiguousarray(values, np.float64),
            _i64(var_stage), _i64(var_off))


def scatter_P(indptr, indices, values, var_stage, var_off, T, D, Da):
    """Scatter a symmetric CSC P (upper or full) into padded stage blocks
    (Pd, Psub, Pa, Pc)."""
    n = len(indptr) - 1
    Pd = np.zeros((T, D, D))
    Psub = np.zeros((T, D, D))
    Pa = np.zeros((T, Da, D))
    Pc = np.zeros((Da, Da))
    args = _scatter_args(indptr, indices, values, var_stage, var_off)
    rc = library().piqp_tpu_scatter_P(n, *args, T, D, Da, Pd, Psub, Pa, Pc)
    if rc != 0:
        raise ValueError("P couples non-adjacent stages")
    return Pd, Psub, Pa, Pc


def _scatter_P_np(indptr, indices, values, var_stage, var_off, T, D, Da):
    """Plain numpy version of ``scatter_P``."""
    n = len(indptr) - 1
    Pd = np.zeros((T, D, D))
    Psub = np.zeros((T, D, D))
    Pa = np.zeros((T, Da, D))
    Pc = np.zeros((Da, Da))
    for j in range(n):
        for k in range(indptr[j], indptr[j + 1]):
            i = indices[k]
            if i < j:
                continue  # full symmetric input: lower triangle + mirror
            v = values[k]
            sr, sc = var_stage[i], var_stage[j]
            orow, ocol = var_off[i], var_off[j]
            if sr < 0 and sc < 0:
                Pc[orow, ocol] += v
                if i != j:
                    Pc[ocol, orow] += v
            elif sr < 0:
                Pa[sc, orow, ocol] += v
            elif sc < 0:
                Pa[sr, ocol, orow] += v
            elif sr == sc:
                Pd[sr, orow, ocol] += v
                if i != j:
                    Pd[sr, ocol, orow] += v
            elif sr == sc + 1:
                Psub[sc, orow, ocol] += v
            else:
                raise ValueError("P couples non-adjacent stages")
    return Pd, Psub, Pa, Pc


def scatter_constr(csr_indptr, csr_indices, csr_values, var_stage, var_off,
                   row_bucket, row_slot, T, rmax, D, Da):
    """Scatter the CSR rows of a constraint matrix into the stage buckets
    (M1, M2, Mg) of ``multistage.StageQPData``."""
    rows = len(csr_indptr) - 1
    M1 = np.zeros((T, rmax, D))
    M2 = np.zeros((T, rmax, D))
    Mg = np.zeros((T, rmax, Da))
    args = _scatter_args(csr_indptr, csr_indices, csr_values, var_stage, var_off)
    rc = library().piqp_tpu_scatter_constr(
        rows, len(var_stage), *args, _i64(row_bucket), _i64(row_slot),
        T, rmax, D, Da, M1, M2, Mg,
    )
    if rc != 0:
        raise ValueError("constraint row spans non-adjacent stages")
    return M1, M2, Mg


def _scatter_constr_np(csr_indptr, csr_indices, csr_values, var_stage, var_off,
                       row_bucket, row_slot, T, rmax, D, Da):
    """Plain numpy version of ``scatter_constr``."""
    M1 = np.zeros((T, rmax, D))
    M2 = np.zeros((T, rmax, D))
    Mg = np.zeros((T, rmax, Da))
    for r in range(len(csr_indptr) - 1):
        bk, slot = row_bucket[r], row_slot[r]
        for k in range(csr_indptr[r], csr_indptr[r + 1]):
            c = csr_indices[k]
            v = csr_values[k]
            sc, oc = var_stage[c], var_off[c]
            if sc < 0:
                Mg[bk, slot, oc] += v
            elif sc == bk:
                M1[bk, slot, oc] += v
            elif sc == bk + 1:
                M2[bk, slot, oc] += v
            else:
                raise ValueError("constraint row spans non-adjacent stages")
    return M1, M2, Mg
