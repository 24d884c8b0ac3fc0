"""Build the port's CUDA kernels into one shared library at first use.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), and the objects are linked into
``build/piqp_tpu_torch/libpiqp_kernels.so`` beside the package.  The library
is rebuilt when the sources, the headers they include (``csrc/*.cuh``) or
the flags change (a SHA-256 of all three is kept next to it), so a fresh
checkout builds everything on its first kernel launch.  The kernels have
plain C interfaces and are bound with ctypes.  The host library of
``_native.py`` (``csrc/*.cpp``) is built apart from these, with ``g++``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
BUILD_DIR = _PKG.parent / "build" / "piqp_tpu_torch"
LIB_PATH = BUILD_DIR / "libpiqp_kernels.so"
HASH_PATH = BUILD_DIR / "libpiqp_kernels.sha256"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# (name, argtypes) of every C entry point the library exports
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ENTRY_POINTS = {
    "piqp_chol_inv_resident_f32": (_PTR, _PTR, _PTR, _INT, _INT, _PTR),
    "piqp_chol_inv_resident_f64": (_PTR, _PTR, _PTR, _INT, _INT, _PTR),
    "piqp_chol_inv_cluster_f32": (_PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR),
    "piqp_chol_inv_cluster_f64": (_PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR),
    "piqp_chol_inv_apply_product_f32": (_PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR),
    "piqp_chol_inv_apply_product_f64": (_PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR),
    "piqp_chol_inv_apply_resident_f32": (_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR),
    "piqp_chol_inv_apply_resident_f64": (_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR),
    "piqp_chol_inv_apply_small_f32": (_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR),
    "piqp_chol_inv_apply_small_f64": (_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR),
    "piqp_signed_chol_inv_resident_f32": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR),
    "piqp_signed_chol_inv_resident_f64": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR),
    "piqp_ruiz_norms_dense_f32": (_PTR, _PTR, _PTR),
    "piqp_ruiz_norms_dense_f64": (_PTR, _PTR, _PTR),
    "piqp_ruiz_norms_stage_f32": (_PTR, _PTR, _PTR),
    "piqp_ruiz_norms_stage_f64": (_PTR, _PTR, _PTR),
    "piqp_ruiz_step_f32": (_PTR, _PTR, _PTR),
    "piqp_ruiz_step_f64": (_PTR, _PTR, _PTR),
    "piqp_ruiz_scale_dense_f32": (_PTR, _PTR, _PTR),
    "piqp_ruiz_scale_dense_f64": (_PTR, _PTR, _PTR),
    "piqp_ruiz_scale_stage_f32": (_PTR, _PTR, _PTR),
    "piqp_ruiz_scale_stage_f64": (_PTR, _PTR, _PTR),
}


class BuildInfo:
    """What the last ``library()`` call did: seconds spent in nvcc (0.0 when
    an up-to-date library was loaded) and nvcc's output (register and
    shared-memory use per kernel, from ``-Xptxas -v``)."""

    seconds: float | None = None
    log: str = ""


_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels of piqp_tpu_torch are built from source at first use"
        )
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _build(digest: str) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"--- nvcc {src.name}\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"{LIB_PATH.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", *objs, "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, LIB_PATH)
    HASH_PATH.write_text(digest)
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = "\n".join(log)


def library() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    digest = _digest()
    fresh = (
        LIB_PATH.exists()
        and HASH_PATH.exists()
        and HASH_PATH.read_text().strip() == digest
    )
    if fresh:
        BuildInfo.seconds = 0.0
    else:
        _build(digest)
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
