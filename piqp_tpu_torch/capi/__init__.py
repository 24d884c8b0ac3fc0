"""The port's C interface: ``piqp_tpu_torch_c.h`` (the same contract as the
JAX package's ``csrc/piqp_tpu_c.h`` plus ``piqp_tpu_set_device``),
``capi.cpp`` (a library that embeds CPython and drives ``DenseSolver`` /
``SparseSolver``), ``build_capi.sh`` and the C driver ``test_capi.c``.

    sh piqp_tpu_torch/capi/build_capi.sh [outdir]

builds ``libpiqp_tpu_torch_c.so`` and ``test_capi`` into ``outdir``
(``build/piqp_tpu_torch/capi/`` by default).  This module is the Python
side of the library: ``capi.cpp`` maps its settings struct through
``settings_from_fields`` and reads every solve's result through
``pack_result``.  ``write_problem`` and ``read_run`` write and read the
files of ``test_capi``'s file-driven mode, and ``run_files`` makes the
same calls through the Python entry points, the control of the C
library's timings.
"""

from __future__ import annotations

import os
import statistics
import time

import numpy as np
import scipy.sparse as sp
import torch

from .. import DenseSolver, KKTBackend, Settings, SparseSolver


def pack_result(result, vectors, info_fields) -> np.ndarray:
    """The named vectors of one problem's ``result`` and the named fields
    of its info, in that order, flattened into one float64 host array.

    A result on the card is read back with one device-to-host copy: the
    pieces are cast to the result's dtype and concatenated on the device,
    copied, then widened to float64 on the host.  The host sparse route's
    result is numpy already.  A missing field raises AttributeError."""
    vecs = [getattr(result, k) for k in vectors]
    info = [getattr(result.info, k) for k in info_fields]
    if not isinstance(vecs[0], torch.Tensor):
        return np.concatenate([np.ravel(np.asarray(v, np.float64)) for v in vecs]
                              + [np.asarray(info, np.float64)])
    dtype = vecs[0].dtype
    flat = torch.cat([v.reshape(-1).to(dtype) for v in vecs]
                     + [torch.stack([f.reshape(()).to(dtype) for f in info])])
    return flat.cpu().to(torch.float64).numpy()


def write_problem(directory, prob: dict, sparse: bool = False, c_update=None,
                  runs: dict | None = None) -> tuple:
    """Write one problem (a dict of P, c, A, b, G, h_l, h_u, x_l, x_u as in
    ``DenseSolver.setup``; absent keys or None pass NULL) and the runs of
    ``test_capi``'s file-driven mode into ``directory``: raw float64
    row-major arrays, or CSC arrays (int32 pointers and indices) when
    ``sparse``.  ``runs`` maps a run's name to the ``piqp_tpu_settings``
    fields it sets (and ``repeat``, the count of repeated cold solves to
    time).  Returns (n, p, m)."""
    os.makedirs(directory, exist_ok=True)

    def put(name, arr, dtype):
        np.ascontiguousarray(arr, dtype=dtype).tofile(os.path.join(directory, name))

    n = np.shape(prob["P"])[0]
    p = 0 if prob.get("A") is None else np.shape(prob["A"])[0]
    m = 0 if prob.get("G") is None else np.shape(prob["G"])[0]
    for k in ("P", "A", "G"):
        M = prob.get(k)
        if M is None:
            continue
        if sparse:
            M = sp.csc_matrix(M)
            M.sort_indices()
            put(f"{k}.p.i32", M.indptr, np.int32)
            put(f"{k}.i.i32", M.indices, np.int32)
            put(f"{k}.x.f64", M.data, np.float64)
        else:
            put(f"{k}.f64", M.toarray() if sp.issparse(M) else M, np.float64)
    for k in ("c", "b", "h_l", "h_u", "x_l", "x_u"):
        if prob.get(k) is not None:
            put(f"{k}.f64", prob[k], np.float64)
    if c_update is not None:
        put("c_update.f64", c_update, np.float64)
    with open(os.path.join(directory, "problem.txt"), "w") as f:
        f.write(f"{'sparse' if sparse else 'dense'} {n} {p} {m}\n")
    with open(os.path.join(directory, "runs.txt"), "w") as f:
        for name, fields in (runs or {}).items():
            f.write(" ".join([name] + [f"{k}={v}" for k, v in fields.items()]) + "\n")
    return n, p, m


def read_run(directory, name: str, n: int, p: int, m: int) -> dict:
    """What ``test_capi``'s file-driven mode wrote for run ``name``: the
    cold and (when it ran) warm solves' x, y, z_l, z_u, z_bl, z_bu
    (``"cold"``, ``"warm"``), their status and iterations, and the seconds
    of setup, solve, update, warm solve and the median repeated solve."""
    def vectors(file):
        path = os.path.join(directory, file)
        if not os.path.exists(path):
            return None
        v = np.fromfile(path, dtype=np.float64)
        out, at = {}, 0
        for k, size in (("x", n), ("y", p), ("z_l", m), ("z_u", m), ("z_bl", n),
                        ("z_bu", n)):
            out[k] = v[at:at + size]
            at += size
        return out

    stats = np.fromfile(os.path.join(directory, f"{name}.status.i32"), dtype=np.int32)
    secs = np.fromfile(os.path.join(directory, f"{name}.seconds.f64"), dtype=np.float64)
    return dict(
        cold=vectors(f"{name}.result.f64"), warm=vectors(f"{name}.warm.result.f64"),
        status=int(stats[0]), iter=int(stats[1]), warm_status=int(stats[2]),
        warm_iter=int(stats[3]),
        seconds=dict(zip(("setup", "solve", "update", "warm_solve", "repeat_solve"),
                         secs.tolist())),
    )


# piqp_tpu_kkt_solver values of the C header, by their PIQP names
# (``KKTBackend.from_piqp`` maps those); AUTO is the condensed backend
_KKT_SOLVERS = {0: "dense_cholesky", 1: "sparse_ldlt", 2: "sparse_ldlt_eq_cond",
                3: "sparse_ldlt_ineq_cond", 4: "sparse_ldlt_cond", 5: "sparse_multistage",
                6: "dense_lu", 7: "dense_ldlt", -1: "dense_cholesky"}
# pallas_kernels: -1 (the default) and 1 the hand-written kernels, 0 the
# library factorizations
_PALLAS_KERNELS = {-1: None, 0: False, 1: True}


def settings_from_fields(fields: dict):
    """The ``Settings`` of these ``piqp_tpu_settings`` fields (name ->
    value, numbers or their text; the rest at their defaults): the one
    mapping of the C struct, which ``capi.cpp`` calls with every field.
    ``use_float32`` gives ``dtype``, ``pallas_kernels`` -1 / 0 / 1 gives
    None / False / True, a negative
    ``iterative_refinement_static_regularization_rel`` its default; a
    ``kkt_solver`` or ``pallas_kernels`` outside the header's values
    raises ValueError."""
    defaults, kw = Settings(), {}
    for name, value in fields.items():
        if name == "kkt_solver":
            if int(value) not in _KKT_SOLVERS:
                raise ValueError(f"kkt_solver {value} is not a piqp_tpu_kkt_solver value")
            kw[name] = KKTBackend.from_piqp(_KKT_SOLVERS[int(value)])
        elif name == "use_float32":
            kw["dtype"] = "float32" if int(value) else "float64"
        elif name == "pallas_kernels":
            if int(value) not in _PALLAS_KERNELS:
                raise ValueError(f"pallas_kernels must be -1 (the kernels), 0 (library "
                                 f"factorizations) or 1 (the kernels), got {value}")
            kw[name] = _PALLAS_KERNELS[int(value)]
        elif name == "iterative_refinement_static_regularization_rel":
            kw[name] = None if float(value) < 0 else float(value)
        elif isinstance(getattr(defaults, name), bool):
            kw[name] = bool(int(value))
        elif isinstance(getattr(defaults, name), int):
            kw[name] = int(value)
        else:
            kw[name] = float(value)
    return Settings(**kw)


def run_files(device, directories, prefix: str = "py-") -> int:
    """``test_capi``'s file-driven mode through the Python entry points in
    this process: the same runs on the same files, timed the same way,
    with every output file's name starting with ``prefix``.  The control
    for the C library's timings.  Returns 0."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)

    def timed(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t

    for directory in directories:
        with open(os.path.join(directory, "problem.txt")) as f:
            kind, n, p, m = f.read().split()
        n, p, m = int(n), int(p), int(m)

        def load(name, dtype=np.float64):
            path = os.path.join(directory, name)
            return np.fromfile(path, dtype=dtype) if os.path.exists(path) else None

        prob = {k: load(f"{k}.f64") for k in ("c", "b", "h_l", "h_u", "x_l", "x_u")}
        for k, rows in (("P", n), ("A", p), ("G", m)):
            if kind == "sparse":
                x = load(f"{k}.x.f64")
                prob[k] = None if x is None else sp.csc_matrix(
                    (x, load(f"{k}.i.i32", np.int32), load(f"{k}.p.i32", np.int32)),
                    shape=(rows, n))
            else:
                v = load(f"{k}.f64")
                prob[k] = None if v is None else v.reshape(rows, n)
        c2 = load("c_update.f64")
        with open(os.path.join(directory, "runs.txt")) as f:
            lines = [line.split() for line in f if line.strip()]
        for name, *assignments in lines:
            fields = dict(a.split("=", 1) for a in assignments)
            repeat = int(fields.pop("repeat", 0))
            cls = SparseSolver if kind == "sparse" else DenseSolver
            solver = cls(settings_from_fields(fields), device=device)
            _, setup_s = timed(lambda: solver.setup(**prob))
            status, solve_s = timed(solver.solve)
            stats, secs = [int(status), int(solver.result.info.iter), 0, 0], [setup_s, solve_s]

            def save(file):
                r = solver.result
                np.concatenate([np.asarray(torch.as_tensor(getattr(r, k)).double().cpu())
                                for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu")]).tofile(
                    os.path.join(directory, f"{prefix}{file}"))

            save(f"{name}.result.f64")
            repeat_s = statistics.median(timed(solver.solve)[1] for _ in range(repeat)) \
                if repeat else 0.0
            update_s = warm_s = 0.0
            if c2 is not None:
                _, update_s = timed(lambda: solver.update(c=c2))
                wstatus, warm_s = timed(lambda: solver.solve(warm_start=True))
                stats[2:] = [int(wstatus), int(solver.result.info.iter)]
                save(f"{name}.warm.result.f64")
            np.asarray(stats, np.int32).tofile(
                os.path.join(directory, f"{prefix}{name}.status.i32"))
            np.asarray(secs + [update_s, warm_s, repeat_s], np.float64).tofile(
                os.path.join(directory, f"{prefix}{name}.seconds.f64"))
            print(f"[{name}] status {stats[0]}, {stats[1]} iterations; warm {stats[2]}, "
                  f"{stats[3]} iterations; setup {setup_s:.6f} s, solve {solve_s:.6f} s, "
                  f"update {update_s:.6f} s, warm solve {warm_s:.6f} s, repeated solve "
                  f"{repeat_s:.6f} s")
    return 0
