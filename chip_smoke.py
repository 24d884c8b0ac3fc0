"""Chip smoke test of the PyTorch/CUDA port (piqp_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, then drives the
port's main path (a batched dense QP solve through the condensed-Cholesky
backend) at full width and checks what comes out.  Every phase raises on
failure, so any fault gives a nonzero exit code.  Without a CUDA device,
or without the package beside it, the script exits nonzero and prints no
result.

Phases:
  1. device and build: card name and power limit, versions, nvcc time;
  2. K1 (Cholesky with inverse) against its plain version, float32 and
     float64, at n in {8, 33, 64, 128, 200, 256} (B = 5) and at the main
     path's shape B = 1024, n = 128, with times and bounds;
  3. main path: 1024 problems dense_strongly_convex_qp(128, 64, 64,
     seed=1000+i) (the benchmarks/make_batch.py set), cold with
     mixed precision and one warm re-solve round, with K1 launch counts
     per dtype and a host-side KKT optimality check of every result;
  4. float64 batch (B = 64), one DenseSolver on the card, and the first 8
     problems run again on the CPU (plain versions), in float64 and with
     mixed precision;
  5. a profile of the warm round (kernel time by name, device busy share).
The line before the last lists the kernels as JSON; the last line is the
device summary.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks from NVIDIA's H100 data sheet (float32 and float64 rates
# outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

MAIN_B, MAIN_N, MAIN_P, MAIN_M = 1024, 128, 64, 64
K1_SHAPES = [(5, 8), (5, 33), (5, 64), (5, 128), (5, 200), (5, 256), (MAIN_B, MAIN_N)]
K1_TOL = {"float32": 5e-5, "float64": 1e-11}
OPT_TOL = 1e-6
# x of a mixed-precision solve on the CPU vs the card: the float32 phase
# takes different (equally optimal) trajectories on the two devices; on
# these problems the JAX package's own mixed run and the port's CPU run
# differ by up to 1.7e-5 in x
XCHECK_MIXED_TOL = 1e-4


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, repeats: int = 9) -> float:
    """Median of per-call CUDA-event times after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _spd_batch(torch, B, n, dtype, seed):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(-1, 1, (B, n, n))
    K = Q @ np.swapaxes(Q, 1, 2) + n * np.eye(n)
    return torch.as_tensor(K, dtype=dtype, device="cuda")


def _optimality(prob: dict, x, y, z_l, z_u, z_bl, z_bu) -> float:
    """Worst scaled violation of the KKT conditions of one solution on the
    original data, in float64 (tests/helpers.check_optimality's checks):
    primal feasibility, dual feasibility, stationarity, duality gap."""
    P = np.triu(prob["P"]) + np.triu(prob["P"], 1).T
    c, A, b, G = prob["c"], prob["A"], prob["b"], prob["G"].copy()
    h_l, h_u, x_l, x_u = prob["h_l"], prob["h_u"], prob["x_l"], prob["x_u"]
    inf = 1e30
    hl, hu, xl, xu = h_l > -inf, h_u < inf, x_l > -inf, x_u < inf
    G[~hl & ~hu] = 0.0
    scale = max(1.0, np.abs(x).max(initial=0.0))
    Gx = G @ x
    primal = max(
        np.abs(A @ x - b).max(initial=0.0),
        np.maximum(Gx[hu] - h_u[hu], 0).max(initial=0.0),
        np.maximum(h_l[hl] - Gx[hl], 0).max(initial=0.0),
        np.maximum(x[xu] - x_u[xu], 0).max(initial=0.0),
        np.maximum(x_l[xl] - x[xl], 0).max(initial=0.0),
    ) / scale
    dual = max(0.0, -min(z_l.min(initial=0), z_u.min(initial=0),
                         z_bl.min(initial=0), z_bu.min(initial=0)))
    grad = P @ x + c + A.T @ y + G.T @ (z_u - z_l) + z_bu - z_bl
    gscale = max(1.0, np.abs(P @ x).max(initial=0.0), np.abs(c).max(initial=0.0))
    primal_obj = 0.5 * x @ P @ x + c @ x
    dual_obj = (-0.5 * x @ P @ x - b @ y + np.where(hl, h_l, 0) @ z_l
                - np.where(hu, h_u, 0) @ z_u + np.where(xl, x_l, 0) @ z_bl
                - np.where(xu, x_u, 0) @ z_bu)
    gap = abs(primal_obj - dual_obj) / max(1.0, abs(primal_obj))
    return max(primal, dual, np.abs(grad).max() / gscale, gap)


def _check_round(problems, res, what: str) -> float:
    """All SOLVED and every solution optimal on the host; returns the worst
    violation."""
    status = res.info.status.cpu().numpy()
    if not np.all(status == 1):
        bad = np.nonzero(status != 1)[0]
        raise AssertionError(f"{what}: {bad.size} problems not SOLVED, e.g. "
                             f"{bad[:5].tolist()} -> {status[bad[:5]].tolist()}")
    host = {k: getattr(res, k).double().cpu().numpy()
            for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu")}
    worst = max(
        _optimality(prob, *(host[k][i] for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu")))
        for i, prob in enumerate(problems)
    )
    if not worst <= OPT_TOL:
        raise AssertionError(f"{what}: KKT violation {worst:.3e} > {OPT_TOL}")
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from piqp_tpu_torch import (
        DenseSolver, Settings, Status, prepare_batch, solve_batch, warm_from_result,
    )
    from piqp_tpu_torch.ops import _build, chol_inv
    from piqp_tpu_torch.types import index
    from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

    # ---- 1. device and build
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi}")
    print(f"[device] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 matmuls are enabled; the port needs full float32")
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] nvcc {_build.BuildInfo.seconds:.2f} s (load incl. "
          f"{time.perf_counter() - t0:.2f} s), library {_build.LIB_PATH.name}")
    print(_build.BuildInfo.log.strip())

    # ---- 2. K1 against its plain version on the card
    kernels = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        tol = K1_TOL[name]
        worst = 0.0
        for B, n in K1_SHAPES:
            K = _spd_batch(torch, B, n, dtype, seed=n)
            L, Linv = chol_inv.cholesky_with_inverse(K)
            torch.cuda.synchronize()
            L_ref, Linv_ref = chol_inv.chol_inv_reference(K)
            err_L = (L - L_ref).abs().max().item()
            eye = torch.eye(n, dtype=dtype, device="cuda")
            err_I = (L @ Linv - eye).abs().max().item()
            err_Li = (Linv - Linv_ref).abs().max().item()
            print(f"[K1 {name}] B={B} n={n}: |L-L_ref| {err_L:.3e} "
                  f"|Linv-Linv_ref| {err_Li:.3e} |L Linv - I| {err_I:.3e}")
            if not (err_L <= tol * max(1.0, L_ref.abs().max().item())
                    and err_I <= 50 * tol):
                raise AssertionError(f"K1 {name} B={B} n={n} disagrees with its plain version")
            worst = max(worst, err_L, err_Li)
        # one indefinite problem gives non-finite output for itself only
        K = _spd_batch(torch, 4, 40, dtype, seed=1)
        K[2, 7, 7] = -1e3
        L, Linv = chol_inv.cholesky_with_inverse(K)
        fin = (torch.isfinite(L).flatten(1).all(1) & torch.isfinite(Linv).flatten(1).all(1))
        if fin.tolist() != [True, True, False, True]:
            raise AssertionError(f"K1 {name}: indefinite input gave finite flags {fin.tolist()}")

        K = _spd_batch(torch, MAIN_B, MAIN_N, dtype, seed=7)
        before = chol_inv.launches
        ms = _time_ms(torch, lambda: chol_inv.cholesky_with_inverse(K))
        timing_launches = chol_inv.launches - before
        plain_ms = _time_ms(torch, lambda: chol_inv.chol_inv_reference(K), repeats=5)
        eye = torch.eye(MAIN_N, dtype=dtype, device="cuda").expand_as(K)

        def library():
            Lc = torch.linalg.cholesky(K)
            return torch.linalg.solve_triangular(Lc, eye, upper=False)

        library_ms = _time_ms(torch, library)
        elem = K.element_size()
        bytes_ms = 3 * MAIN_B * MAIN_N * MAIN_N * elem / HBM_BYTES_PER_S * 1e3
        flops_ms = MAIN_B * MAIN_N ** 3 / PEAK_FLOPS[name] * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        print(f"[K1 {name}] B={MAIN_B} n={MAIN_N}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {bound_ms * 1e3:.1f} us "
              f"({'bytes' if bytes_ms >= flops_ms else 'operations'}), "
              f"{timing_launches} timing launches; {smi}")
        kernels.append(dict(
            name=f"chol_inv_{name}", route="cuda",
            source="piqp_tpu_torch/csrc/chol_inv.cu",
            replaces="piqp_tpu/ops/pallas_chol.py:65",
            launches=None, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by="bytes" if bytes_ms >= flops_ms else "operations",
            library_ms=library_ms,
        ))

    # ---- 3. main path at full width: cold + one warm round, mixed precision
    problems = [
        dense_strongly_convex_qp(MAIN_N, MAIN_P, MAIN_M, seed=1000 + i)
        for i in range(MAIN_B)
    ]
    settings = Settings(mixed_precision=True)
    t0 = time.perf_counter()
    data = prepare_batch(problems)
    torch.cuda.synchronize()
    print(f"[main] prepared {MAIN_B} problems n={MAIN_N} p={MAIN_P} m={MAIN_M} "
          f"in {time.perf_counter() - t0:.2f} s")
    solve_batch(prepare_batch(problems[:2]), settings)  # warm-up: cuBLAS handles, allocator

    chol_inv.launches = 0
    for k in chol_inv.launches_by_dtype:
        chol_inv.launches_by_dtype[k] = 0
    round_launches = {}

    def run_round(label, data, warm=None):
        before = dict(chol_inv.launches_by_dtype)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = solve_batch(data, settings, warm=warm)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        grown = {k: chol_inv.launches_by_dtype[k] - before[k] for k in before}
        round_launches[label] = grown
        if not (grown["float32"] > 0 and grown["float64"] > 0):
            raise AssertionError(f"{label}: K1 launches per dtype {grown}; both phases must launch it")
        return res, secs

    cold, cold_s = run_round("cold", data)
    rng = np.random.default_rng(2024)
    moved = [dict(p, c=p["c"] + 1e-3 * rng.standard_normal(MAIN_N)) for p in problems]
    data_w = prepare_batch(moved)
    warm_pt = warm_from_result(cold)
    warm, warm_s = run_round("warm", data_w, warm_pt)
    main_launches = {k: v for k, v in chol_inv.launches_by_dtype.items()}

    cold_viol = _check_round(problems, cold, "cold")
    warm_viol = _check_round(moved, warm, "warm")
    for label, res, secs, viol in (("cold", cold, cold_s, cold_viol),
                                   ("warm", warm, warm_s, warm_viol)):
        it = res.info.iter.cpu().numpy()
        print(f"[main {label}] {MAIN_B}/{MAIN_B} SOLVED, {MAIN_B / secs:.1f} solves/s "
              f"({secs:.3f} s), iterations median {np.median(it):.1f} max {it.max()}, "
              f"K1 launches {round_launches[label]}, worst KKT violation {viol:.2e}; {smi}")
    for entry in kernels:
        entry["launches"] = main_launches[entry["name"].removeprefix("chol_inv_")]

    # ---- 4. pure float64, one DenseSolver on the card, CPU cross-check
    f64 = Settings()
    sub = problems[:64]
    before = dict(chol_inv.launches_by_dtype)
    t = time.perf_counter()
    res64 = solve_batch(prepare_batch(sub), f64)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    viol = _check_round(sub, res64, "float64 B=64")
    grown = chol_inv.launches_by_dtype["float64"] - before["float64"]
    if grown <= 0:
        raise AssertionError("float64 batch did not launch K1 in float64")
    print(f"[f64] B=64 all SOLVED in {secs:.3f} s, iterations max "
          f"{int(res64.info.iter.max())}, K1 float64 launches {grown}, worst KKT {viol:.2e}")

    solver = DenseSolver(f64, device="cuda")
    solver.setup(**problems[0])
    if solver.solve() != Status.SOLVED:
        raise AssertionError("DenseSolver did not solve problem 0")
    it0 = int(solver.result.info.iter)
    solver.update(c=moved[0]["c"])
    if solver.solve(warm_start=True) != Status.SOLVED:
        raise AssertionError("DenseSolver did not solve the updated problem 0")
    r = solver.result
    viol = _optimality(moved[0], *(getattr(r, k).cpu().numpy()
                                   for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu")))
    if not viol <= OPT_TOL:
        raise AssertionError(f"DenseSolver KKT violation {viol:.3e}")
    print(f"[single] DenseSolver(device='cuda') n={MAIN_N}: setup/solve {it0} iterations, "
          f"update/warm solve {int(r.info.iter)} iterations, KKT {viol:.2e}")

    # The first 8 problems again on the CPU (plain versions).  In float64
    # both devices follow the same trajectory, so x agrees to 1e-6.  With
    # mixed precision the float32 phase rounds differently on each device
    # and the runs stop at different (equally optimal) iterates: there x
    # is held to XCHECK_MIXED_TOL.
    for label, st, gpu in (("float64", f64, index(res64, slice(0, 8))),
                           ("mixed", settings, index(cold, slice(0, 8)))):
        cpu = solve_batch(prepare_batch(problems[:8], device="cpu"), st)
        same_status = cpu.info.status.tolist() == gpu.info.status.cpu().tolist()
        dx = (cpu.x - gpu.x.cpu()).abs().max().item()
        tol = 1e-6 if label == "float64" else XCHECK_MIXED_TOL
        print(f"[cross-check {label}] first 8 problems on the CPU: status equal "
              f"{same_status}, max |x_cpu - x_gpu| {dx:.3e} (limit {tol:.0e}), "
              f"iterations cpu {cpu.info.iter.tolist()} gpu {gpu.info.iter.cpu().tolist()}")
        if not (same_status and dx <= tol):
            raise AssertionError(f"the {label} CPU cross-check disagrees with the card")

    # ---- 5. where the warm round's device time goes
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        solve_batch(data_w, settings, warm=warm_pt)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # kernel events only: an aten op's row repeats the time of its kernels
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    print(f"[profile warm] kernel time {busy_us / 1e3:.1f} ms in {launches} launches of "
          f"{len(rows)} kernels; device busy {100 * busy_us / (warm_s * 1e6):.1f}% of the "
          f"unprofiled warm round ({warm_s * 1e3:.1f} ms), {100 * busy_us / wall_us:.1f}% "
          f"of the profiled one ({wall_us / 1e3:.1f} ms); {smi}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile warm]   {e.self_device_time_total / 1e3:9.3f} ms  "
              f"{e.count:6d} launches  {e.key[:80]}")

    print(json.dumps({"kernels": kernels}))
    print(f"[device] {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
