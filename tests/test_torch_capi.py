"""The port's C interface (piqp_tpu_torch/capi/) on the CPU: its C driver
passes every check of the JAX package's C test; its file-driven solves
match ``piqp_tpu.DenseSolver`` / ``SparseSolver`` in float64 (status and
iterations equal, x to 1e-8 scaled by max(1, |x|)); ``pallas_kernels``
-1 and 0 reach the port's ``None`` and ``False``; without a GPU and
without ``piqp_tpu_set_device`` a setup fails with ``resolve_device``'s
message; the two headers lay out every struct alike; ``pack_result``
reads every field and misses none.

Skips only where tests/test_capi.py does: without g++ or python3-config."""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import piqp_tpu
from piqp_tpu import multistage as jms

import piqp_tpu_torch
from piqp_tpu_torch.capi import (
    pack_result,
    read_run,
    run_files,
    settings_from_fields,
    write_problem,
)
from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPI = os.path.join(ROOT, "piqp_tpu_torch", "capi")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("gcc") is None
    or shutil.which("python3-config") is None,
    reason="C toolchain not available",
)

# run name -> (piqp_tpu_settings fields, the JAX package's Settings)
DENSE_RUNS = {
    "chol": ({"repeat": 1}, dict(pallas_kernels=True)),
    "ldlt": ({"kkt_solver": 7}, dict(kkt_solver="dense_ldlt", pallas_kernels=True)),
    "lu": ({"kkt_solver": 6}, dict(kkt_solver="dense_lu")),
}
SPARSE_RUNS = {
    "multistage": ({"kkt_solver": 5}, dict(kkt_solver="multistage", pallas_kernels=True)),
    "dense_route": ({}, dict(pallas_kernels=True)),
    "host": ({"kkt_solver": 1}, dict(kkt_solver="sparse_host")),
}
# pallas_kernels of the C struct against the port's Settings
MAPPING_RUNS = {"default": ({}, {}), "minus_one": ({"pallas_kernels": -1}, {}),
                "one": ({"pallas_kernels": 1}, dict(pallas_kernels=True)),
                "zero": ({"pallas_kernels": 0}, dict(pallas_kernels=False))}


def _env():
    env = dict(os.environ)
    site = [p for p in sys.path if p.endswith("site-packages")]
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + site)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _driver(binary, *args, timeout=600):
    return subprocess.run([binary, *args], capture_output=True, text=True, env=_env(),
                          timeout=timeout)


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    out = tmp_path_factory.mktemp("capi")
    done = subprocess.run(["sh", os.path.join(CAPI, "build_capi.sh"), str(out)],
                          capture_output=True, text=True)
    assert done.returncode == 0, done.stdout + done.stderr
    return out


def _dense_problem():
    prob = dense_strongly_convex_qp(16, 4, 8, seed=0)
    c2 = prob["c"] + 1e-3 * np.random.default_rng(1).standard_normal(16)
    return prob, c2


def _sparse_problem():
    d = jms.to_dense(jms.random_multistage_qp(T=5, D=3, Da=2, ra=2, rg=2, seed=3))
    hl, hu = np.asarray(d.hl_mask), np.asarray(d.hu_mask)
    prob = dict(
        P=sp.csc_matrix(np.asarray(d.P)), c=np.asarray(d.c),
        A=sp.csc_matrix(np.asarray(d.A)), b=np.asarray(d.b),
        G=sp.csc_matrix(np.asarray(d.G)),
        h_l=np.where(hl, np.asarray(d.h_l), -np.inf),
        h_u=np.where(hu, np.asarray(d.h_u), np.inf),
    )
    c2 = prob["c"] * 1.01
    return prob, c2


@pytest.fixture(scope="module")
def file_runs(build, tmp_path_factory):
    """One driver process on the CPU over three problem directories: the
    dense and sparse problems through each backend, and the dense problem
    under each pallas_kernels value."""
    work = tmp_path_factory.mktemp("files")
    dense, dense_c = _dense_problem()
    sparse, sparse_c = _sparse_problem()
    dirs = {k: str(work / k) for k in ("dense", "sparse", "mapping")}
    dims = {
        "dense": write_problem(dirs["dense"], dense, c_update=dense_c,
                               runs={k: v[0] for k, v in DENSE_RUNS.items()}),
        "sparse": write_problem(dirs["sparse"], sparse, sparse=True, c_update=sparse_c,
                                runs={k: v[0] for k, v in SPARSE_RUNS.items()}),
        "mapping": write_problem(dirs["mapping"], dense,
                                 runs={k: v[0] for k, v in MAPPING_RUNS.items()}),
    }
    done = _driver(str(build / "test_capi"), "cpu", *dirs.values())
    assert done.returncode == 0, done.stdout + done.stderr
    runs = {}
    for kind, table in (("dense", DENSE_RUNS), ("sparse", SPARSE_RUNS),
                        ("mapping", MAPPING_RUNS)):
        runs[kind] = {name: read_run(dirs[kind], name, *dims[kind]) for name in table}
    return dict(runs=runs, problems=dict(dense=(dense, dense_c), sparse=(sparse, sparse_c)),
                dirs=dirs, dims=dims)


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(np.asarray(got) - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} x {scale:.3e}"


def _jax_solves(kind, prob, c2, settings):
    """Cold solve, update(c) and warm solve through the JAX package."""
    if "kkt_solver" in settings:
        settings = dict(settings, kkt_solver=piqp_tpu.KKTBackend(settings["kkt_solver"]))
    cls = piqp_tpu.SparseSolver if kind == "sparse" else piqp_tpu.DenseSolver
    solver = cls(piqp_tpu.Settings(**settings))
    solver.setup(**prob)
    out = [(int(solver.solve()), int(np.asarray(solver.result.info.iter)),
            np.asarray(solver.result.x))]
    solver.update(c=c2)
    out.append((int(solver.solve(warm_start=True)), int(np.asarray(solver.result.info.iter)),
                np.asarray(solver.result.x)))
    return out


def test_driver_passes_the_jax_c_checks_on_cpu(build):
    done = _driver(str(build / "test_capi"), "cpu")
    assert done.returncode == 0, done.stdout + done.stderr
    assert "C interface test passed" in done.stdout


def test_default_device_needs_cuda(build):
    """No device call: the library runs on CUDA, so without a GPU every
    setup fails with resolve_device's message and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the library's default runs there")
    done = _driver(str(build / "test_capi"))
    assert done.returncode != 0
    assert "setup failed" in done.stderr
    assert "runs on a CUDA device and none is available" in done.stderr
    assert "C interface test passed" not in done.stdout


@pytest.mark.parametrize("kind,name", [("dense", k) for k in DENSE_RUNS]
                         + [("sparse", k) for k in SPARSE_RUNS])
def test_file_driven_solves_match_jax(file_runs, kind, name):
    c_run = file_runs["runs"][kind][name]
    prob, c2 = file_runs["problems"][kind]
    table = DENSE_RUNS if kind == "dense" else SPARSE_RUNS
    ref = _jax_solves(kind, prob, c2, table[name][1])
    for phase, key, (status, iters, x) in (("cold", "", ref[0]), ("warm", "warm_", ref[1])):
        assert c_run[f"{key}status"] == status == 1, phase
        assert c_run[f"{key}iter"] == iters, phase
        _close(c_run[phase]["x"], x, 1e-8, f"{name} {phase} x")
    seconds = c_run["seconds"]
    assert seconds["setup"] > 0 and seconds["solve"] > 0 and seconds["warm_solve"] > 0
    assert (seconds["repeat_solve"] > 0) == ("repeat" in table[name][0])


@pytest.mark.parametrize("name", list(MAPPING_RUNS))
def test_pallas_kernels_maps_to_the_port(file_runs, name):
    """-1 (the default) and 1 give the port's kernel representation, 0 the
    library factorizations: the C solve's x equals the port's in-process
    x bit for bit under the Settings it maps to, and the two
    representations differ in the last bits."""
    prob, _ = file_runs["problems"]["dense"]
    x = {}
    for label, kw in (("kernels", {}), ("library", dict(pallas_kernels=False))):
        solver = piqp_tpu_torch.DenseSolver(piqp_tpu_torch.Settings(**kw), device="cpu")
        solver.setup(**prob)
        assert solver.solve() == piqp_tpu_torch.Status.SOLVED
        x[label] = solver.result.x.numpy()
    assert not np.array_equal(x["kernels"], x["library"])
    want = "library" if MAPPING_RUNS[name][1].get("pallas_kernels") is False else "kernels"
    got = file_runs["runs"]["mapping"][name]["cold"]["x"]
    assert np.array_equal(got, x[want])


@pytest.mark.parametrize("kind", ["dense", "sparse", "mapping"])
def test_python_control_repeats_the_c_driver(file_runs, kind):
    """``run_files``, the control of the C library's timings, runs the same
    solves through the Python entry points: the same statuses, iterations
    and x, bit for bit."""
    run_files("cpu", [file_runs["dirs"][kind]], prefix="py-")
    for name, c_run in file_runs["runs"][kind].items():
        py_run = read_run(file_runs["dirs"][kind], f"py-{name}", *file_runs["dims"][kind])
        for key in ("status", "iter", "warm_status", "warm_iter"):
            assert py_run[key] == c_run[key], (name, key)
        for phase in ("cold", "warm"):
            if c_run[phase] is None:
                assert py_run[phase] is None
                continue
            for k, v in c_run[phase].items():
                assert np.array_equal(py_run[phase][k], v), (name, phase, k)


def test_settings_from_fields_reads_the_c_fields():
    s = settings_from_fields({"kkt_solver": "7", "use_float32": "1", "pallas_kernels": "0",
                              "check_duality_gap": "0", "max_iter": "30", "eps_abs": "1e-9",
                              "iterative_refinement_static_regularization_rel": "-1"})
    assert s.kkt_solver == piqp_tpu_torch.KKTBackend.dense_ldlt and s.dtype == "float32"
    assert s.pallas_kernels is False and s.check_duality_gap is False
    assert s.max_iter == 30 and s.eps_abs == 1e-9
    assert s.iterative_refinement_static_regularization_rel is None
    assert settings_from_fields({}) == piqp_tpu_torch.Settings()
    assert settings_from_fields({"kkt_solver": -1}).kkt_solver.value == "dense_cholesky"


SETTINGS_FIELDS = [
    "rho_init", "delta_init", "eps_abs", "eps_rel", "check_duality_gap",
    "eps_duality_gap_abs", "eps_duality_gap_rel", "infeasibility_threshold",
    "reg_lower_limit", "reg_finetune_lower_limit",
    "reg_finetune_primal_update_threshold", "reg_finetune_dual_update_threshold",
    "max_iter", "max_factor_retires", "preconditioner_scale_cost",
    "preconditioner_reuse_on_update", "preconditioner_iter", "tau", "kkt_solver",
    "iterative_refinement_always_enabled", "iterative_refinement_eps_abs",
    "iterative_refinement_eps_rel", "iterative_refinement_max_iter",
    "iterative_refinement_min_improvement_rate",
    "iterative_refinement_static_regularization_eps",
    "iterative_refinement_static_regularization_rel", "verbose", "compute_timings",
    "use_float32", "mixed_precision", "pallas_kernels", "refine_mu_factor",
    "refine_static_passes", "mixed_phase_a_patience",
]
SETTINGS_DOUBLES = {
    "rho_init", "delta_init", "eps_abs", "eps_rel", "eps_duality_gap_abs",
    "eps_duality_gap_rel", "infeasibility_threshold", "reg_lower_limit",
    "reg_finetune_lower_limit", "tau", "iterative_refinement_eps_abs",
    "iterative_refinement_eps_rel", "iterative_refinement_min_improvement_rate",
    "iterative_refinement_static_regularization_eps",
    "iterative_refinement_static_regularization_rel", "refine_mu_factor",
}


def test_c_defaults_are_the_python_defaults(build, tmp_path):
    """piqp_tpu_settings_default, read field by field and mapped as the
    library maps it, gives Settings(): pallas_kernels -1 is None, the
    hand-written kernels."""
    lines = ['#include <stdio.h>', '#include "piqp_tpu_torch_c.h"', "int main(void) {",
             "piqp_tpu_settings s; piqp_tpu_settings_default(&s);"]
    for f in SETTINGS_FIELDS:
        fmt, cast = ("%.17g", "(double)") if f in SETTINGS_DOUBLES else ("%d", "(int)")
        lines.append(f'printf("{f} {fmt}\\n", {cast}s.{f});')
    lines.append("return 0; }")
    src = tmp_path / "defaults.c"
    src.write_text("\n".join(lines) + "\n")
    exe = tmp_path / "defaults"
    built = subprocess.run(["gcc", "-std=c11", "-Wall", "-Werror", f"-I{CAPI}", str(src),
                            "-o", str(exe), f"-L{build}", "-lpiqp_tpu_torch_c",
                            f"-Wl,-rpath,{build}"], capture_output=True, text=True)
    assert built.returncode == 0, built.stderr
    out = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout
    fields = dict(line.split() for line in out.splitlines())
    assert list(fields) == SETTINGS_FIELDS and fields["pallas_kernels"] == "-1"
    assert settings_from_fields(fields) == piqp_tpu_torch.Settings()


@pytest.mark.parametrize("field,value", [("pallas_kernels", 2), ("pallas_kernels", -2),
                                         ("kkt_solver", 8), ("no_such_field", 1)])
def test_settings_from_fields_refuses_what_the_header_lacks(field, value):
    with pytest.raises((ValueError, AttributeError)):
        settings_from_fields({field: value})


def test_header_layouts_are_identical(tmp_path):
    """sizeof of every struct and offsetof of every member, compiled once
    against each header: the same output."""
    structs = {
        "piqp_tpu_csc": ["m", "n", "nnz", "p", "i", "x"],
        "piqp_tpu_dense_data": ["P", "c", "A", "b", "G", "h_l", "h_u", "x_l", "x_u",
                                "n", "p", "m"],
        "piqp_tpu_sparse_data": ["P", "c", "A", "b", "G", "h_l", "h_u", "x_l", "x_u",
                                 "n", "p", "m"],
        "piqp_tpu_settings": SETTINGS_FIELDS,
        "piqp_tpu_info": [f.name for f in dataclasses.fields(piqp_tpu_torch.Info)],
        "piqp_tpu_result": ["x", "y", "z_l", "z_u", "z_bl", "z_bu", "s_l", "s_u", "s_bl",
                            "s_bu", "info", "status", "iter", "primal_obj", "primal_res",
                            "dual_res"],
    }
    enums = ["PIQP_TPU_DENSE_CHOLESKY", "PIQP_TPU_SPARSE_LDLT", "PIQP_TPU_SPARSE_LDLT_EQ_COND",
             "PIQP_TPU_SPARSE_LDLT_INEQ_COND", "PIQP_TPU_SPARSE_LDLT_COND",
             "PIQP_TPU_SPARSE_MULTISTAGE", "PIQP_TPU_DENSE_LU", "PIQP_TPU_DENSE_LDLT",
             "PIQP_TPU_AUTO"]
    lines = ["#include <stddef.h>", "#include <stdio.h>", "#include HEADER",
             "int main(void) {"]
    for struct, members in structs.items():
        lines.append(f'printf("{struct} %zu\\n", sizeof({struct}));')
        lines += [f'printf("{struct}.{m} %zu\\n", offsetof({struct}, {m}));' for m in members]
    lines += [f'printf("{e} %d\\n", (int){e});' for e in enums]
    lines += ['printf("INF %g\\n", PIQP_TPU_INF);', "return 0; }"]
    src = tmp_path / "layout.c"
    src.write_text("\n".join(lines) + "\n")
    outputs = []
    for include, header in ((os.path.join(ROOT, "csrc"), "piqp_tpu_c.h"),
                            (CAPI, "piqp_tpu_torch_c.h")):
        exe = tmp_path / f"layout_{header.split('.')[0]}"
        built = subprocess.run(["gcc", "-std=c11", "-Wall", "-Werror", f"-I{include}",
                                f'-DHEADER="{header}"', str(src), "-o", str(exe)],
                               capture_output=True, text=True)
        assert built.returncode == 0, built.stderr
        outputs.append(subprocess.run([str(exe)], capture_output=True, text=True,
                                      check=True).stdout)
    assert outputs[0].count("\n") > 100
    assert outputs[0] == outputs[1]


def _tiny_result():
    prob = dense_strongly_convex_qp(6, 2, 3, seed=5)
    solver = piqp_tpu_torch.DenseSolver(piqp_tpu_torch.Settings(), device="cpu")
    solver.setup(**prob)
    solver.solve()
    return solver.result


VECTORS = tuple(f.name for f in dataclasses.fields(piqp_tpu_torch.Result) if f.name != "info")
INFO = tuple(f.name for f in dataclasses.fields(piqp_tpu_torch.Info))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pack_result_flattens_every_field(dtype):
    res = _tiny_result()
    if dtype == "float32":
        res = piqp_tpu_torch.types.tree_map(
            lambda t: t.float() if t.is_floating_point() else t, res)
    packed = pack_result(res, VECTORS, INFO)
    assert packed.dtype == np.float64
    want = np.concatenate([getattr(res, k).double().numpy().ravel() for k in VECTORS]
                          + [np.array([float(getattr(res.info, k)) for k in INFO])])
    np.testing.assert_array_equal(packed, want)


def test_pack_result_of_the_host_route():
    from piqp_tpu_torch.hostsparse import solve_sparse_host

    prob, _ = _sparse_problem()
    res = solve_sparse_host(**prob, settings=piqp_tpu_torch.Settings())
    packed = pack_result(res, VECTORS, INFO)
    n, p, m = prob["P"].shape[0], prob["A"].shape[0], prob["G"].shape[0]
    assert packed.shape == (5 * n + p + 4 * m + len(INFO),)
    assert packed[5 * n + p + 4 * m] == 1.0  # info.status: SOLVED


def test_pack_result_refuses_a_missing_field():
    res = _tiny_result()
    with pytest.raises(AttributeError):
        pack_result(res, VECTORS, INFO + ("no_such_field",))
    with pytest.raises(AttributeError):
        pack_result(res, VECTORS + ("w",), INFO)
