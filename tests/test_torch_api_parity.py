"""Symbol-level parity of the port with PIQP's Python bindings and with the
JAX package.

The reference lists are those of tests/test_api_parity.py, transcribed
from PIQP's pybind11 module (interfaces/python/src/piqp_python.cpp:31-137):
every name a PIQP Python user can touch exists in the port with the same
spelling.  The port's Settings, Info and Result have the JAX package's
field sets, its Status the same values, and ``KKTBackend.from_piqp`` maps
every name to the same backend."""

import dataclasses

import pytest

import piqp_tpu
from piqp_tpu import types as jtypes

from piqp_tpu_torch import DenseSolver, SparseSolver
from piqp_tpu_torch.types import Info, KKTBackend, Result, Settings, Status

# piqp_python.cpp:31-38 (PIQP_ prefix dropped: the enum is the namespace)
REF_STATUS = [
    "SOLVED", "MAX_ITER_REACHED", "PRIMAL_INFEASIBLE", "DUAL_INFEASIBLE",
    "NUMERICS", "UNSOLVED", "INVALID_SETTINGS",
]

# piqp_python.cpp:41-76
REF_INFO = [
    "status", "iter", "rho", "delta", "mu", "sigma", "primal_step",
    "dual_step", "primal_res", "primal_res_rel", "dual_res", "dual_res_rel",
    "primal_res_reg", "primal_res_reg_rel", "dual_res_reg",
    "dual_res_reg_rel", "primal_prox_inf", "dual_prox_inf",
    "prev_primal_res", "prev_dual_res", "primal_obj", "dual_obj",
    "duality_gap", "duality_gap_rel", "factor_retires", "reg_limit",
    "no_primal_update", "no_dual_update", "setup_time", "update_time",
    "solve_time", "kkt_factor_time", "kkt_solve_time", "run_time",
]

# piqp_python.cpp:78-89
REF_RESULT = [
    "x", "y", "z_l", "z_u", "z_bl", "z_bu", "s_l", "s_u", "s_bl", "s_bu",
    "info",
]

# piqp_python.cpp:91-98
REF_KKT_SOLVERS = [
    "dense_cholesky", "sparse_ldlt", "sparse_ldlt_eq_cond",
    "sparse_ldlt_ineq_cond", "sparse_ldlt_cond", "sparse_multistage",
]

# piqp_python.cpp:100-137
REF_SETTINGS = [
    "rho_init", "delta_init", "eps_abs", "eps_rel", "check_duality_gap",
    "eps_duality_gap_abs", "eps_duality_gap_rel", "infeasibility_threshold",
    "reg_lower_limit", "reg_finetune_lower_limit",
    "reg_finetune_primal_update_threshold",
    "reg_finetune_dual_update_threshold", "max_iter", "max_factor_retires",
    "preconditioner_scale_cost", "preconditioner_reuse_on_update",
    "preconditioner_iter", "tau", "kkt_solver",
    "iterative_refinement_always_enabled", "iterative_refinement_eps_abs",
    "iterative_refinement_eps_rel", "iterative_refinement_max_iter",
    "iterative_refinement_min_improvement_rate",
    "iterative_refinement_static_regularization_eps",
    "iterative_refinement_static_regularization_rel", "verbose",
    "compute_timings",
]


def _fields(cls):
    return [f.name for f in dataclasses.fields(cls)]


def test_status_values():
    assert not [s for s in REF_STATUS if not hasattr(Status, s)]


def test_info_fields():
    assert not [f for f in REF_INFO if f not in _fields(Info)]


def test_result_fields():
    assert not [f for f in REF_RESULT if f not in _fields(Result)]


@pytest.mark.parametrize("name", REF_KKT_SOLVERS)
def test_kkt_solver_names_map(name):
    assert isinstance(KKTBackend.from_piqp(name), KKTBackend)


def test_settings_fields():
    assert not [f for f in REF_SETTINGS if f not in _fields(Settings)]


@pytest.mark.parametrize("cls", [DenseSolver, SparseSolver])
def test_solver_surface(cls):
    for name in ("setup", "update", "solve", "result", "settings"):
        assert hasattr(cls, name), name


@pytest.mark.parametrize("ours,theirs", [(Settings, piqp_tpu.Settings),
                                         (Info, jtypes.Info), (Result, jtypes.Result)],
                         ids=["Settings", "Info", "Result"])
def test_field_sets_equal_the_jax_package(ours, theirs):
    """The same fields, in the same order."""
    assert _fields(ours) == _fields(theirs)


def test_settings_defaults_equal_the_jax_package():
    jax_defaults = piqp_tpu.Settings()
    for f in dataclasses.fields(Settings):
        want = getattr(jax_defaults, f.name)
        got = getattr(Settings(), f.name)
        if f.name == "kkt_solver":
            got, want = got.value, want.value
        assert got == want, f.name


def test_status_values_equal_the_jax_package():
    assert {s.name: int(s) for s in Status} == {s.name: int(s) for s in piqp_tpu.Status}


def test_kkt_backends_equal_the_jax_package():
    assert [b.value for b in KKTBackend] == [b.value for b in piqp_tpu.KKTBackend]


@pytest.mark.parametrize("name", REF_KKT_SOLVERS + [b.value for b in KKTBackend])
def test_from_piqp_equals_the_jax_package(name):
    assert KKTBackend.from_piqp(name).value == piqp_tpu.KKTBackend.from_piqp(name).value


def test_from_piqp_refuses_an_unknown_name():
    with pytest.raises(ValueError):
        KKTBackend.from_piqp("sparse_qdldl")
