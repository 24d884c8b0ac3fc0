"""The port's host sparse route (``piqp_tpu_torch/hostsparse.py`` and
``SparseSolver``'s host route) against the JAX package's.

Both run the same NumPy/SciPy IPM on the CPU, so everything agrees to
1e-12 (relative to max(1, |value|)): status, iterations, x, y and the
inequality duals, on the ``tests/test_hostsparse.py`` cases and every KKT
elimination mode.  ``SparseSolver`` takes the route by setting
(``sparse_host``) and by size (``dense_routing_max_n``, lowered here to
keep the problems small)."""

import numpy as np
import pytest
import scipy.sparse as sp

import piqp_tpu
from piqp_tpu import hostsparse as jhost
from piqp_tpu.utils.random import dense_strongly_convex_qp, sparse_strongly_convex_qp

import piqp_tpu_torch
from piqp_tpu_torch import KKTBackend, Settings, SparseSolver, Status
from piqp_tpu_torch import hostsparse as thost

TOL = 1e-12
MODES = ["auto", "full", "eq", "ineq", "cond"]


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(np.asarray(got) - want).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL:.0e} x {scale:.3e}"


def _same(tres, jres):
    assert tres.info.status == jres.info.status
    assert tres.info.iter == jres.info.iter
    for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu"):
        _close(getattr(tres, k), getattr(jres, k), k)


def _both(prob, **kw):
    jres = jhost.solve_sparse_host(**prob, settings=piqp_tpu.Settings(), **kw)
    tres = thost.solve_sparse_host(**prob, settings=Settings(), **kw)
    _same(tres, jres)
    return tres


def _equality_only():
    rng = np.random.default_rng(3)
    n, p = 20, 6
    M = rng.standard_normal((n, n))
    return dict(P=M @ M.T + n * np.eye(n), c=rng.standard_normal(n),
                A=rng.standard_normal((p, n)), b=rng.standard_normal(p))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_matches_jax_dense_problems(seed):
    res = _both(dense_strongly_convex_qp(30, 8, 12, seed=seed))
    assert res.info.status == int(Status.SOLVED)
    assert isinstance(res, thost.HostResult)


def test_host_equality_only_matches_jax():
    assert _both(_equality_only()).info.status == int(Status.SOLVED)


def test_host_infeasible_detection_matches_jax():
    res = _both(dict(P=np.eye(2), c=np.zeros(2), G=np.array([[1.0, 0.0], [-1.0, 0.0]]),
                     h_u=np.array([-1.0, -1.0])))
    assert res.info.status == int(Status.PRIMAL_INFEASIBLE)


@pytest.mark.parametrize("mode", MODES)
def test_elimination_modes_match_jax(mode):
    res = _both(sparse_strongly_convex_qp(60, 18, 24, seed=5), kkt_mode=mode)
    assert res.info.status == int(Status.SOLVED), mode


@pytest.mark.parametrize("mode", ["eq", "ineq"])
def test_eq_or_ineq_only_modes_match_jax(mode):
    prob = sparse_strongly_convex_qp(40, 0 if mode == "eq" else 12,
                                     14 if mode == "eq" else 0, seed=9)
    assert _both(prob, kkt_mode=mode).info.status == int(Status.SOLVED)


def test_route_choice_matches_jax():
    """The automatic elimination level is the JAX package's on a CVXQP-like
    problem (condensed) and on a 10%-dense one (full KKT)."""
    n, p = 400, 200
    rng = np.random.default_rng(7)
    P = sp.diags([np.full(n - 1, -1.0), rng.uniform(3, 4, n), np.full(n - 1, -1.0)],
                 [-1, 0, 1], format="csc")
    rows = np.repeat(np.arange(p), 3)
    A = sp.csc_matrix((rng.standard_normal(3 * p), (rows, rng.integers(0, n, 3 * p))), (p, n))
    for prob, want in ((dict(P=P, c=np.ones(n), A=A, b=A @ np.ones(n)), "cond"),
                       (sparse_strongly_convex_qp(200, 100, 0, seed=7), "full")):
        t = thost._KKT(thost.prepare_sparse(**prob), Settings())._choose_route()
        j = jhost._KKT(jhost.prepare_sparse(**prob), piqp_tpu.Settings())._choose_route()
        assert t == j == want


def test_host_result_carries_exact_timers():
    prob = dense_strongly_convex_qp(12, 3, 6, seed=7)
    res = thost.solve_sparse_host(
        sp.csc_matrix(prob["P"]), prob["c"], sp.csc_matrix(prob["A"]), prob["b"],
        sp.csc_matrix(prob["G"]), prob["h_l"], prob["h_u"], prob["x_l"], prob["x_u"])
    assert res.info.solve_time > 0.0
    assert 0.0 < res.info.kkt_factor_time < res.info.solve_time
    assert 0.0 < res.info.kkt_solve_time < res.info.solve_time


def _solvers(settings_kw, **solver_kw):
    jkw = {k: (piqp_tpu.KKTBackend(v.value) if isinstance(v, KKTBackend) else v)
           for k, v in settings_kw.items()}
    return (piqp_tpu.SparseSolver(piqp_tpu.Settings(**jkw), **solver_kw),
            SparseSolver(Settings(**settings_kw), device="cpu", **solver_kw))


@pytest.mark.parametrize("route", ["sparse_host", "above_the_cap"])
def test_sparse_solver_takes_the_host_route(route):
    """By setting and by size, setup, solve, update(c) and a warm solve
    through the host route, as in JAX; the result stays a numpy
    HostResult."""
    prob = sparse_strongly_convex_qp(40, 10, 16, seed=11)
    kw = ({"kkt_solver": KKTBackend.sparse_host} if route == "sparse_host"
          else {"dense_routing_max_n": 20})
    jsolver, tsolver = _solvers(kw)
    for s in (jsolver, tsolver):
        s.setup(**prob)
        assert s._host_raw is not None
        assert s.solve() == Status.SOLVED
    _same(tsolver.result, jsolver.result)
    c2 = prob["c"] * 1.05
    for s in (jsolver, tsolver):
        s.update(c=c2)
        assert s.solve(warm_start=True) == Status.SOLVED
    _same(tsolver.result, jsolver.result)
    assert isinstance(tsolver.result, thost.HostResult)
    assert isinstance(tsolver.result.x, np.ndarray)


@pytest.mark.parametrize("mode", ["eq", "ineq", "cond", "full"])
def test_sparse_solver_host_kkt_mode(mode):
    prob = sparse_strongly_convex_qp(60, 18, 24, seed=5)
    jsolver, tsolver = _solvers({"kkt_solver": KKTBackend.sparse_host}, host_kkt_mode=mode)
    for s in (jsolver, tsolver):
        s.setup(**prob)
        assert s.solve() == Status.SOLVED, mode
    _same(tsolver.result, jsolver.result)


def test_sparse_solver_below_the_cap_stays_dense():
    """At or under the cap the problem is densified, as before."""
    prob = sparse_strongly_convex_qp(20, 4, 8, seed=12)
    s = SparseSolver(Settings(dense_routing_max_n=20), device="cpu")
    s.setup(**prob)
    assert s._host_raw is None and s.solve() == Status.SOLVED
    ref = piqp_tpu_torch.solve_dense(
        **{k: (v.toarray() if hasattr(v, "toarray") else v) for k, v in prob.items()},
        device="cpu")
    np.testing.assert_allclose(s.result.x.numpy(), ref.x.numpy(), atol=1e-9)
