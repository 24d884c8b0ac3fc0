"""The PyTorch port's IPM against the JAX package on the analytic QPs of
tests/test_solver.py and on random strongly convex QPs.

JAX runs with ``pallas_kernels=True``, the (L, Linv) factor representation
that the port uses by default.  In float64 the status and the iteration
count are equal and x/y/z agree to 1e-8; with ``mixed_precision=True``
the status is equal, the iteration counts differ by at most 2 and x agrees
to 1e-6 (float32 factors round differently in the two packages)."""

import numpy as np
import pytest

import piqp_tpu
from piqp_tpu.utils.random import dense_strongly_convex_qp

import piqp_tpu_torch
from piqp_tpu_torch.types import index

from helpers import check_optimality

INF = np.inf


def _pair(**kw):
    return piqp_tpu.Settings(pallas_kernels=True, **kw), piqp_tpu_torch.Settings(**kw)


def _assert_parity(jres, tres, mixed=False):
    assert int(tres.info.status) == int(jres.info.status)
    if mixed:
        assert abs(int(tres.info.iter) - int(jres.info.iter)) <= 2
        np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), atol=1e-6)
        return
    assert int(tres.info.iter) == int(jres.info.iter)

    def close(got, want, tol, what):
        # relative to the vector's size: infeasible problems return rays
        # and diverged iterates of size up to ~1e10
        scale = max(1.0, float(np.abs(want).max(initial=0.0)))
        err = float(np.abs(got - want).max(initial=0.0))
        assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} x {scale:.3e}"

    get = lambda r, k: np.asarray(getattr(r, k))  # noqa: E731
    for name in ("x", "y", "z_bl", "z_bu"):
        close(get(tres, name), get(jres, name), 1e-8, name)
    # on a row with h_l == h_u only z_u - z_l is determined; the split
    # between z_l and z_u drifts by ~1e-8 even between the JAX package's
    # own two factor representations
    close(get(tres, "z_u") - get(tres, "z_l"), get(jres, "z_u") - get(jres, "z_l"),
          1e-8, "z_u - z_l")
    for name in ("z_l", "z_u"):
        close(get(tres, name), get(jres, name), 1e-6, name)


def _solve_both(prob, mixed=False):
    js, ts = _pair(mixed_precision=mixed)
    jres = piqp_tpu.solve_dense(**prob, settings=js)
    tres = piqp_tpu_torch.solve_dense(**prob, settings=ts, device="cpu")
    _assert_parity(jres, tres, mixed)
    return tres


def test_simple_qp_with_update():
    # tests/test_solver.py::test_simple_qp_with_update
    P = np.array([[6.0, 0.0], [0.0, 4.0]])
    c = np.array([-1.0, -4.0])
    A = np.array([[1.0, -2.0]])
    b = np.array([0.0])
    G = np.array([[1.0, 0.0], [1.0, 0.0], [1.0, 0.0]])
    h_l = np.array([-1.0, -INF, -2.0])
    h_u = np.array([INF, 1.0, 2.0])
    x_l = np.array([-INF, -1.0])
    x_u = np.array([INF, 1.0])
    js, ts = _pair()
    jsol = piqp_tpu.DenseSolver(js)
    tsol = piqp_tpu_torch.DenseSolver(ts, device="cpu")
    for s in (jsol, tsol):
        s.setup(P, c, A, b, G, h_l, h_u, x_l, x_u)
    assert tsol.solve() == jsol.solve() == piqp_tpu_torch.Status.SOLVED
    _assert_parity(jsol.result, tsol.result)
    assert np.isclose(float(tsol.result.x[0]), 0.4285714, atol=1e-6)

    P2 = P.copy(); P2[0, 0] = 8
    A2 = A.copy(); A2[0, 1] = -3
    h_u2 = h_u.copy(); h_u2[0] = 2
    x_u2 = x_u.copy(); x_u2[1] = 2
    for s in (jsol, tsol):
        s.update(P=P2, A=A2, h_u=h_u2, x_u=x_u2)
    assert tsol.solve() == jsol.solve() == piqp_tpu_torch.Status.SOLVED
    _assert_parity(jsol.result, tsol.result)
    assert np.isclose(float(tsol.result.x[0]), 0.2763157, atol=1e-6)
    # a warm re-solve after a cost update agrees with JAX's warm re-solve
    for s in (jsol, tsol):
        s.update(c=c * 1.01)
    assert tsol.solve(warm_start=True) == jsol.solve(warm_start=True)
    _assert_parity(jsol.result, tsol.result)


def test_primal_infeasible_qp():
    P = np.array([[6.0, 0.0], [0.0, 4.0]])
    c = np.array([-1.0, -4.0])
    A = np.array([[1.0, -2.0]])
    b = np.array([0.0])
    G = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    h = np.array([0.0, 2.0, 1.0, -1.0])
    res = _solve_both(dict(P=P, c=c, A=A, b=b, G=G, h_u=h))
    assert int(res.info.status) == piqp_tpu_torch.Status.PRIMAL_INFEASIBLE


def test_dual_infeasible_qp():
    prob = dict(P=np.zeros((2, 2)), c=np.array([-1.0, -1.0]),
                G=np.array([[-1.0, 0.0], [0.0, -1.0]]), h_u=np.array([0.0, 0.0]))
    res = _solve_both(prob)
    assert int(res.info.status) == piqp_tpu_torch.Status.DUAL_INFEASIBLE


def test_equality_only_qp():
    rng = np.random.default_rng(0)
    n, p = 8, 3
    Q = rng.standard_normal((n, n))
    P = Q @ Q.T + n * np.eye(n)
    c = rng.standard_normal(n)
    A = rng.standard_normal((p, n))
    b = rng.standard_normal(p)
    res = _solve_both(dict(P=P, c=c, A=A, b=b))
    K = np.block([[P, A.T], [A, np.zeros((p, p))]])
    sol = np.linalg.solve(K, np.concatenate([-c, b]))
    np.testing.assert_allclose(res.x.numpy(), sol[:n], atol=1e-7)


def test_unconstrained_qp():
    rng = np.random.default_rng(1)
    n = 6
    Q = rng.standard_normal((n, n))
    P = Q @ Q.T + n * np.eye(n)
    c = rng.standard_normal(n)
    res = _solve_both(dict(P=P, c=c))
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(P, -c), atol=1e-7)


def test_box_only_qp():
    prob = dict(P=np.eye(3), c=np.array([-10.0, 10.0, 0.0]),
                x_l=-np.ones(3), x_u=np.ones(3))
    res = _solve_both(prob)
    np.testing.assert_allclose(res.x.numpy(), [1.0, -1.0, 0.0], atol=1e-7)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("dims", [(10, 0, 8), (20, 5, 12), (32, 8, 20), (13, 3, 0)])
def test_random_strongly_convex(seed, dims):
    prob = dense_strongly_convex_qp(*dims, seed=seed)
    res = _solve_both(prob)
    assert int(res.info.status) == piqp_tpu_torch.Status.SOLVED
    check_optimality(prob, res, tol=1e-6)


@pytest.mark.parametrize("dims", [(20, 5, 12), (32, 8, 20)])
def test_random_mixed_precision(dims):
    prob = dense_strongly_convex_qp(*dims, seed=3)
    res = _solve_both(prob, mixed=True)
    assert int(res.info.status) == piqp_tpu_torch.Status.SOLVED
    check_optimality(prob, res, tol=1e-6)


def test_warm_ipm_from_carried_over_state():
    """Both IPMs start from identical state: JAX's equilibrated data,
    scaling and warm point, carried over by convert.py; the port's result
    matches JAX's result carried over the same way."""
    import jax
    from piqp_tpu import ruiz as jruiz, solver as jsolver
    from piqp_tpu.types import BasicVars as JBasicVars

    from piqp_tpu_torch import convert, solver as tsolver

    prob = dense_strongly_convex_qp(20, 5, 12, seed=8)
    js, ts = _pair()
    prev = piqp_tpu.solve_dense(**prob, settings=js)
    warm = JBasicVars(prev.x, prev.y, prev.z_l, prev.z_u, prev.z_bl, prev.z_bu)
    sdata, sc = jruiz.equilibrate(piqp_tpu.prepare_data(**dict(prob, c=prob["c"] * 1.01)))
    jres = jax.jit(jsolver.solve_scaled, static_argnums=(2, 3))(sdata, sc, js, True, warm)

    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    tres = tsolver.solve_scaled(
        convert.qpdata(host(sdata)), convert.scaling(host(sc)), ts, True,
        convert.basic_vars(host(warm)),
    )
    want = convert.result(host(jres))
    assert 0 < int(tres.info.iter[0]) < int(prev.info.iter)
    _assert_parity(index(want, 0), index(tres, 0))
    for name in ("primal_obj", "dual_res", "mu"):
        np.testing.assert_allclose(getattr(tres.info, name).numpy(),
                                   getattr(want.info, name).numpy(), rtol=1e-6, atol=1e-12)


def test_cholesky_representation_matches_jax_default():
    """``pallas_kernels=False`` keeps the library Cholesky in both packages."""
    prob = dense_strongly_convex_qp(20, 5, 12, seed=4)
    jres = piqp_tpu.solve_dense(**prob, settings=piqp_tpu.Settings(pallas_kernels=False))
    tres = piqp_tpu_torch.solve_dense(
        **prob, settings=piqp_tpu_torch.Settings(pallas_kernels=False), device="cpu"
    )
    _assert_parity(jres, tres)


def test_invalid_settings_and_unported_backends():
    s = piqp_tpu_torch.DenseSolver(piqp_tpu_torch.Settings(eps_abs=-1.0), device="cpu")
    s.setup(np.eye(2), np.zeros(2))
    assert s.solve() == piqp_tpu_torch.Status.INVALID_SETTINGS
    for backend in ("dense_lu", "dense_ldlt", "multistage"):
        settings = piqp_tpu_torch.Settings(kkt_solver=piqp_tpu_torch.KKTBackend(backend))
        res = piqp_tpu_torch.solve_dense(np.eye(2), -np.ones(2), settings=settings, device="cpu")
        assert int(res.info.status) == int(piqp_tpu_torch.Status.SOLVED)
        np.testing.assert_allclose(res.x.numpy(), np.ones(2), atol=1e-8)
    # sparse_host and compute_timings on the dense entry points behave as in
    # JAX: the condensed backend solves, and only the stateful solver
    # fills the time fields
    prob = dense_strongly_convex_qp(12, 3, 6, seed=7)
    for kw in (dict(kkt_solver="sparse_host"), dict(compute_timings=True)):
        jkw = dict(kw, kkt_solver=piqp_tpu.KKTBackend(kw.get("kkt_solver", "dense_cholesky")))
        tkw = dict(kw, kkt_solver=piqp_tpu_torch.KKTBackend(jkw["kkt_solver"].value))
        jres = piqp_tpu.solve_dense(**prob, settings=piqp_tpu.Settings(**jkw))
        tres = piqp_tpu_torch.solve_dense(**prob, settings=piqp_tpu_torch.Settings(**tkw),
                                          device="cpu")
        _assert_parity(jres, tres)
        assert float(tres.info.solve_time) == 0.0
    s = piqp_tpu_torch.DenseSolver(piqp_tpu_torch.Settings(compute_timings=True), device="cpu")
    s.setup(**prob)
    assert s.solve() == piqp_tpu_torch.Status.SOLVED
    info = s.result.info
    for name in ("setup_time", "solve_time", "kkt_factor_time", "kkt_solve_time"):
        assert float(getattr(info, name)) > 0.0, name
    assert float(info.update_time) == 0.0
    assert float(info.run_time) == pytest.approx(float(info.setup_time) + float(info.solve_time))
    s.update(c=prob["c"] * 1.01)
    assert s.solve(warm_start=True) == piqp_tpu_torch.Status.SOLVED
    info = s.result.info
    assert float(info.update_time) > 0.0
    assert float(info.run_time) == pytest.approx(float(info.update_time) + float(info.solve_time))
