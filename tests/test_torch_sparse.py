"""``SparseSolver`` of the PyTorch port against the JAX package's: the
multistage route through structure detection, the selective vector update
and warm start, the dense route, the fallback without structure, and the
host route.

Tolerances: float64, status and iteration count equal, x to 1e-8 (scaled
by max(1, |x|))."""

import numpy as np
import pytest
import scipy.sparse as sp

import piqp_tpu
from piqp_tpu import multistage as jms

import piqp_tpu_torch
from piqp_tpu_torch import KKTBackend, Settings, SparseSolver, Status

from helpers import check_optimality


def _user_problem(seed, T=16):
    d = jms.to_dense(jms.random_multistage_qp(T=T, D=3, Da=2, ra=2, rg=2, seed=seed))
    hl, hu = np.asarray(d.hl_mask), np.asarray(d.hu_mask)
    return dict(
        P=sp.csc_matrix(np.asarray(d.P)), c=np.asarray(d.c),
        A=sp.csc_matrix(np.asarray(d.A)), b=np.asarray(d.b),
        G=sp.csc_matrix(np.asarray(d.G)),
        h_l=np.where(hl, np.asarray(d.h_l), -np.inf),
        h_u=np.where(hu, np.asarray(d.h_u), np.inf),
    )


def _dense(prob):
    return {k: (v.toarray() if hasattr(v, "toarray") else v) for k, v in prob.items()}


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(np.asarray(got) - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} x {scale:.3e}"


@pytest.fixture(scope="module")
def sequence():
    """setup + solve, update(c, b) + warm solve, update(h_u) + warm solve,
    through both packages' multistage SparseSolver."""
    prob = _user_problem(22)
    c2, b2 = prob["c"] * 1.1, prob["b"] * 0.9
    h_u3 = prob["h_u"] + 0.5
    out = {}
    for pkg, solver in (
        ("jax", piqp_tpu.SparseSolver(piqp_tpu.Settings(
            kkt_solver=piqp_tpu.KKTBackend.multistage, pallas_kernels=True))),
        ("torch", SparseSolver(Settings(kkt_solver=KKTBackend.multistage), device="cpu")),
    ):
        steps = []
        solver.setup(**prob)
        assert solver._stage_data is not None, "multistage structure not detected"
        d0 = solver._stage_data
        steps.append((int(solver.solve()), solver.result))
        solver.update(c=c2, b=b2)
        steps.append((int(solver.solve(warm_start=True)), solver.result))
        solver.update(h_u=h_u3)
        steps.append((int(solver.solve(warm_start=True)), solver.result))
        out[pkg] = (steps, d0, solver._stage_data)
    probs = [prob, dict(prob, c=c2, b=b2), dict(prob, c=c2, b=b2, h_u=h_u3)]
    return probs, out


@pytest.mark.parametrize("step", [0, 1, 2], ids=["cold", "update-c-b", "update-h_u"])
def test_multistage_route_matches_jax(sequence, step):
    probs, out = sequence
    (jstatus, jres), (tstatus, tres) = out["jax"][0][step], out["torch"][0][step]
    assert tstatus == jstatus == int(Status.SOLVED)
    assert int(tres.info.iter) == int(np.asarray(jres.info.iter))
    _close(tres.x.numpy(), jres.x, 1e-8, "x")
    _close(tres.y.numpy(), jres.y, 1e-8, "y")
    _close((tres.z_u - tres.z_l).numpy(), np.asarray(jres.z_u) - np.asarray(jres.z_l),
           1e-8, "z")
    check_optimality(_dense(probs[step]), tres, tol=1e-6)


def test_vector_updates_keep_the_stage_blocks(sequence):
    _, out = sequence
    _, d0, d_last = out["torch"]
    for leaf in ("Pd", "Psub", "Pa", "Pc", "A1", "A2", "Ag", "G1", "G2", "Gg"):
        assert getattr(d_last, leaf) is getattr(d0, leaf), leaf
    assert d_last.c is not d0.c


def test_dead_row_and_matrix_updates_rescatter():
    """A bound pattern change (a row loses both bounds) or a matrix update
    takes the full re-scatter path and still solves like a fresh setup."""
    prob = _user_problem(23)
    s = SparseSolver(Settings(kkt_solver=KKTBackend.multistage), device="cpu")
    s.setup(**prob)
    assert s.solve() == Status.SOLVED
    d0 = s._stage_data
    live = np.nonzero(np.isfinite(prob["h_l"]) | np.isfinite(prob["h_u"]))[0]
    h_l, h_u = prob["h_l"].copy(), prob["h_u"].copy()
    h_l[live[0]], h_u[live[0]] = -np.inf, np.inf
    s.update(h_l=h_l, h_u=h_u)
    assert s._stage_data.G1 is not d0.G1
    assert s.solve(warm_start=True) == Status.SOLVED
    s.update(P=prob["P"] * 1.5)
    assert s.solve(warm_start=True) == Status.SOLVED
    fresh = SparseSolver(Settings(kkt_solver=KKTBackend.multistage), device="cpu")
    fresh.setup(**dict(prob, h_l=h_l, h_u=h_u, P=prob["P"] * 1.5))
    assert fresh.solve() == Status.SOLVED
    np.testing.assert_allclose(s.result.x.numpy(), fresh.result.x.numpy(), atol=1e-7)


def test_dense_route_and_fallback_match_dense_solver():
    prob = _user_problem(24)
    ref = piqp_tpu_torch.solve_dense(**_dense(prob), device="cpu")
    for settings in (Settings(), Settings(kkt_solver=KKTBackend.dense_ldlt)):
        s = SparseSolver(settings, device="cpu")
        s.setup(**prob)
        assert s._stage_data is None
        assert s.solve() == Status.SOLVED
        np.testing.assert_allclose(s.result.x.numpy(), ref.x.numpy(), atol=1e-7)
    # no usable structure: the multistage setting falls back to the dense route
    rng = np.random.default_rng(5)
    Q = rng.standard_normal((20, 20))
    P = Q @ Q.T + 20 * np.eye(20)
    s = SparseSolver(Settings(kkt_solver=KKTBackend.multistage), device="cpu")
    s.setup(sp.csc_matrix(P), np.ones(20))
    assert s._stage_data is None and s.solve() == Status.SOLVED
    np.testing.assert_allclose(P @ s.result.x.numpy(), -np.ones(20), atol=1e-7)
    strict = SparseSolver(Settings(kkt_solver=KKTBackend.multistage), device="cpu",
                          multistage_fallback=False)
    with pytest.raises(ValueError):
        strict.setup(sp.csc_matrix(P), np.ones(20))


def test_host_route_is_not_ported():
    """The host route, once unported: by setting and above the size cap,
    SparseSolver solves on the host as the JAX package's does (status,
    iterations and x equal to 1e-12).  Invalid settings are still caught
    on the multistage route."""
    prob = _user_problem(25)
    for kw in (dict(kkt_solver="sparse_host"), dict(dense_routing_max_n=10)):
        jkw = dict(kw, kkt_solver=piqp_tpu.KKTBackend(kw.get("kkt_solver", "dense_cholesky")))
        tkw = dict(kw, kkt_solver=KKTBackend(jkw["kkt_solver"].value))
        js = piqp_tpu.SparseSolver(piqp_tpu.Settings(**jkw))
        ts = SparseSolver(Settings(**tkw), device="cpu")
        for s in (js, ts):
            s.setup(**prob)
            assert s._host_raw is not None and s.solve() == Status.SOLVED
        assert ts.result.info.iter == js.result.info.iter
        _close(ts.result.x, js.result.x, 1e-12, "x")
    s = SparseSolver(Settings(kkt_solver=KKTBackend.multistage, eps_abs=-1.0), device="cpu")
    s.setup(**prob)
    assert s.solve() == Status.INVALID_SETTINGS
