"""The full-KKT dense backends of the PyTorch port (``dense_ldlt`` and
``dense_lu``) against the JAX package: the blocked signed Cholesky of
``ops/ldlt.py``, the KKT factor and solve from the same state, and batched
solves end to end.  JAX runs its Pallas kernels in interpret mode
(``pallas_kernels=True`` under ``vmap``) and the port its plain versions.

Tolerances: float64 end to end, status and iteration count equal, x to
1e-8 and y to 1e-6 (scaled by max(1, |x|)); mixed precision, status equal
and x to 1e-4 (ROADMAP Queue 3: the float32 phase rounds differently in
the two frameworks); factorizations to 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import piqp_tpu
from piqp_tpu import batch as jbatch
from piqp_tpu import kkt as jkkt
from piqp_tpu.ops import ldlt as jldlt
from piqp_tpu.types import Vars as JVars
from piqp_tpu.utils.random import dense_strongly_convex_qp

import piqp_tpu_torch
from piqp_tpu_torch import convert, prepare_batch, solve_batch
from piqp_tpu_torch import kkt as tkkt
from piqp_tpu_torch.api import _route_backend
from piqp_tpu_torch.ops import ldlt
from piqp_tpu_torch.types import FullKKTQPData, LDLTKKTQPData, QPData, index

from helpers import check_optimality

SOLVED = int(piqp_tpu_torch.Status.SOLVED)


def _quasidef(N, npos, seed):
    rng = np.random.default_rng(seed)
    Mp = rng.standard_normal((npos, npos))
    Mn = rng.standard_normal((N - npos, N - npos))
    Kb = rng.standard_normal((N - npos, npos))
    K = np.block([[Mp @ Mp.T + npos * np.eye(npos), Kb.T],
                  [Kb, -(Mn @ Mn.T + (N - npos) * np.eye(N - npos))]])
    return K, np.concatenate([np.ones(npos), -np.ones(N - npos)])


@pytest.mark.parametrize("N,npos,block", [(32, 20, 16), (48, 30, 16), (64, 40, 32)])
def test_signed_cholesky_matches_jax(N, npos, block):
    Ks = [_quasidef(N, npos, seed=N + npos + i) for i in range(2)]
    K = np.stack([k for k, _ in Ks])
    s = Ks[0][1]
    Lj, Linvs_j = jax.vmap(lambda k: jldlt.signed_cholesky(k, jnp.asarray(s), block))(
        jnp.asarray(K))
    Lt, Linvs_t = ldlt.signed_cholesky(torch.as_tensor(K), torch.as_tensor(s), block)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(Linvs_t.numpy(), np.asarray(Linvs_j), atol=1e-10, rtol=1e-10)
    L = Lt.numpy()
    np.testing.assert_allclose((L * s) @ np.swapaxes(L, 1, 2), K, atol=1e-9 * np.abs(K).max())


@pytest.mark.parametrize("N,npos", [(32, 12), (64, 50)])
def test_signed_solve_matches_jax_and_numpy(N, npos):
    K, s = _quasidef(N, npos, seed=7 * N)
    b = np.random.default_rng(3).standard_normal(N)
    Lj, Lij = jldlt.signed_cholesky(jnp.asarray(K), jnp.asarray(s), 16)
    xj = np.asarray(jldlt.signed_solve(Lj, Lij, jnp.asarray(s), jnp.asarray(b)))
    Lt, Lit = ldlt.signed_cholesky(torch.as_tensor(K)[None], torch.as_tensor(s), 16)
    xt = ldlt.signed_solve(Lt, Lit, torch.as_tensor(s), torch.as_tensor(b)[None])[0].numpy()
    np.testing.assert_allclose(xt, xj, atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(xt, np.linalg.solve(K, b), atol=1e-8)


def test_indefinite_pivot_flags_nonfinite():
    """A matrix violating the declared sign pattern gives NaN for its
    problem only (the ok=False signal of the regularization ladder)."""
    K = np.stack([_quasidef(32, 16, seed=1)[0], -np.eye(32)])
    s = np.concatenate([np.ones(16), -np.ones(16)])
    L, Linvs = ldlt.signed_cholesky(torch.as_tensor(K), torch.as_tensor(s), 16)
    fin = torch.isfinite(L).flatten(1).all(1) & torch.isfinite(Linvs).flatten(1).all(1)
    assert fin.tolist() == [True, False]


def test_padding_and_signs_match_jax():
    K = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 5, 5)))
    Kp = ldlt.pad_quasidef(K, 8)
    want = jax.vmap(lambda k: jldlt.pad_quasidef(k, 8))(jnp.asarray(K.numpy()))
    np.testing.assert_array_equal(Kp.numpy(), np.asarray(want))
    assert ldlt.padded_dim(70) == jldlt.padded_dim(70) == 128
    assert ldlt.padded_dim(3, 16) == jldlt.padded_dim(3, 16) == 16
    np.testing.assert_array_equal(
        ldlt.kkt_signs(3, 2, 4, 16, torch.float64, "cpu").numpy(),
        np.asarray(jldlt.kkt_signs(3, 2, 4, 16, jnp.float64)))


def test_route_backend_picks_the_data_type():
    prob = dense_strongly_convex_qp(8, 2, 4, seed=5)
    data = prepare_batch([prob], device="cpu")
    S, B = piqp_tpu_torch.Settings, piqp_tpu_torch.KKTBackend
    assert type(_route_backend(data, S(kkt_solver=B.dense_lu))) is FullKKTQPData
    assert type(_route_backend(data, S(kkt_solver=B.dense_ldlt))) is LDLTKKTQPData
    assert type(_route_backend(data, S(kkt_solver=B.multistage))) is QPData
    assert type(_route_backend(data, S())) is QPData
    # as in JAX, dense data given sparse_host keeps the condensed backend
    from piqp_tpu.api import _route_backend as jroute

    assert type(_route_backend(data, S(kkt_solver=B.sparse_host))) is QPData
    jdata = jbatch.prepare_batch([prob])
    assert type(jroute(jdata, piqp_tpu.Settings(
        kkt_solver=piqp_tpu.KKTBackend.sparse_host))) is type(jdata)


@pytest.mark.parametrize(
    "backend,inverse", [("dense_ldlt", True), ("dense_ldlt", False), ("dense_lu", True)])
def test_kkt_factor_and_solve_match_jax(backend, inverse):
    """From the same JAX state: the full-KKT factor and the refined KKT
    solve of the port agree with JAX's to 1e-10 (dense_lu has one
    representation)."""
    probs = [dense_strongly_convex_qp(12, 3, 7, seed=60 + i) for i in range(2)]
    js = piqp_tpu.Settings(kkt_solver=piqp_tpu.KKTBackend(backend), pallas_kernels=inverse)
    from piqp_tpu.api import _route_backend as jroute

    jdata = jroute(jbatch.prepare_batch(probs), js)
    rng = np.random.default_rng(8)
    masks = dict(z_l=jdata.hl_mask, z_u=jdata.hu_mask, z_bl=jdata.xl_mask,
                 z_bu=jdata.xu_mask, s_l=jdata.hl_mask, s_u=jdata.hu_mask,
                 s_bl=jdata.xl_mask, s_bu=jdata.xu_mask)
    v = dict(x=rng.standard_normal((2, 12)), y=rng.standard_normal((2, 3)))
    for k, mask in masks.items():
        v[k] = np.where(np.asarray(mask), rng.uniform(0.5, 2.0, mask.shape), 0.0)
    r = {k: rng.standard_normal(a.shape) for k, a in v.items()}
    jvars = JVars(**{k: jnp.asarray(a) for k, a in v.items()})
    jrhs = JVars(**{k: jnp.asarray(a) for k, a in r.items()})

    def jrun(d, vv, rr):
        ks = jkkt.compute_scalings(d, js, vv, 1e-6, 1e-4, jnp.asarray(False),
                                   jnp.diagonal(d.P))
        ks, ok = jkkt.factor(d, ks)
        lhs, ok2 = jkkt.solve(d, js, ks, rr)
        return ks, lhs

    jks, jlhs = jax.tree.map(np.asarray, jax.vmap(jrun)(jdata, jvars, jrhs))

    ts = piqp_tpu_torch.Settings(kkt_solver=piqp_tpu_torch.KKTBackend(backend),
                                 pallas_kernels=inverse)
    tdata = _route_backend(convert.qpdata(jax.tree.map(np.asarray, jdata), batched=True), ts)
    tvars = convert.vars_(jax.tree.map(np.asarray, jvars), batched=True)
    ks = tkkt.compute_scalings(tdata, ts, tvars, torch.full((2,), 1e-6, dtype=torch.float64),
                               torch.full((2,), 1e-4, dtype=torch.float64), torch.zeros(2, dtype=torch.bool),
                               torch.diagonal(tdata.P, dim1=-2, dim2=-1))
    ks, ok = tkkt.factor(tdata, ks, inverse=inverse)
    assert ok.tolist() == [True, True]
    # the JAX factor carried over reproduces the port's factor
    jks_t = convert.kkt_state(jks, batched=True, condensed=False)
    for got, want in zip(ks.factor, jks_t.factor):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-10, rtol=1e-10)
    lhs, ok = tkkt.solve(tdata, ts, ks, convert.vars_(jax.tree.map(np.asarray, jrhs), batched=True))
    # and solving from the JAX factor gives the same step
    lhs2, _ = tkkt.solve(tdata, ts, jks_t,
                         convert.vars_(jax.tree.map(np.asarray, jrhs), batched=True))
    for name in ("x", "y", "z_l", "z_u", "s_l", "z_bl"):
        want = getattr(jlhs, name)
        np.testing.assert_allclose(getattr(lhs, name).numpy(), want, atol=1e-10, rtol=1e-8)
        np.testing.assert_allclose(getattr(lhs2, name).numpy(), want, atol=1e-10, rtol=1e-8)


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} x {scale:.3e}"


def _both(probs, **kw):
    js = piqp_tpu.Settings(**{k: (piqp_tpu.KKTBackend(v) if k == "kkt_solver" else v)
                              for k, v in kw.items()})
    ts = piqp_tpu_torch.Settings(**{
        k: (piqp_tpu_torch.KKTBackend(v) if k == "kkt_solver" else v)
        for k, v in kw.items()})
    jres = jax.tree.map(np.asarray, jbatch.solve_batch(jbatch.prepare_batch(probs), js))
    tres = solve_batch(prepare_batch(probs, device="cpu"), ts)
    return jres, tres


@pytest.mark.parametrize("dims", [(10, 4, 6), (16, 0, 10), (12, 5, 0), (30, 11, 23)])
def test_dense_ldlt_batch_matches_jax(dims):
    probs = [dense_strongly_convex_qp(*dims, seed=sum(dims) + i) for i in range(2)]
    jres, tres = _both(probs, kkt_solver="dense_ldlt", pallas_kernels=True)
    assert tres.info.status.tolist() == jres.info.status.tolist() == [SOLVED] * 2
    assert tres.info.iter.tolist() == jres.info.iter.tolist()
    for i, prob in enumerate(probs):
        _close(tres.x[i].numpy(), jres.x[i], 1e-8, f"x[{i}]")
        _close(tres.y[i].numpy(), jres.y[i], 1e-6, f"y[{i}]")
        check_optimality(prob, index(tres, i), tol=1e-6)


@pytest.mark.parametrize("backend,pallas", [("dense_ldlt", False), ("dense_lu", True)])
def test_full_kkt_batch_matches_jax(backend, pallas):
    """The blocked representation of dense_ldlt and the LU backend."""
    probs = [dense_strongly_convex_qp(14, 4, 9, seed=200 + i) for i in range(3)]
    jres, tres = _both(probs, kkt_solver=backend, pallas_kernels=pallas)
    assert tres.info.status.tolist() == jres.info.status.tolist() == [SOLVED] * 3
    assert tres.info.iter.tolist() == jres.info.iter.tolist()
    for i in range(3):
        _close(tres.x[i].numpy(), jres.x[i], 1e-8, f"x[{i}]")
        _close(tres.y[i].numpy(), jres.y[i], 1e-6, f"y[{i}]")


@pytest.mark.parametrize("backend", ["dense_ldlt", "dense_lu"])
def test_full_kkt_mixed_precision_matches_jax(backend):
    probs = [dense_strongly_convex_qp(14, 4, 9, seed=300 + i) for i in range(3)]
    jres, tres = _both(probs, kkt_solver=backend, pallas_kernels=True, mixed_precision=True)
    assert tres.info.status.tolist() == jres.info.status.tolist() == [SOLVED] * 3
    np.testing.assert_allclose(tres.x.numpy(), jres.x, atol=1e-4)
    for i, prob in enumerate(probs):
        check_optimality(prob, index(tres, i), tol=1e-6)


def test_dense_ldlt_matches_condensed_backend():
    """The full-KKT and condensed backends of the port reach the same
    optimum (test_ldlt.py's cross-backend gate)."""
    prob = dense_strongly_convex_qp(20, 6, 9, seed=17)
    S, B = piqp_tpu_torch.Settings, piqp_tpu_torch.KKTBackend
    r_chol = piqp_tpu_torch.solve_dense(**prob, device="cpu")
    for backend in (B.dense_ldlt, B.dense_lu):
        r = piqp_tpu_torch.solve_dense(**prob, settings=S(kkt_solver=backend), device="cpu")
        assert int(r.info.status) == SOLVED
        np.testing.assert_allclose(r.x.numpy(), r_chol.x.numpy(), atol=1e-7, rtol=1e-7)
        np.testing.assert_allclose(r.y.numpy(), r_chol.y.numpy(), atol=1e-6, rtol=1e-6)


def test_dense_solver_ldlt_update_and_warm_start():
    prob = dense_strongly_convex_qp(12, 3, 6, seed=21)
    s = piqp_tpu_torch.DenseSolver(
        piqp_tpu_torch.Settings(kkt_solver=piqp_tpu_torch.KKTBackend.dense_ldlt), device="cpu")
    s.setup(**prob)
    assert s.solve() == piqp_tpu_torch.Status.SOLVED
    cold_iter = int(s.result.info.iter)
    c2 = prob["c"] + 1e-3 * np.random.default_rng(2).standard_normal(12)
    s.update(c=c2)
    assert s.solve(warm_start=True) == piqp_tpu_torch.Status.SOLVED
    assert int(s.result.info.iter) < cold_iter
    check_optimality(dict(prob, c=c2), s.result, tol=1e-6)
