"""Differentiable solves of the PyTorch port (``piqp_tpu_torch/diff.py``)
against the JAX package's ``solve_qp_diff``, and on the port alone
against central finite differences.

JAX's references are computed once per module (two grad-of-solve
compiles, the JAX suite's largest).  Tolerances: dense gradients of every
float field rtol 1e-7 / atol 1e-9 against JAX; stage gradients of every
float field (the stage blocks included) rtol 1e-6 / atol 1e-8 (the stage adjoint factors a δ-softened system and refines it
4 times, in a different factor representation in each package); finite
differences as ``tests/test_diff.py`` holds JAX: rel 2e-4 / abs 5e-6 (5e-4
for dual cotangents and stage blocks), solved to eps_abs = 1e-11."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piqp_tpu import multistage as jms
from piqp_tpu.api import prepare_data as jprepare
from piqp_tpu.diff import solve_qp_diff as jsolve_qp_diff

import piqp_tpu_torch
from piqp_tpu_torch import Settings, Status, convert, prepare_batch, qp_layer, solve_qp_diff
from piqp_tpu_torch.api import has_cone, prepare_data
from piqp_tpu_torch.multistage import random_multistage_qp

from test_diff import TIGHT as JTIGHT, _nondegenerate_qp

TIGHT = Settings(eps_abs=1e-11, eps_rel=1e-12)
DENSE_FIELDS = ("P", "c", "A", "b", "G", "h_l", "h_u", "x_l", "x_u", "x_b_scaling")
STAGE_DIMS = dict(T=6, D=3, Da=2, ra=1, rg=2)
STAGE_FIELDS = ("c", "b", "h_l", "h_u", "x_l", "x_u", "x_b_scaling", "Pd", "Psub", "Pa",
                "Pc", "A1", "A2", "Ag", "G1", "G2", "Gg")


def _grads(data, loss, fields):
    """Gradients of ``loss(data)`` in ``fields``, each a fresh leaf."""
    leaves = {k: getattr(data, k).detach().clone().requires_grad_() for k in fields}
    value = loss(dataclasses.replace(data, **leaves))
    value.backward()
    return {k: v.grad for k, v in leaves.items()}


def _fd(loss, data, field, D, eps=1e-6):
    with torch.no_grad():
        f = getattr(data, field)
        up = loss(dataclasses.replace(data, **{field: f + eps * D}))
        dn = loss(dataclasses.replace(data, **{field: f - eps * D}))
    return float((up - dn) / (2 * eps))


def _prep(seed, **kw):
    prob, xs = _nondegenerate_qp(seed=seed, **kw)
    data = prepare_data(**prob, device="cpu")
    return prob, data


@pytest.fixture(scope="module")
def dense_pair():
    """Port and JAX gradients of v . x on _nondegenerate_qp(seed=0)."""
    prob, _ = _nondegenerate_qp(seed=0)
    v = np.random.default_rng(7).standard_normal(6)
    jdata = jprepare(**prob)
    jv = jnp.asarray(v)
    jg = jax.grad(lambda d: jv @ jsolve_qp_diff(d, JTIGHT, True).x, allow_int=True)(jdata)
    data = prepare_data(**prob, device="cpu")
    tv = torch.as_tensor(v)[None]
    tg = _grads(data, lambda d: (tv * solve_qp_diff(d, TIGHT, True).x).sum(), DENSE_FIELDS)
    return {k: np.asarray(getattr(jg, k)) for k in DENSE_FIELDS}, tg


@pytest.fixture(scope="module")
def stage_pair():
    """Port and JAX gradients of sum(x^2) on a stage problem, in every
    float field."""
    jdata = jms.random_multistage_qp(**STAGE_DIMS, seed=3)
    jg = jax.grad(lambda d: jnp.sum(jsolve_qp_diff(d, JTIGHT, True).x ** 2),
                  allow_int=True)(jdata)
    data = convert.qpdata(jax.tree.map(np.asarray, jdata))
    tg = _grads(data, lambda d: (solve_qp_diff(d, TIGHT, True).x ** 2).sum(), STAGE_FIELDS)
    return data, {k: np.asarray(getattr(jg, k)) for k in STAGE_FIELDS}, tg


@pytest.mark.parametrize("field", DENSE_FIELDS)
def test_dense_gradient_matches_jax(dense_pair, field):
    jg, tg = dense_pair
    np.testing.assert_allclose(tg[field][0].numpy(), jg[field], rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("field", STAGE_FIELDS)
def test_stage_gradient_matches_jax(stage_pair, field):
    data, jg, tg = stage_pair
    assert tg[field].shape == getattr(data, field).shape
    np.testing.assert_allclose(tg[field][0].numpy(), jg[field], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("seed", [0, 3])
def test_x_gradients_match_fd(seed):
    _, data = _prep(seed)
    v = torch.as_tensor(np.random.default_rng(seed + 7).standard_normal(data.n))[None]

    def loss(d):
        return (v * solve_qp_diff(d, TIGHT, True).x).sum()

    rng = np.random.default_rng(seed + 13)
    n, p, m = data.n, data.p, data.m
    checks = {
        "c": rng.standard_normal(n),
        "b": rng.standard_normal(p),
        "A": rng.standard_normal((p, n)),
        "G": rng.standard_normal((m, n)),
        "h_u": rng.standard_normal(m) * data.hu_mask[0].numpy(),
        "h_l": rng.standard_normal(m) * data.hl_mask[0].numpy(),
        "x_u": rng.standard_normal(n) * data.xu_mask[0].numpy(),
        "x_l": rng.standard_normal(n) * data.xl_mask[0].numpy(),
    }
    M = rng.standard_normal((n, n))
    checks["P"] = M + M.T  # P stays symmetric
    g = _grads(data, loss, tuple(checks))
    for field, D in checks.items():
        D = torch.as_tensor(D)[None]
        ana = float((g[field] * D).sum())
        assert _fd(loss, data, field, D) == pytest.approx(ana, rel=2e-4, abs=5e-6), field


def test_dual_cotangents_flow():
    _, data = _prep(1)
    rng = np.random.default_rng(5)
    vy = torch.as_tensor(rng.standard_normal(data.p))[None]
    vz = torch.as_tensor(rng.standard_normal(data.m))[None]

    def loss(d):
        w = solve_qp_diff(d, TIGHT, True)
        return (vy * w.y).sum() + (vz * (w.z_u - w.z_l)).sum()

    g = _grads(data, loss, ("c", "b", "h_u"))
    for field in ("c", "b", "h_u"):
        D = torch.as_tensor(rng.standard_normal(getattr(data, field).shape))
        if field == "h_u":
            D = D * data.hu_mask
        ana = float((g[field] * D).sum())
        assert _fd(loss, data, field, D) == pytest.approx(ana, rel=5e-4, abs=5e-6), field


def test_equality_only():
    _, data = _prep(2, p=3, m=0, box=False)
    assert not has_cone(data)

    def loss(d):
        return (solve_qp_diff(d, TIGHT, False).x ** 2).sum()

    g = _grads(data, loss, ("c", "b"))
    rng = np.random.default_rng(11)
    for field in ("c", "b"):
        D = torch.as_tensor(rng.standard_normal(getattr(data, field).shape))
        ana = float((g[field] * D).sum())
        assert _fd(loss, data, field, D) == pytest.approx(ana, rel=2e-4, abs=5e-6), field


def test_batch_matches_one_at_a_time():
    """A batch of three problems differentiates like each problem alone:
    nothing in the forward or the adjoint mixes problems."""
    probs = [_nondegenerate_qp(seed=s)[0] for s in (4, 5, 6)]
    fields = ("c", "b", "h_u", "P")

    def loss(d):
        return (solve_qp_diff(d, TIGHT, True).x ** 2).sum()

    gb = _grads(prepare_batch(probs, device="cpu"), loss, fields)
    for i, prob in enumerate(probs):
        g1 = _grads(prepare_data(**prob, device="cpu"), loss, fields)
        for k in fields:
            np.testing.assert_allclose(gb[k][i].numpy(), g1[k][0].numpy(), atol=1e-8,
                                       err_msg=f"{k}[{i}]")


def test_jacobian_matches_fd():
    """``torch.autograd.functional.jacobian`` (a loop of VJPs, the
    counterpart of ``jax.jacrev``) gives dx*/dc; its product with a
    direction matches finite differences.  dx*/dc is nonzero here: the
    box-free problem has fewer active constraints than variables."""
    _, data = _prep(5, box=False)

    def xstar(c):
        return solve_qp_diff(dataclasses.replace(data, c=c[None]), TIGHT, True).x[0]

    J = torch.autograd.functional.jacobian(xstar, data.c[0], vectorize=False)
    assert J.shape == (data.n, data.n) and float(J.abs().max()) > 1e-3
    D = torch.as_tensor(np.random.default_rng(23).standard_normal(data.n))
    eps = 1e-6
    with torch.no_grad():
        fd = (xstar(data.c[0] + eps * D) - xstar(data.c[0] - eps * D)) / (2 * eps)
    np.testing.assert_allclose((J @ D).numpy(), fd.numpy(), atol=1e-5, rtol=1e-4)


def test_stage_block_gradient_matches_fd(stage_pair):
    data, _, tg = stage_pair

    def loss(d):
        return (solve_qp_diff(d, TIGHT, True).x ** 2).sum()

    Draw = torch.as_tensor(np.random.default_rng(31).standard_normal(data.Pd.shape))
    D = (Draw + Draw.mT) / 2  # the blocks stay symmetric
    ana = float((tg["Pd"] * D).sum())
    assert _fd(loss, data, "Pd", D) == pytest.approx(ana, rel=5e-4, abs=5e-6)
    Dc = torch.as_tensor(np.random.default_rng(9).standard_normal(data.c.shape))
    ana = float((tg["c"] * Dc).sum())
    assert _fd(loss, data, "c", Dc) == pytest.approx(ana, rel=5e-4, abs=5e-6)


def test_stage_batch_matches_one_at_a_time():
    """Two stage problems in one batch get the gradients each gets alone."""
    from piqp_tpu_torch.multistage import random_multistage_batch

    batch = random_multistage_batch([11, 12], **STAGE_DIMS, device="cpu")

    def loss(d):
        return (solve_qp_diff(d, TIGHT, True).x ** 2).sum()

    gb = _grads(batch, loss, ("c", "Pd"))
    for i, seed in enumerate((11, 12)):
        g1 = _grads(random_multistage_qp(**STAGE_DIMS, seed=seed, device="cpu"), loss,
                    ("c", "Pd"))
        for k in ("c", "Pd"):
            np.testing.assert_allclose(gb[k][i].numpy(), g1[k][0].numpy(), atol=1e-8)


def test_qp_layer():
    """qp_layer: the prepared data and a differentiable solve; on an
    equality-constrained QP d sum(x*)/dc has the closed form -sum over
    the columns of the reduced KKT inverse."""
    P = np.array([[6.0, 0.0], [0.0, 4.0]])
    c = np.array([-1.0, -4.0])
    A = np.array([[1.0, -2.0]])
    b = np.array([0.0])
    solve, data = qp_layer(P, c, A, b, device="cpu")
    assert isinstance(data, piqp_tpu_torch.QPData) and data.B == 1
    data.c.requires_grad_()
    x = solve(data)
    np.testing.assert_allclose(x.detach()[0].numpy(), [0.42857143, 0.21428571], atol=1e-7)
    x.sum().backward()
    Kinv = np.linalg.inv(np.block([[P, A.T], [A, np.zeros((1, 1))]]))
    np.testing.assert_allclose(data.c.grad[0].numpy(), -(Kinv[:2, :2].T @ np.ones(2)),
                               atol=1e-8)


def test_forward_is_the_plain_solve():
    """The forward pass returns the solution the plain solve gives, and
    no gradient is needed to call it."""
    prob, data = _prep(0)
    w = solve_qp_diff(data, TIGHT, True)
    res = piqp_tpu_torch.solve_dense(**prob, settings=dataclasses.replace(
        TIGHT, refine_mu_factor=0.0), device="cpu")
    assert int(res.info.status) == int(Status.SOLVED)
    np.testing.assert_allclose(w.x[0].numpy(), res.x.numpy(), atol=1e-12)
    np.testing.assert_allclose(w.x[0].numpy(), _nondegenerate_qp(seed=0)[1], atol=1e-7)
