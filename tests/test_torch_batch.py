"""Batched solves of the PyTorch port against ``piqp_tpu.solve_batch``.

JAX vmaps its IPM with ``pallas_kernels=True``, so K1 runs in interpret
mode.  The port's batch is a leading dimension with per-problem masks;
these tests check that each problem of a batch takes exactly the
iterations JAX gives it (lockstep semantics of the nested loops), that no
reduction mixes problems (one infeasible problem leaves the others'
iteration counts unchanged), and that warm re-solves match."""

import jax
import numpy as np
import torch
import pytest

import piqp_tpu
from piqp_tpu import batch as jbatch
from piqp_tpu.utils.random import dense_strongly_convex_qp

import piqp_tpu_torch
from piqp_tpu_torch import prepare_batch, solve_batch, warm_from_result
from piqp_tpu_torch.types import index

from helpers import check_optimality

B, DIMS = 8, (16, 4, 8)
SOLVED = int(piqp_tpu_torch.Status.SOLVED)


def _problems():
    return [dense_strongly_convex_qp(*DIMS, seed=100 + i) for i in range(B)]


def _infeasible(probs, i):
    """Problem i gets two parallel equality rows with different sides."""
    probs = [dict(p) for p in probs]
    A, b = probs[i]["A"].copy(), probs[i]["b"].copy()
    A[1], b[1] = A[0], b[0] + 1.0
    probs[i].update(A=A, b=b)
    return probs


def _both(probs, warm_pair=None, **kw):
    js = piqp_tpu.Settings(pallas_kernels=True, **kw)
    ts = piqp_tpu_torch.Settings(**kw)
    jw, tw = warm_pair if warm_pair else (None, None)
    jres = jbatch.solve_batch(jbatch.prepare_batch(probs), js, warm=jw)
    tres = solve_batch(prepare_batch(probs, device="cpu"), ts, warm=tw)
    return jax.tree.map(np.asarray, jres), tres


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} x {scale:.3e}"


def _assert_parity(jres, tres, tol=1e-8):
    assert tres.info.status.tolist() == jres.info.status.tolist()
    assert tres.info.iter.tolist() == jres.info.iter.tolist()
    for i in range(B):
        if jres.info.status[i] != SOLVED:
            continue
        _close(tres.x[i].numpy(), jres.x[i], tol, f"x[{i}]")
        _close(tres.y[i].numpy(), jres.y[i], tol, f"y[{i}]")
        _close((tres.z_u - tres.z_l)[i].numpy(), (jres.z_u - jres.z_l)[i], tol,
               f"z_u - z_l [{i}]")


@pytest.fixture(scope="module")
def cold():
    probs = _problems()
    jres, tres = _both(probs)
    return probs, jres, tres


def test_batch_matches_jax(cold):
    probs, jres, tres = cold
    assert tres.info.status.tolist() == [SOLVED] * B
    _assert_parity(jres, tres)
    for i, prob in enumerate(probs):
        check_optimality(prob, index(tres, i), tol=1e-6)


def test_batch_matches_single_solves(cold):
    probs, _, tres = cold
    for i in (0, 5):
        one = piqp_tpu_torch.solve_dense(**probs[i], device="cpu")
        assert int(one.info.iter) == int(tres.info.iter[i])
        np.testing.assert_allclose(tres.x[i].numpy(), one.x.numpy(), rtol=1e-9, atol=1e-9)


def test_chunked_batch_matches_unchunked(cold):
    probs, _, tres = cold
    res = solve_batch(prepare_batch(probs, device="cpu"), piqp_tpu_torch.Settings(), chunk=3)
    assert res.info.iter.tolist() == tres.info.iter.tolist()
    np.testing.assert_allclose(res.x.numpy(), tres.x.numpy(), rtol=1e-9, atol=1e-9)


def test_warm_resolve_matches_jax(cold):
    probs, jres, tres = cold
    rng = np.random.default_rng(7)
    moved = [dict(p, c=p["c"] + 1e-3 * rng.standard_normal(DIMS[0])) for p in probs]
    jw = jbatch.warm_from_result(jax.tree.map(np.asarray, jres))
    jw = jax.tree.map(jax.numpy.asarray, jw)
    jwarm, twarm = _both(moved, warm_pair=(jw, warm_from_result(tres)))
    assert twarm.info.status.tolist() == [SOLVED] * B
    assert int(twarm.info.iter.sum()) < int(tres.info.iter.sum())
    _assert_parity(jwarm, twarm)


def test_infeasible_problem_leaves_the_others_alone(cold):
    """Per-problem reductions and lockstep loops: problem 3 turns primal
    infeasible and keeps its own delta up, while every other problem
    keeps the iteration count and solution it had in the all-feasible
    batch, and the port matches JAX on all of them."""
    probs, _, tres = cold
    jbad, tbad = _both(_infeasible(probs, 3))
    assert int(tbad.info.status[3]) == int(piqp_tpu_torch.Status.PRIMAL_INFEASIBLE)
    assert float(tbad.info.delta[3]) > 100 * float(tbad.info.delta[0])
    _assert_parity(jbad, tbad)
    others = [i for i in range(B) if i != 3]
    assert tbad.info.iter[others].tolist() == tres.info.iter[others].tolist()
    np.testing.assert_allclose(tbad.x[others].numpy(), tres.x[others].numpy(),
                               rtol=1e-9, atol=1e-9)


def test_mixed_precision_batch_matches_jax():
    probs = _problems()
    jres, tres = _both(probs, mixed_precision=True)
    assert tres.info.status.tolist() == jres.info.status.tolist() == [SOLVED] * B
    diff = np.abs(tres.info.iter.numpy() - jres.info.iter)
    assert diff.max() <= 2, (tres.info.iter.tolist(), jres.info.iter.tolist())
    np.testing.assert_allclose(tres.x.numpy(), jres.x, atol=1e-6)


def test_factor_ladder_is_per_problem():
    """The numerics-recovery ladder against JAX's under vmap.  Problem 1
    has negative slacks, which zero its z_reg: only the ladder's first rung
    (static regularization with refinement) repairs its factor.  Problem 2
    has rho = -50, so its condensed matrix stays indefinite through every
    rho/delta boost and it fails after max_factor_retires.  Problem 0 keeps
    its first factorization and regularization throughout."""
    from piqp_tpu import kkt as jkkt, solver as jsolver
    from piqp_tpu.types import Vars as JVars, init_info as jinit_info

    from piqp_tpu_torch import convert, kkt as tkkt, solver as tsolver

    probs = [dense_strongly_convex_qp(10, 2, 6, seed=40 + i) for i in range(3)]
    rng = np.random.default_rng(3)
    jdata = jbatch.prepare_batch(probs)
    masks = dict(z_l=jdata.hl_mask, z_u=jdata.hu_mask, z_bl=jdata.xl_mask,
                 z_bu=jdata.xu_mask, s_l=jdata.hl_mask, s_u=jdata.hu_mask,
                 s_bl=jdata.xl_mask, s_bu=jdata.xu_mask)
    v = dict(x=rng.standard_normal((3, 10)), y=rng.standard_normal((3, 2)))
    for k, mask in masks.items():
        v[k] = np.where(np.asarray(mask), rng.uniform(0.5, 2.0, mask.shape), 0.0)
    v["s_l"][1] = np.where(np.asarray(jdata.hl_mask[1]), -0.3, 0.0)
    v["s_u"][1] = np.where(np.asarray(jdata.hu_mask[1]), -0.3, 0.0)
    rho = np.array([1e-6, 1e-6, -50.0])

    js = piqp_tpu.Settings(pallas_kernels=True)
    jvars = JVars(**{k: jax.numpy.asarray(a) for k, a in v.items()})

    def jladder(d, vv, r):
        info = jinit_info(js, d.c.dtype).replace(rho=r)
        ks, info, ir, failed = jsolver.factor_ladder(
            d, js, jax.numpy.diagonal(d.P), vv, info, jax.numpy.asarray(False),
            False, jkkt.precompute(d))
        return info, ir, failed

    jinfo, jir, jfailed = jax.tree.map(
        np.asarray, jax.vmap(jladder)(jdata, jvars, jax.numpy.asarray(rho)))

    ts = piqp_tpu_torch.Settings()
    tdata = convert.qpdata(jax.tree.map(np.asarray, jdata), batched=True)
    tinfo0 = piqp_tpu_torch.types.init_info(ts, 3, tdata.c.dtype, "cpu")
    tinfo0.rho = torch.as_tensor(rho)
    _, tinfo, tir, tfailed = tsolver.factor_ladder(
        tdata, ts, torch.diagonal(tdata.P, dim1=-2, dim2=-1),
        convert.vars_(jax.tree.map(np.asarray, jvars), batched=True),
        tinfo0, torch.zeros(3, dtype=torch.bool), False, tkkt.precompute(tdata),
    )
    assert tir.tolist() == jir.tolist() == [False, True, True]
    assert tfailed.tolist() == jfailed.tolist() == [False, False, True]
    for name in ("rho", "delta", "reg_limit", "factor_retires"):
        np.testing.assert_allclose(getattr(tinfo, name).numpy(), getattr(jinfo, name),
                                   rtol=1e-15, err_msg=name)
    assert tinfo.factor_retires.tolist() == [0, 0, ts.max_factor_retires]
    assert tinfo.delta[:2].tolist() == [ts.delta_init] * 2
