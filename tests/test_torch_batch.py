"""Batched solves of the PyTorch port against ``piqp_tpu.solve_batch``.

JAX vmaps its IPM with ``pallas_kernels=True``, so K1 runs in interpret
mode.  The port's batch is a leading dimension with per-problem masks;
these tests check that each problem of a batch takes exactly the
iterations JAX gives it (lockstep semantics of the nested loops), that no
reduction mixes problems (one infeasible problem leaves the others'
iteration counts unchanged), and that warm re-solves, SQP rounds and
straggler compaction match."""

import dataclasses

import jax
import numpy as np
import torch
import pytest

import piqp_tpu
from piqp_tpu import batch as jbatch
from piqp_tpu.utils.random import dense_strongly_convex_qp

import piqp_tpu_torch
from piqp_tpu_torch import prepare_batch, solve_batch, warm_from_result
from piqp_tpu_torch.types import index, index_put

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


# ---------------------------------------------------------------------------
# SQP rounds and straggler compaction against piqp_tpu.solve_batch_sqp and
# piqp_tpu.solve_batch_compact (the tests/test_batch.py problems); float64,
# statuses and iterations equal, x to rtol 1e-7 / atol 1e-9
# ---------------------------------------------------------------------------

ROUNDS = 3


def _c_rounds(c, kind):
    """Per-round costs: None (the default schedule), one (rounds, n)
    schedule for every problem, or a (B, rounds, n) one."""
    if kind == "default":
        return None
    if kind == "shared":
        return np.stack([c[0] * (1.0 + 0.005 * (r + 1)) for r in range(ROUNDS)])
    return np.stack([c * (1.0 - 0.004 * (r + 1)) for r in range(ROUNDS)], axis=1)


def _jax_warm(jres):
    return jax.tree.map(jax.numpy.asarray, jbatch.warm_from_result(jres))


@pytest.mark.parametrize("kind", ["default", "shared", "per_problem"])
def test_sqp_rounds_match_jax(cold, kind):
    probs, jres, tres = cold
    data = prepare_batch(probs, device="cpu")
    cr = _c_rounds(data.c.numpy(), kind)
    js = piqp_tpu.Settings(pallas_kernels=True)
    jw, jst, jit_ = jbatch.solve_batch_sqp(
        jbatch.prepare_batch(probs), js, rounds=ROUNDS, warm=_jax_warm(jres),
        c_rounds=None if cr is None else jax.numpy.asarray(cr))
    tw, tst, tit = piqp_tpu_torch.solve_batch_sqp(
        data, piqp_tpu_torch.Settings(), rounds=ROUNDS, warm=tres,
        c_rounds=None if cr is None else torch.as_tensor(cr))
    assert tst.shape == tit.shape == (B, ROUNDS) and tst.dtype == tit.dtype == torch.int32
    assert tst.tolist() == np.asarray(jst).tolist()
    assert np.all(np.asarray(jst) == SOLVED)
    assert tit.tolist() == np.asarray(jit_).tolist()
    for k in ("x", "y", "z_l", "z_u"):
        np.testing.assert_allclose(getattr(tw, k).numpy(), np.asarray(getattr(jw, k)),
                                   rtol=1e-7, atol=1e-9, err_msg=k)


def test_sqp_rounds_match_sequential_warm_solves(cold):
    """The rounds are the warm re-solves solve_batch gives one after the
    other with the same costs; with no warm start a cold solve comes
    first."""
    probs, _, tres = cold
    data = prepare_batch(probs, device="cpu")
    settings = piqp_tpu_torch.Settings()
    wf, st, it = piqp_tpu_torch.solve_batch_sqp(data, settings, rounds=ROUNDS, warm=tres)
    warm = warm_from_result(tres)
    for r in range(ROUNDS):
        res = solve_batch(dataclasses.replace(data, c=data.c * (1.0 + 0.01 * (r + 1))),
                          settings, warm=warm)
        warm = warm_from_result(res)
        assert it[:, r].tolist() == res.info.iter.tolist()
    np.testing.assert_allclose(wf.x.numpy(), warm.x.numpy(), rtol=0, atol=0)
    wf0, st0, it0 = piqp_tpu_torch.solve_batch_sqp(data, settings, rounds=ROUNDS)
    assert it0.tolist() == it.tolist()
    np.testing.assert_allclose(wf0.x.numpy(), wf.x.numpy(), rtol=0, atol=0)


def test_sqp_rounds_reuse_the_preconditioner(cold):
    """preconditioner_reuse_on_update scales every round with the base
    data's Ruiz scaling: every round still solves, to the same optimum."""
    probs, _, tres = cold
    data = prepare_batch(probs, device="cpu")
    wf, st, _ = piqp_tpu_torch.solve_batch_sqp(
        data, piqp_tpu_torch.Settings(), rounds=ROUNDS, warm=tres)
    wr, sr, _ = piqp_tpu_torch.solve_batch_sqp(
        data, piqp_tpu_torch.Settings(preconditioner_reuse_on_update=True), rounds=ROUNDS,
        warm=tres)
    assert sr.tolist() == st.tolist() == [[SOLVED] * ROUNDS] * B
    np.testing.assert_allclose(wr.x.numpy(), wf.x.numpy(), atol=1e-6)


def _compact_both(probs, **kw):
    jr = jbatch.solve_batch_compact(jbatch.prepare_batch(probs),
                                    piqp_tpu.Settings(pallas_kernels=True), **kw)
    tr = piqp_tpu_torch.solve_batch_compact(prepare_batch(probs, device="cpu"),
                                            piqp_tpu_torch.Settings(), **kw)
    jr = jax.tree.map(np.asarray, jr)
    assert tr.info.status.tolist() == jr.info.status.tolist()
    assert tr.info.iter.tolist() == jr.info.iter.tolist()
    np.testing.assert_allclose(tr.x.numpy(), jr.x, rtol=1e-7, atol=1e-9)
    return tr


def test_compact_matches_jax_and_one_pass():
    """Phase 1 stops at 6 iterations, short of every problem's need, so all
    24 take phase 2: the port gathers them unpadded and matches JAX's
    padded phase 2; every problem meets the one-pass solve's status and
    optimum, its iterations count both phases, and a chunked phase 1
    changes nothing."""
    probs = [dense_strongly_convex_qp(24, 8, 12, seed=300 + i) for i in range(24)]
    rc = _compact_both(probs, phase1_iters=6)
    data = prepare_batch(probs, device="cpu")
    r1 = solve_batch(data)
    assert rc.info.status.tolist() == r1.info.status.tolist() == [SOLVED] * 24
    np.testing.assert_allclose(rc.x.numpy(), r1.x.numpy(), atol=1e-6)
    assert int(rc.info.iter.min()) > 6
    rk = piqp_tpu_torch.solve_batch_compact(data, phase1_iters=6, chunk=8)
    assert rk.info.iter.tolist() == rc.info.iter.tolist()
    np.testing.assert_allclose(rk.x.numpy(), rc.x.numpy(), rtol=0, atol=0)
    rw = piqp_tpu_torch.solve_batch_compact(
        dataclasses.replace(data, c=data.c * 1.01), warm=r1, phase1_iters=3)
    assert rw.info.status.tolist() == [SOLVED] * 24


def test_compact_short_circuits_when_all_converge():
    probs = [dense_strongly_convex_qp(12, 4, 6, seed=400 + i) for i in range(8)]
    rc = _compact_both(probs, phase1_iters=200)
    assert rc.info.status.tolist() == [SOLVED] * 8


def test_compact_keeps_the_infeasible_problem():
    """The primal infeasible problem gets the full budget in phase 2 and
    comes back certified, as in JAX."""
    probs = [dense_strongly_convex_qp(12, 4, 6, seed=500 + i) for i in range(7)]
    bad = dense_strongly_convex_qp(12, 4, 6, seed=599)
    bad["A"] = np.vstack([bad["A"][:2], bad["A"][:2]])
    bad["b"] = np.concatenate([bad["b"][:2], bad["b"][:2] + 1.0])
    rc = _compact_both(probs + [bad], phase1_iters=4)
    assert rc.info.status.tolist() == [SOLVED] * 7 + [
        int(piqp_tpu_torch.Status.PRIMAL_INFEASIBLE)]


def test_index_put_scatters_every_field(cold):
    _, _, tres = cold
    idx = torch.tensor([1, 6])
    part = index(tres, idx)
    part = dataclasses.replace(part, x=part.x + 1.0, info=dataclasses.replace(
        part.info, iter=part.info.iter + 100))
    out = index_put(tres, idx, part)
    assert out.info.iter.tolist() == [int(v) + 100 * (i in (1, 6))
                                      for i, v in enumerate(tres.info.iter)]
    np.testing.assert_allclose((out.x - tres.x)[:, 0].numpy(),
                               [float(i in (1, 6)) for i in range(B)])
    assert out.y is not tres.y and torch.equal(out.y, tres.y)
