"""KKT layer of the PyTorch port against ``piqp_tpu.kkt``.

Both packages start from the same batched KKTState (built by the JAX
package and carried over by convert.py), factor it and solve the same
right-hand sides.  JAX runs vmapped, so with ``pallas_kernels=True`` its
factor goes through the Pallas kernel in interpret mode.  Tolerances:
1e-10 in float64, 1e-4 when the factor is float32 (mixed)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import piqp_tpu
from piqp_tpu import kkt as jkkt
from piqp_tpu.types import Vars as JVars

from piqp_tpu_torch import Settings, convert, prepare_batch
from piqp_tpu_torch import kkt as tkkt
from piqp_tpu_torch.types import Vars
from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

VARS = ("x", "y", "z_l", "z_u", "z_bl", "z_bu", "s_l", "s_u", "s_bl", "s_bu")


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol:.0e} x {scale:.3e}"


def _batch_state(dims, seed, B=3):
    """B problems of one shape (problem 1 badly scaled) and random iterates
    with positive slacks/duals; returns (problems, iterates as numpy
    arrays, rng, the port's batched data)."""
    n, p, m = dims
    probs = [dense_strongly_convex_qp(n, p, m, seed=seed + i) for i in range(B)]
    probs[1]["P"] = probs[1]["P"] * 1e3
    rng = np.random.default_rng(seed + 1000)
    data = prepare_batch(probs, device="cpu")
    masks = dict(
        z_l=data.hl_mask, z_u=data.hu_mask, z_bl=data.xl_mask, z_bu=data.xu_mask,
        s_l=data.hl_mask, s_u=data.hu_mask, s_bl=data.xl_mask, s_bu=data.xu_mask,
    )
    v = dict(x=rng.standard_normal((B, n)), y=rng.standard_normal((B, p)))
    for k, mask in masks.items():
        mask = mask.numpy()
        v[k] = np.where(mask, rng.uniform(0.5, 2.0, mask.shape), 0.0)
    return probs, v, rng, data


def _rhs(data, rng):
    masks = dict(
        z_l=data.hl_mask, z_u=data.hu_mask, z_bl=data.xl_mask, z_bu=data.xu_mask,
        s_l=data.hl_mask, s_u=data.hu_mask, s_bl=data.xl_mask, s_bu=data.xu_mask,
    )
    r = dict(x=rng.standard_normal((data.B, data.n)),
             y=rng.standard_normal((data.B, data.p)))
    for k, mask in masks.items():
        mask = mask.numpy()
        r[k] = np.where(mask, rng.standard_normal(mask.shape), 0.0)
    return r


def _jax_data(probs):
    return jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[piqp_tpu.prepare_data(**p) for p in probs])


@pytest.mark.parametrize(
    "dims, use_ir, inverse",
    [
        ((10, 4, 6), False, True),
        ((10, 4, 6), True, True),
        ((16, 0, 10), True, True),
        ((12, 5, 0), False, True),
        ((10, 4, 6), True, False),
        ((16, 0, 10), False, False),
    ],
)
def test_factor_and_solve_match_jax(dims, use_ir, inverse):
    probs, v, rng, tdata = _batch_state(dims, seed=sum(dims))
    jsettings = piqp_tpu.Settings(pallas_kernels=inverse)
    tsettings = convert.settings(dataclasses.asdict(jsettings))
    B = len(probs)
    jdata = _jax_data(probs)
    jvars = JVars(**{k: jnp.asarray(v[k]) for k in VARS})
    rho = jnp.full(B, 1e-6)
    delta = jnp.full(B, 1e-4)
    ir = jnp.full(B, use_ir)
    ks_j = jax.vmap(
        lambda d, vv, r, dl, i: jkkt.compute_scalings(
            d, jsettings, vv, r, dl, i, jnp.diagonal(d.P))
    )(jdata, jvars, rho, delta, ir)

    ks_t = convert.kkt_state(jax.tree.map(np.asarray, ks_j), batched=True)
    # the port's own scalings agree with the carried-over state
    tvars = Vars(**{k: torch.as_tensor(v[k]) for k in VARS})
    ks_own = tkkt.compute_scalings(
        tdata, tsettings, tvars, ks_t.rho, ks_t.delta, ks_t.use_ir,
        torch.diagonal(tdata.P, dim1=-2, dim2=-1),
    )
    for name in ("x_reg", "z_reg", "z_reg_fact", "delta_reg", "W_l_inv", "W_bu_inv"):
        _close(getattr(ks_own, name), getattr(ks_t, name), 1e-14, name)

    rhs = _rhs(tdata, rng)
    jrhs = JVars(**{k: jnp.asarray(rhs[k]) for k in VARS})
    trhs = Vars(**{k: torch.as_tensor(rhs[k]) for k in VARS})

    for mixed in (False, True):
        tol = 1e-4 if mixed else 1e-10

        @jax.jit
        def jax_factor_solve(d, ks, r):
            pre = jkkt.precompute(d, mixed)
            ks, ok = jkkt.factor(d, ks, mixed, pre)
            lhs, ok2 = jkkt.solve(d, jsettings, ks, r)
            return ks.L, ok, lhs, ok2

        with jax.default_matmul_precision("highest"):
            jL, jok, jlhs, jok2 = jax.tree.map(
                np.asarray, jax.vmap(jax_factor_solve)(jdata, ks_j, jrhs)
            )
        pre = tkkt.precompute(tdata, mixed)
        ks_f, tok = tkkt.factor(tdata, ks_t, mixed, pre, inverse)
        tlhs, tok2 = tkkt.solve(tdata, tsettings, ks_f, trhs)

        assert tok.tolist() == jok.tolist() == [True] * B
        assert tok2.tolist() == jok2.tolist()
        if inverse:
            _close(ks_f.L, jL[0], tol, "L")
            if mixed:
                # a float32 inverse of K (condition ~1e5 here) is accurate
                # only to ~cond * eps32 in its entries, in either package;
                # hold it to being the inverse of its own L instead
                eye = np.broadcast_to(np.eye(tdata.n), jL[0].shape)
                _close(ks_f.L.double() @ ks_f.Linv.double(), eye, tol, "L Linv")
            else:
                _close(ks_f.Linv, jL[1], tol, "Linv")
        else:
            _close(ks_f.L, jL, tol, "L")
        for k in VARS:
            _close(getattr(tlhs, k), getattr(jlhs, k), tol, f"mixed={mixed} lhs.{k}")


def test_phase_a_static_refinement_matches_jax():
    """Mixed phase A: float32 matrices and factor, mu-relaxed tolerance and
    one static refinement pass."""
    probs, v, rng, tdata = _batch_state((10, 4, 6), seed=5)
    jsettings = piqp_tpu.Settings(pallas_kernels=True, mixed_precision=True)
    tsettings = convert.settings(dataclasses.asdict(jsettings))
    B = len(probs)
    jdata = _jax_data(probs)
    jvars = JVars(**{k: jnp.asarray(v[k]) for k in VARS})
    mu = np.array([1e-2, 3e-3, 1e-1])
    ks_j = jax.vmap(
        lambda d, vv: jkkt.compute_scalings(
            d, jsettings, vv, jnp.asarray(1e-6), jnp.asarray(1e-4),
            jnp.asarray(True), jnp.diagonal(d.P))
    )(jdata, jvars)
    rhs = _rhs(tdata, rng)

    @jax.jit
    def jax_phase_a(d, ks, r, mu):
        pre = jkkt.precompute(d, True)
        ks, _ = jkkt.factor(d, ks, True, pre)
        return jkkt.solve(d, jsettings, ks, r, mu, pre["data32"])

    with jax.default_matmul_precision("highest"):
        jlhs, jok = jax.tree.map(np.asarray, jax.vmap(jax_phase_a)(
            jdata, ks_j, JVars(**{k: jnp.asarray(rhs[k]) for k in VARS}),
            jnp.asarray(mu)))
    ks_t = convert.kkt_state(jax.tree.map(np.asarray, ks_j), batched=True)
    pre = tkkt.precompute(tdata, True)
    ks_f, _ = tkkt.factor(tdata, ks_t, True, pre, True)
    tlhs, tok = tkkt.solve(
        tdata, tsettings, ks_f, Vars(**{k: torch.as_tensor(rhs[k]) for k in VARS}),
        torch.as_tensor(mu), pre["data32"],
    )
    assert tok.tolist() == jok.tolist() == [True] * B
    for k in VARS:
        _close(getattr(tlhs, k), getattr(jlhs, k), 1e-4, k)


def test_ok_flags_are_per_problem():
    """An indefinite condensed matrix fails its own problem only, in both
    packages and both factor representations."""
    probs, v, rng, tdata = _batch_state((8, 2, 4), seed=21)
    B = len(probs)
    rho = np.array([1e-6, -1e4, 1e-6])  # problem 1: K indefinite
    tvars = Vars(**{k: torch.as_tensor(v[k]) for k in VARS})
    settings = Settings()
    P_diag = torch.diagonal(tdata.P, dim1=-2, dim2=-1)
    ks = tkkt.compute_scalings(
        tdata, settings, tvars, torch.as_tensor(rho), torch.full((B,), 1e-4),
        torch.zeros(B, dtype=torch.bool), P_diag,
    )
    for inverse in (True, False):
        for mixed in (False, True):
            ks_f, ok = tkkt.factor(tdata, ks, mixed, tkkt.precompute(tdata, mixed), inverse)
            assert ok.tolist() == [True, False, True], (inverse, mixed)

    jsettings = piqp_tpu.Settings(pallas_kernels=True)
    jvars = JVars(**{k: jnp.asarray(v[k]) for k in VARS})
    _, jok = jax.vmap(lambda d, vv, r: jkkt.factor(d, jkkt.compute_scalings(
        d, jsettings, vv, r, jnp.asarray(1e-4), jnp.asarray(False),
        jnp.diagonal(d.P))))(_jax_data(probs), jvars, jnp.asarray(rho))
    assert np.asarray(jok).tolist() == [True, False, True]


@pytest.mark.parametrize("dims", [(10, 4, 6), (16, 0, 10), (12, 5, 0)])
@pytest.mark.parametrize("use_ir", [False, True])
def test_factor_solve_mul_roundtrip(dims, use_ir):
    """K^-1 then K* reproduces the right-hand side (tests/test_kkt.py's
    oracle), for every problem of a batch."""
    probs, v, rng, tdata = _batch_state(dims, seed=sum(dims) + 7)
    B = len(probs)
    settings = Settings()
    tvars = Vars(**{k: torch.as_tensor(v[k]) for k in VARS})
    ks = tkkt.compute_scalings(
        tdata, settings, tvars, torch.full((B,), 1e-6), torch.full((B,), 1e-4),
        torch.full((B,), use_ir), torch.diagonal(tdata.P, dim1=-2, dim2=-1),
    )
    ks, ok = tkkt.factor(tdata, ks, False, tkkt.precompute(tdata))
    assert bool(ok.all())
    rhs = Vars(**{k: torch.as_tensor(a) for k, a in _rhs(tdata, rng).items()})
    lhs, ok = tkkt.solve(tdata, settings, ks, rhs)
    assert bool(ok.all())
    back = tkkt.mul_full(tdata, ks, lhs)
    tol = 1e-7 if not use_ir else 1e-6
    for k in VARS:
        np.testing.assert_allclose(
            getattr(back, k).numpy(), getattr(rhs, k).numpy(), atol=tol, err_msg=k
        )
