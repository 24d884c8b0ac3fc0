"""Ruiz equilibration of the PyTorch port against ``piqp_tpu.ruiz``: the
scaling vectors and the scaled data agree to 1e-12 for every problem of a
batch, including a badly scaled one that needs more passes than the others
(each problem's pass loop stops on its own)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import piqp_tpu
from piqp_tpu import ruiz as jax_ruiz

from piqp_tpu_torch import prepare_batch
from piqp_tpu_torch import ruiz as torch_ruiz
from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

FIELDS = ("P", "c", "A", "b", "G", "h_l", "h_u", "x_l", "x_u", "x_b_scaling")


def _problems():
    probs = [dense_strongly_convex_qp(12, 4, 8, seed=9 + i) for i in range(4)]
    probs[1]["P"] = probs[1]["P"] * 1e4  # badly scaled: more Ruiz passes
    probs[1]["A"] = probs[1]["A"] * 1e-3
    probs[2]["x_l"] = np.full(12, -np.inf)  # no box bounds at all
    probs[2]["x_u"] = np.full(12, np.inf)
    return probs


@pytest.mark.parametrize("scale_cost", [False, True])
def test_equilibrate_matches_jax_per_problem(scale_cost):
    probs = _problems()
    data = prepare_batch(probs, device="cpu")
    sdata, sc = torch_ruiz.equilibrate(data, max_iter=10, scale_cost=scale_cost)
    for i, prob in enumerate(probs):
        jd = piqp_tpu.prepare_data(**prob)
        jsd, jsc = jax.tree.map(
            np.asarray, jax_ruiz.equilibrate(jd, max_iter=10, scale_cost=scale_cost)
        )
        for name in ("c", "d_x", "d_y", "d_z", "d_b"):
            np.testing.assert_allclose(
                getattr(sc, name)[i].numpy(), getattr(jsc, name),
                rtol=1e-12, atol=0, err_msg=f"problem {i} scaling {name}",
            )
        for name in FIELDS:
            np.testing.assert_allclose(
                getattr(sdata, name)[i].numpy(), getattr(jsd, name),
                rtol=1e-12, atol=1e-14, err_msg=f"problem {i} data {name}",
            )


def test_apply_scaling_matches_equilibrate():
    data = prepare_batch(_problems(), device="cpu")
    scaled, sc = torch_ruiz.equilibrate(data, max_iter=10)
    again = torch_ruiz.apply_scaling(data, sc)
    for name in FIELDS:
        torch.testing.assert_close(
            getattr(again, name), getattr(scaled, name), rtol=1e-12, atol=1e-14
        )


def _near_equilibrated_dense(n=6, p=2, m=3, seed=3):
    """Every entry of P, A and G at 1.003 in magnitude: the first pass
    moves the scalings by 1.5e-3, the second by 7.5e-4 (the bounds' column
    x_b_scaling), under the 1e-3 measure, so the mask stops it there."""
    rng = np.random.default_rng(seed)
    S = np.sign(rng.standard_normal((n, n)))
    return dict(P=1.003 * np.triu(S) + 1.003 * np.triu(S, 1).T, c=np.zeros(n),
                A=1.003 * np.sign(rng.standard_normal((p, n))), b=np.zeros(p),
                G=1.003 * np.sign(rng.standard_normal((m, n))),
                h_l=-np.ones(m), h_u=np.ones(m))


def _mask_batch(kind):
    """Problem 0 near equilibrium, problem 1 badly scaled (many passes)."""
    if kind == "dense":
        bad = dense_strongly_convex_qp(6, 2, 3, seed=4)
        bad["P"] = bad["P"] * 1e4
        return prepare_batch([_near_equilibrated_dense(), bad], device="cpu")
    from piqp_tpu_torch import multistage as tms
    from piqp_tpu_torch.types import concat

    near, bad = (tms.random_multistage_qp(T=4, D=3, Da=2, ra=2, rg=2, seed=s, device="cpu")
                 for s in (50, 51))
    near = dataclasses.replace(
        near, c=torch.zeros_like(near.c),
        **{k: 1.003 * torch.sign(getattr(near, k)) for k in tms._BLOCKS})
    return concat([near, dataclasses.replace(bad, Pd=bad.Pd * 300.0)])


@pytest.mark.parametrize("scale_cost", [False, True], ids=["plain", "scale_cost"])
@pytest.mark.parametrize("kind", ["dense", "stage"])
def test_the_mask_alone_ends_a_problems_passes(kind, scale_cost):
    """All max_iter passes run on every problem, with no read of the
    device: a problem that converged after two passes keeps, bit for bit,
    the scaling and the scaled data of max_iter = 2, while the other goes
    on."""
    data = _mask_batch(kind)
    runs = {k: torch_ruiz.equilibrate(data, max_iter=k, scale_cost=scale_cost) for k in (1, 2, 10)}
    names = ("c", "d_x", "d_y", "d_z", "d_b")
    for name in names:
        ten, two = getattr(runs[10][1], name), getattr(runs[2][1], name)
        assert torch.equal(ten[0], two[0]), name
    assert any(not torch.equal(getattr(runs[2][1], k)[0], getattr(runs[1][1], k)[0])
               for k in names), "the second pass changed nothing"
    assert any(not torch.equal(getattr(runs[10][1], k)[1], getattr(runs[2][1], k)[1])
               for k in names), "problem 1 stopped with problem 0"
    for f in dataclasses.fields(runs[10][0]):
        ten, two = getattr(runs[10][0], f.name), getattr(runs[2][0], f.name)
        if isinstance(ten, torch.Tensor) and ten.ndim:
            assert torch.equal(ten[0], two[0]), f.name
