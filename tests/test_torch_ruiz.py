"""Ruiz equilibration of the PyTorch port against ``piqp_tpu.ruiz``: the
scaling vectors and the scaled data agree to 1e-12 for every problem of a
batch, including a badly scaled one that needs more passes than the others
(each problem's pass loop stops on its own)."""

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
