"""The plain reference against the port's CPU solve on tiny problems of
the configuration's generator."""

import numpy as np
import pytest
import torch

from gpubench import problems as pb
from gpubench import reference
from piqp_tpu_torch import Settings, prepare_batch, solve_batch

CONFIG = {"generator": "dense_strongly_convex_qp"}
DENSE = pb.generator(CONFIG).generate

TIGHT = Settings(eps_abs=1e-12, eps_rel=1e-13, eps_duality_gap_abs=1e-13,
                 eps_duality_gap_rel=1e-14)


def _check(problems, data):
    dense = pb.dense_form(CONFIG, problems)
    x, y, z_l, z_u, z_bl, z_bu, _, _ = reference.solve(dense)
    port = solve_batch(data, TIGHT)
    assert port.info.status.tolist() == [1] * len(problems)
    gap = np.abs(port.x.numpy() - x).max(-1) / np.maximum(1.0, np.abs(x).max(-1))
    assert gap.max() <= 1e-7
    for i in range(len(problems)):
        prob = {k: v[i] for k, v in dense.items()}
        assert reference.optimality(prob, x[i], y[i], z_l[i], z_u[i], z_bl[i], z_bu[i]) <= 1e-9


@pytest.mark.parametrize("seed", [1, 2])
def test_dense(seed):
    problems = [DENSE(16, 8, 8, seed=s)
                for s in pb.problem_seeds(seed, 0, 6)]
    _check(problems, prepare_batch(problems, device="cpu"))


def test_equal_bounds_are_equalities():
    prob = DENSE(12, 4, 6, seed=9)
    prob["h_u"] = prob["h_l"] = np.where(np.isfinite(prob["h_l"]), prob["h_l"],
                                         prob["h_u"])
    dense = pb.dense_form(CONFIG, [prob])
    sol = reference.solve(dense)
    assert reference.optimality({k: v[0] for k, v in dense.items()},
                                *(s[0] for s in sol[:6])) <= 1e-9


def test_float32_is_worse():
    problems = [DENSE(16, 8, 8, seed=s) for s in range(4)]
    dense = pb.dense_form(CONFIG, problems)
    x64 = reference.solve(dense)[0]
    x32 = reference.solve(dense, dtype=torch.float32)[0]
    assert np.abs(x32 - x64).max() > 1e-7


def test_dependent_active_rows_keep_the_iterate():
    # an active inequality row twice: the polish's system is singular with
    # fewer active rows than variables, and the iterate stands
    prob = DENSE(12, 4, 6, seed=5)
    dense = pb.dense_form(CONFIG, [prob])
    x, y, z_l, z_u, z_bl, z_bu, _, _ = reference.solve(dense)
    j = int(np.argmax(z_l[0] + z_u[0]))
    assert z_l[0, j] + z_u[0, j] > 1e-6
    twice = dict(prob, G=np.vstack([prob["G"], prob["G"][j:j + 1]]),
                 h_l=np.append(prob["h_l"], prob["h_l"][j]), h_u=np.append(prob["h_u"], prob["h_u"][j]))
    dense2 = pb.dense_form(CONFIG, [twice])
    sol = reference.solve(dense2)
    assert np.abs(sol[0][0] - x[0]).max() <= 1e-7
    assert reference.optimality({k: v[0] for k, v in dense2.items()},
                                *(s[0] for s in sol[:6])) <= 1e-9
