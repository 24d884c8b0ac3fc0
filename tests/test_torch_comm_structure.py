"""The communication structure of the port's horizon-sharded solve
(``tests/test_comm_structure.py:51-59`` for the JAX package, which counts
the collectives of its compiled executable): the collectives a sharded
factor and a sharded solve make must not grow with the horizon T.

On a gloo group of one rank, ``random_multistage_qp(T, D=4, Da=2, ra=2,
rg=2, seed=0)`` at 8 chunks for T in {16, 32, 64}: ``comm.collective_calls``
counted by kind over one factor and over one solve, each > 0 in all and
equal at the three horizons.
"""

import types

import numpy as np
import torch

import piqp_tpu_torch
from piqp_tpu_torch import convert, kkt, ruiz
from piqp_tpu_torch import multistage as tms
from piqp_tpu_torch.ops import matvec as mv
from piqp_tpu_torch.parallel import comm, shard_horizon

from test_torch_horizon_ranks import gloo  # noqa: F401  (fixture)


def _counted(fn):
    before = dict(comm.collective_calls)
    out = fn()
    return out, {k: comm.collective_calls[k] - before[k] for k in before}


def _per_factor_and_solve(T):
    data = shard_horizon(tms.random_multistage_qp(T=T, D=4, Da=2, ra=2, rg=2, seed=0,
                                                  device="cpu"), chunks=8)
    scaled, _ = ruiz.equilibrate(data)
    rng = np.random.default_rng(1)
    ones = {k: np.ones(n) for k, n in (("z", data.m), ("x", data.n))}
    v = dict(x=rng.standard_normal(data.n), y=rng.standard_normal(data.p),
             z_l=ones["z"], z_u=ones["z"], z_bl=ones["x"], z_bu=ones["x"],
             s_l=ones["z"], s_u=ones["z"], s_bl=ones["x"], s_bu=ones["x"])
    f64 = dict(dtype=torch.float64)
    ks = kkt.compute_scalings(
        scaled, piqp_tpu_torch.Settings(), convert.vars_(types.SimpleNamespace(**v)),
        torch.full((1,), 1e-6, **f64), torch.full((1,), 1e-4, **f64),
        torch.zeros(1, dtype=torch.bool), mv.P_diag(scaled))
    (ks, ok), per_factor = _counted(lambda: kkt.factor(scaled, ks))
    assert ok.tolist() == [True]
    rhs = torch.as_tensor(rng.standard_normal((1, data.n)))
    x, per_solve = _counted(lambda: kkt.condensed_solve_x(scaled, ks, rhs))
    assert torch.isfinite(x).all()
    return per_factor, per_solve


def test_horizon_shard_collectives_independent_of_T(gloo):  # noqa: F811
    counts = {T: _per_factor_and_solve(T) for T in (16, 32, 64)}
    factor16, solve16 = counts[16]
    assert sum(factor16.values()) > 0 and sum(solve16.values()) > 0, counts
    assert counts[16] == counts[32] == counts[64], (
        f"collective count must not grow with the horizon: {counts}"
    )
    # one neighbour exchange, one all-reduce (Kc) and one all-gather (the
    # Schur blocks) a factor; two all-gathers a solve
    assert factor16 == {"all_gather": 1, "exchange": 1, "all_reduce": 1}
    assert solve16 == {"all_gather": 2, "exchange": 0, "all_reduce": 0}
