"""The generator ``dense_strongly_convex_qp``: a frozen copy of the port's
``piqp_tpu_torch/utils/random.py`` ``dense_strongly_convex_qp``, which
``tests/test_gpubench_frozen.py`` holds byte-identical to it for a few
seeds.  It lives here so that no later change to the program can change
the benchmark's problems.  Its problems are dense arrays already, so it
needs no ``dense``.  This module imports numpy only."""

from __future__ import annotations

import numpy as np


def generate(
    dim: int,
    n_eq: int,
    n_ineq: int,
    bounds_perc: float = 0.5,
    strong_convexity_factor: float = 1e-2,
    seed: int = 42,
):
    """PIQP v0.6.2 random_utils.hpp:131-211's distribution: strongly convex
    P, equalities consistent with a planted solution, one- and two-sided
    inequalities with ~30% inactive, bounds on about half of x.  Returns a
    dict with keys P, c, A, b, G, h_l, h_u, x_l, x_u (infinite bounds as
    +-inf)."""
    rng = np.random.default_rng(seed)
    inf = np.inf

    Q = rng.uniform(-1, 1, (dim, dim))
    P = Q @ Q.T
    w = np.linalg.eigvalsh(P)
    P += (strong_convexity_factor + abs(float(w.min()))) * np.eye(dim)

    A = rng.uniform(-1, 1, (n_eq, dim))
    G = rng.uniform(-1, 1, (n_ineq, dim))

    x_sol = rng.uniform(-1, 1, dim)
    c = rng.uniform(-1, 1, dim)
    b = A @ x_sol if n_eq > 0 else np.zeros(0)

    delta_l = np.where(rng.uniform(0, 1, n_ineq) < 0.3, rng.uniform(0, 1, n_ineq), 0.0)
    delta_u = np.where(rng.uniform(0, 1, n_ineq) < 0.3, rng.uniform(0, 1, n_ineq), 0.0)
    h_l = G @ x_sol - delta_l if n_ineq > 0 else np.zeros(0)
    h_u = G @ x_sol + delta_u if n_ineq > 0 else np.zeros(0)
    r = rng.uniform(0, 1, n_ineq)
    h_l = np.where(r < 0.33, -inf, h_l)
    h_u = np.where((r >= 0.33) & (r < 0.66), inf, h_u)

    x_l = np.full(dim, -inf)
    x_u = np.full(dim, inf)
    r = rng.uniform(0, 1, dim)
    lower_only = r < bounds_perc / 3
    upper_only = (r >= bounds_perc / 3) & (r < bounds_perc * 2 / 3)
    both = (r >= bounds_perc * 2 / 3) & (r < bounds_perc)
    slack = rng.uniform(0, 1, dim)
    loosen = rng.uniform(0, 1, dim) < 0.5
    x_l = np.where(lower_only, np.where(loosen, x_sol - slack, x_sol), x_l)
    x_u = np.where(upper_only, np.where(loosen, x_sol + slack, x_sol), x_u)
    x_l = np.where(both, np.where(loosen, x_sol - slack, x_sol), x_l)
    x_u = np.where(both, np.where(loosen, x_sol, x_sol + slack), x_u)

    return dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l, h_u=h_u, x_l=x_l, x_u=x_u)
