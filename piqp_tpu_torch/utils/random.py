"""Random QP generators for tests and benchmarks (a copy of
``piqp_tpu/utils/random.py``: the same seed gives byte-identical problems).

Mirrors the problem *distribution* of the reference generators
(PIQP's include/piqp/utils/random_utils.hpp:131-211:
``dense_strongly_convex_qp``): strongly convex P, equalities consistent with
a planted solution, a mix of one-sided/two-sided inequalities with ~30%
inactive, and optional variable bounds.  Uses numpy's Generator instead of
the reference's mt19937 stream (bit-level RNG parity is not a goal).
"""

from __future__ import annotations

import numpy as np


def dense_strongly_convex_qp(
    dim: int,
    n_eq: int,
    n_ineq: int,
    bounds_perc: float = 0.5,
    strong_convexity_factor: float = 1e-2,
    seed: int = 42,
):
    """Returns a dict with keys P, c, A, b, G, h_l, h_u, x_l, x_u."""
    rng = np.random.default_rng(seed)
    inf = np.inf

    Q = rng.uniform(-1, 1, (dim, dim))
    P = Q @ Q.T
    # shift spectrum to ensure strong convexity
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


def sparse_strongly_convex_qp(
    dim: int,
    n_eq: int,
    n_ineq: int,
    sparsity_factor: float = 0.1,
    bounds_perc: float = 0.5,
    strong_convexity_factor: float = 1e-2,
    seed: int = 42,
):
    """Sparse analog (random_utils.hpp:210): returns scipy.sparse CSC
    matrices for P/A/G, built from the dense generator's recipe with a
    sparsified pattern."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    prob = dense_strongly_convex_qp(
        dim, n_eq, n_ineq, bounds_perc, strong_convexity_factor, seed
    )

    def sparsify(M, sym=False):
        mask = rng.uniform(0, 1, M.shape) < sparsity_factor
        if sym:
            mask = mask | mask.T
            np.fill_diagonal(mask, True)
        return M * mask

    # re-derive a sparse strongly convex P: sparsify off-diagonals, then
    # restore diagonal dominance
    P = sparsify(prob["P"], sym=True)
    row_sums = np.abs(P).sum(axis=1) - np.abs(np.diag(P))
    np.fill_diagonal(P, row_sums + strong_convexity_factor + 1.0)

    A = sparsify(prob["A"]) if n_eq else prob["A"]
    G = sparsify(prob["G"]) if n_ineq else prob["G"]
    rng2 = np.random.default_rng(seed + 1)
    x_sol = rng2.uniform(-1, 1, dim)
    b = A @ x_sol if n_eq else prob["b"]
    if n_ineq:
        Gx = G @ x_sol
        margin_l = rng2.uniform(0, 1, n_ineq)
        margin_u = rng2.uniform(0, 1, n_ineq)
        h_l = np.where(np.isfinite(prob["h_l"]), Gx - margin_l, -np.inf)
        h_u = np.where(np.isfinite(prob["h_u"]), Gx + margin_u, np.inf)
    else:
        h_l, h_u = prob["h_l"], prob["h_u"]

    return dict(
        P=sp.csc_matrix(P),
        c=prob["c"],
        A=sp.csc_matrix(A),
        b=b,
        G=sp.csc_matrix(G),
        h_l=h_l,
        h_u=h_u,
        x_l=prob["x_l"],
        x_u=prob["x_u"],
    )
