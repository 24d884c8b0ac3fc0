"""Shape padding: embed a QP into larger (bucketed) dimensions (a copy of
``piqp_tpu/utils/pad.py``).

A batch shares one shape, so heterogeneous problem collections (the
Maros-Meszaros corpus, mixed MPC scenario batches) are padded up to shared
shape buckets before they are stacked.

The embedding is exact: padding variables have P_ii = 1, c_i = 0 and no
coupling (their optimum is 0); padding equality rows are all-zero with
b = 0 (the proximal regularization makes a rank-deficient A benign:
y -> 0 on those rows); padding inequality rows are all-zero with bounds
[-1, 1] (always satisfied; exactly the form disable_inf_constraints
produces, dense/data.hpp:144-169 in the reference).  The restriction of
the padded solution to the original coordinates solves the original
problem.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def next_bucket(x: int, minimum: int = 8) -> int:
    """Next power of two >= x (>= minimum)."""
    b = max(minimum, 1)
    while b < x:
        b *= 2
    return b


def pad_problem(prob: dict, n_to=None, p_to=None, m_to=None, bucket=False):
    """Pad a dense problem dict to target dims (or power-of-2 buckets).

    Returns (padded_prob, (n, p, m)) with the original dims for unpadding.
    """
    P = np.asarray(prob["P"], dtype=np.float64)
    n = P.shape[0]
    A = prob.get("A")
    G = prob.get("G")
    p = 0 if A is None else np.asarray(A).shape[0]
    m = 0 if G is None else np.asarray(G).shape[0]

    if bucket:
        n_to = next_bucket(n)
        p_to = next_bucket(p, 0) if p else 0
        m_to = next_bucket(m, 0) if m else 0
    n_to = n if n_to is None else n_to
    p_to = p if p_to is None else p_to
    m_to = m if m_to is None else m_to
    if not (n_to >= n and p_to >= p and m_to >= m):
        raise ValueError(f"cannot pad (n, p, m) = {(n, p, m)} down to {(n_to, p_to, m_to)}")

    inf = np.inf
    P_new = np.eye(n_to)
    P_new[:n, :n] = P
    c_new = np.zeros(n_to)
    c_new[:n] = np.asarray(prob["c"]).ravel()

    def pad_mat(M, rows, rows_to):
        out = np.zeros((rows_to, n_to))
        if M is not None and rows:
            out[:rows, :n] = np.asarray(M, dtype=np.float64)
        return out

    def pad_vec(v, size, size_to, fill):
        out = np.full(size_to, fill, dtype=np.float64)
        if v is not None:
            out[:size] = np.asarray(v, dtype=np.float64).ravel()
        elif size:
            out[:size] = fill
        return out

    A_new = pad_mat(A, p, p_to) if p_to else None
    b_new = pad_vec(prob.get("b"), p, p_to, 0.0) if p_to else None
    G_new = pad_mat(G, m, m_to) if m_to else None
    h_l_new = pad_vec(prob.get("h_l"), m, m_to, -1.0) if m_to else None
    h_u_new = pad_vec(prob.get("h_u"), m, m_to, 1.0) if m_to else None
    if m_to and prob.get("h_l") is None:
        h_l_new[:m] = -inf
    if m_to and prob.get("h_u") is None:
        h_u_new[:m] = inf
    x_l_new = pad_vec(prob.get("x_l"), n, n_to, -inf)
    x_u_new = pad_vec(prob.get("x_u"), n, n_to, inf)
    if prob.get("x_l") is None:
        x_l_new[:n] = -inf
    if prob.get("x_u") is None:
        x_u_new[:n] = inf

    padded = dict(
        P=P_new, c=c_new, A=A_new, b=b_new, G=G_new,
        h_l=h_l_new, h_u=h_u_new, x_l=x_l_new, x_u=x_u_new,
    )
    return padded, (n, p, m)


def unpad_result(res, dims):
    """A padded ``Result`` cut back to the original dims (views along the
    last dimension, so a single result and a batched one both work)."""
    n, p, m = dims
    cut = dict(x=n, y=p, z_l=m, z_u=m, z_bl=n, z_bu=n, s_l=m, s_u=m, s_bl=n, s_bu=n)
    return dataclasses.replace(res, **{k: getattr(res, k)[..., :size]
                                       for k, size in cut.items()})
