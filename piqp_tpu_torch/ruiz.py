"""Batched Ruiz equilibration (``piqp_tpu/ruiz.py``; reference
dense::RuizEquilibration, dense/preconditioner.hpp:26-438).

Each pass scales the KKT matrix [P A' G' D; A; G; D] by the inverse square
roots of its column infinity norms.  Every norm and the early-exit measure
are per problem, and each problem stops on its own: a problem whose
measure fell below ``epsilon`` keeps its scaling while the others go on,
as ``vmap`` of the JAX ``while_loop`` does.
"""

from __future__ import annotations

import dataclasses
from functools import singledispatch

import torch

from .types import QPData, Scaling, max0, select

MIN_SCALING = 1e-4
MAX_SCALING = 1e4


def _limit_scaling(d: torch.Tensor) -> torch.Tensor:
    """Mirror of limit_scaling (preconditioner.hpp:420-437): values below
    MIN_SCALING are reset to 1 (not clamped!), values above MAX_SCALING are
    clamped."""
    d = torch.where(d < MIN_SCALING, 1.0, d)
    return torch.where(d > MAX_SCALING, MAX_SCALING, d)


def _inf_norm_cols(M: torch.Tensor) -> torch.Tensor:
    """Infinity norm of each column of each (r, k) matrix -> (B, k)."""
    return max0(M.abs(), dim=-2)


def _inf_norm_rows(M: torch.Tensor) -> torch.Tensor:
    return max0(M.abs(), dim=-1)


@singledispatch
def equilibrate(
    data, max_iter: int = 10, scale_cost: bool = False, epsilon: float = 1e-3,
):
    """Compute and apply Ruiz scaling (preconditioner.hpp:64-222); returns
    (scaled data, Scaling).  Dispatches on the data's type."""
    raise NotImplementedError(type(data))


@equilibrate.register
def _(
    data: QPData,
    max_iter: int = 10,
    scale_cost: bool = False,
    epsilon: float = 1e-3,
) -> tuple[QPData, Scaling]:
    """Dense registration.  The scaled data equals

        P <- c * Dx P Dx,  c_vec <- c * Dx c_vec,
        A <- Dy A Dx,      b <- Dy b,
        G <- Dz G Dx,      h <- Dz h,
        x_b_scaling <- Db * Dx * x_b_scaling,  x_l/x_u <- Db x_l/x_u.
    """
    dtype, device = data.P.dtype, data.P.device
    B, n = data.B, data.n
    ones = lambda k: torch.ones((B, k), dtype=dtype, device=device)  # noqa: E731
    d_x, d_y, d_z, d_b = ones(n), ones(data.p), ones(data.m), ones(n)
    cost = torch.ones(B, dtype=dtype, device=device)
    P, cvec, A, G, xb = data.P, data.c, data.A, data.G, data.x_b_scaling
    measure = torch.full((B,), float("inf"), dtype=dtype, device=device)

    for _ in range(max_iter):
        active = measure > epsilon
        if not bool(active.any()):
            break
        # column norms of the full KKT matrix (preconditioner.hpp:93-109)
        norm_x = torch.maximum(_inf_norm_cols(P), xb)
        norm_x = torch.maximum(norm_x, _inf_norm_cols(A))
        norm_x = torch.maximum(norm_x, _inf_norm_cols(G))
        dx = 1.0 / torch.sqrt(_limit_scaling(norm_x))
        dy = 1.0 / torch.sqrt(_limit_scaling(_inf_norm_rows(A)))
        dz = 1.0 / torch.sqrt(_limit_scaling(_inf_norm_rows(G)))
        db = 1.0 / torch.sqrt(_limit_scaling(xb))

        nP = dx[:, :, None] * P * dx[:, None, :]
        ncvec = cvec * dx
        nA = dy[:, :, None] * A * dx[:, None, :]
        nG = dz[:, :, None] * G * dx[:, None, :]
        nxb = xb * db * dx
        ncost = cost
        if scale_cost:
            # preconditioner.hpp:148-169
            gamma = _inf_norm_cols(nP).sum(-1) / n
            gamma = _limit_scaling(gamma)
            gamma = torch.maximum(gamma, max0(ncvec.abs()))
            gamma = 1.0 / _limit_scaling(gamma)
            nP = nP * gamma[:, None, None]
            ncvec = ncvec * gamma[:, None]
            ncost = cost * gamma

        # convergence measure of this pass (preconditioner.hpp:79-82)
        nmeasure = torch.maximum(
            max0((1.0 - dx).abs()),
            torch.maximum(
                max0((1.0 - dy).abs()),
                torch.maximum(max0((1.0 - dz).abs()), max0((1.0 - db).abs())),
            ),
        )
        P, cvec, A, G, xb, cost, measure, d_x, d_y, d_z, d_b = select(
            active,
            (nP, ncvec, nA, nG, nxb, ncost, nmeasure,
             d_x * dx, d_y * dy, d_z * dz, d_b * db),
            (P, cvec, A, G, xb, cost, measure, d_x, d_y, d_z, d_b),
        )

    scaled = dataclasses.replace(
        data, P=P, c=cvec, A=A, G=G, x_b_scaling=xb,
        b=data.b * d_y, h_l=data.h_l * d_z, h_u=data.h_u * d_z,
        x_l=data.x_l * d_b, x_u=data.x_u * d_b,
    )
    return scaled, Scaling(c=cost, d_x=d_x, d_y=d_y, d_z=d_z, d_b=d_b)


@singledispatch
def apply_scaling(data, s: Scaling):
    """Apply a previously computed scaling to fresh (unscaled) data
    (preconditioner.hpp:176-205, the reuse_prev_scaling path)."""
    raise NotImplementedError(type(data))


@apply_scaling.register
def _(data: QPData, s: Scaling) -> QPData:
    dx = s.d_x
    return dataclasses.replace(
        data,
        P=s.c[:, None, None] * (dx[:, :, None] * data.P * dx[:, None, :]),
        c=s.c[:, None] * data.c * dx,
        A=s.d_y[:, :, None] * data.A * dx[:, None, :],
        b=data.b * s.d_y,
        G=s.d_z[:, :, None] * data.G * dx[:, None, :],
        h_l=data.h_l * s.d_z,
        h_u=data.h_u * s.d_z,
        x_l=data.x_l * s.d_b,
        x_u=data.x_u * s.d_b,
        x_b_scaling=data.x_b_scaling * s.d_b * dx,
    )
