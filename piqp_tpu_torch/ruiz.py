"""Batched Ruiz equilibration (``piqp_tpu/ruiz.py``; reference
dense::RuizEquilibration, dense/preconditioner.hpp:26-438).

Each pass scales the KKT matrix [P A' G' D; A; G; D] by the inverse square
roots of its column infinity norms.  Every norm and the early-exit measure
are per problem, and each problem stops on its own: a problem whose
measure fell below ``epsilon`` keeps its scaling while the others go on,
as ``vmap`` of the JAX ``while_loop`` does.  All ``max_iter`` passes run,
under that per-problem mask, with no read of the device from the host.

A pass (``ops.ruiz_norms``; on CUDA a launch of each hand-written kernel):
the norms of the working copy of the blocks, read once; the step (the
pass's scalings, the accumulated ones, x_b_scaling, c, the measure); the
working copy scaled in place by the step, read and written once.  The
copy is scaled pass by pass, as the reference scales its matrices, so
every scaled value is rounded as there and the results are the previous
port's, bit for bit.  Under ``scale_cost`` a second norms launch and the
cost step give gamma, and P's blocks are scaled by it.
"""

from __future__ import annotations

import dataclasses
from functools import singledispatch

import torch

from .ops.ruiz_norms import dense_norms, dense_scale, ruiz_cost_step, ruiz_step
from .types import QPData, Scaling


@singledispatch
def equilibrate(
    data, max_iter: int = 10, scale_cost: bool = False, epsilon: float = 1e-3,
):
    """Compute and apply Ruiz scaling (preconditioner.hpp:64-222); returns
    (scaled data, Scaling).  Dispatches on the data's type."""
    raise NotImplementedError(type(data))


def _equilibrate(work, norms, scale, scale_p, max_iter: int, scale_cost: bool,
                 epsilon: float):
    """The pass loop of every registration, on ``work``: the data with
    copies of its matrices, which the loop scales in place.  The scalings
    are one flat (B, 2n + p + m) vector d = [d_x | d_y | d_z | d_b].

    ``norms(work, active, cost_only)``: the infinity norms (B, n + p + m)
    of work's KKT matrix without x_b_scaling's column and P[g, g]'s
    (``work.Pc`` where the data has one: ``ops.ruiz_norms.ruiz_step`` joins
    them in), 0 where a problem is not ``active``; with ``cost_only``, P's
    column norms (B, n) alone (preconditioner.hpp:148-169).
    ``scale(work, s, active)``: work's matrices scaled by a pass's
    scalings s (d's layout), for the ``active`` problems; ``scale_p(work,
    gamma, active)``: P's by the cost factor.
    """
    B, n, p, m = work.B, work.n, work.p, work.m
    dt, dev = work.c.dtype, work.c.device
    d = torch.ones((B, 2 * n + p + m), dtype=dt, device=dev)
    s = torch.ones_like(d)
    cost = torch.ones(B, dtype=dt, device=dev)
    gamma = torch.ones_like(cost)
    xb, cvec = work.x_b_scaling.clone(), work.c.clone()
    measure = torch.full((B,), float("inf"), dtype=dt, device=dev)
    Pc = getattr(work, "Pc", None)
    for _ in range(max_iter):
        active = measure > epsilon
        ruiz_step(norms(work, active, False), Pc, d, s, xb, cvec, measure, active)
        scale(work, s, active)
        if scale_cost:
            ruiz_cost_step(norms(work, active, True), Pc, cvec, cost, gamma, active)
            scale_p(work, gamma, active)
    d_x, d_y, d_z, d_b = (v.contiguous() for v in torch.split(d, [n, p, m, n], dim=1))
    scaled = dataclasses.replace(
        work, c=cvec, x_b_scaling=xb,
        b=work.b * d_y, h_l=work.h_l * d_z, h_u=work.h_u * d_z,
        x_l=work.x_l * d_b, x_u=work.x_u * d_b,
    )
    return scaled, Scaling(c=cost, d_x=d_x, d_y=d_y, d_z=d_z, d_b=d_b)


def _copy(M: torch.Tensor) -> torch.Tensor:
    """A copy of M with its rows packed, for the scale kernels to write."""
    return M.clone(memory_format=torch.contiguous_format)


def _scaled_by_cost(M: torch.Tensor, gamma: torch.Tensor, active: torch.Tensor) -> None:
    """M (B, ...) times gamma (B,) in place, for the ``active`` problems."""
    g = gamma.reshape((-1,) + (1,) * (M.ndim - 1))
    M.copy_(torch.where(active.reshape(g.shape), M * g, M))


@equilibrate.register
def _(
    data: QPData,
    max_iter: int = 10,
    scale_cost: bool = False,
    epsilon: float = 1e-3,
):
    """Dense: Ruiz over [P A' G'; A; G] with x_b_scaling folded into the
    column norms (preconditioner.hpp:93-109).  Returns (scaled, Scaling):
        P <- c * Dx P Dx,  c_vec <- c * Dx c_vec,
        A <- Dy A Dx,      b <- Dy b,
        G <- Dz G Dx,      h <- Dz h,
        x_b_scaling <- Db * Dx * x_b_scaling,  x_l/x_u <- Db x_l/x_u.
    """
    n, p, m = data.n, data.p, data.m
    work = dataclasses.replace(data, P=_copy(data.P), A=_copy(data.A), G=_copy(data.G))

    def norms(w, active, cost_only):
        # column norms of the KKT matrix (preconditioner.hpp:93-109)
        if cost_only:
            return dense_norms(w.P, w.A[:, :0], w.G[:, :0], active)
        return dense_norms(w.P, w.A, w.G, active)

    def scale(w, s, active):
        dense_scale(w.P, w.A, w.G, s[:, :n], s[:, n:n + p], s[:, n + p:n + p + m], active)

    def scale_p(w, gamma, active):
        _scaled_by_cost(w.P, gamma, active)

    return _equilibrate(work, norms, scale, scale_p, max_iter, scale_cost, epsilon)


@singledispatch
def apply_scaling(data, s: Scaling):
    """Apply a previously computed scaling to fresh (unscaled) data
    (preconditioner.hpp:176-205, the reuse_prev_scaling path)."""
    raise NotImplementedError(type(data))


@apply_scaling.register
def _(data: QPData, s: Scaling) -> QPData:
    P, A, G = _copy(data.P), _copy(data.A), _copy(data.G)
    dense_scale(P, A, G, s.d_x, s.d_y, s.d_z, torch.ones_like(s.c, dtype=torch.bool))
    return dataclasses.replace(
        data,
        P=s.c[:, None, None] * P,
        c=s.c[:, None] * data.c * s.d_x,
        A=A,
        b=data.b * s.d_y,
        G=G,
        h_l=data.h_l * s.d_z,
        h_u=data.h_u * s.d_z,
        x_l=data.x_l * s.d_b,
        x_u=data.x_u * s.d_b,
        x_b_scaling=data.x_b_scaling * s.d_b * s.d_x,
    )
