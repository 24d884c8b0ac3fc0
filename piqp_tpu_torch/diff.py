"""Differentiable QP solve (``piqp_tpu/diff.py``): implicit
differentiation through the KKT conditions.

``solve_qp_diff`` is a ``torch.autograd.Function`` around the IPM solve,
so QP solutions compose with ``torch.autograd``: learned MPC costs,
hyperparameters fitted through a control loop, OptNet-style QP layers.
It takes batched dense ``QPData`` and stacked ``multistage.StageQPData``
alike; on stage data the gradients land on the stage blocks (Pd, Psub,
Pa, ...) and the adjoint solve reuses the block-tridiagonal + arrow
factorization, so its cost stays linear in the horizon.

Math (implicit function theorem on the stationary KKT map).  Let
w = (x, y, z_l, z_u, z_bl, z_bu) and θ the problem-data fields.  At a
solution F(θ, w) = 0, where F stacks (B = diag(x_b_scaling), M* the
finite-bound masks)

    F1  = Px + c + A'y + G'(z_u - z_l) + B(Mu∘z_bu - Ml∘z_bl)      [n]
    F2  = Ax - b                                                    [p]
    F3l = Ml_h ? z_l ∘ (Gx - h_l)  : z_l                            [m]
    F3u = Mu_h ? z_u ∘ (h_u - Gx)  : z_u                            [m]
    F4l = Ml   ? z_bl ∘ (Bx - x_l) : z_bl                           [n]
    F4u = Mu   ? z_bu ∘ (x_u - Bx) : z_bu                           [n]

so the vector-Jacobian product of w̄ is θ̄ = -(∂F/∂θ)' u with
(∂F/∂w)' u = w̄.  Eliminating the complementarity rows leaves the
condensed saddle system

    [ H   A' ] [u1]   [ r1  ]        H = P + G' D_g G + B D_b B
    [ A   0  ] [u2] = [ w̄_y ]        D_g = diag(z_l/s_l + z_u/s_u)
                                      D_b = diag(z_bl/s_bl + z_bu/s_bu)

the quasi-definite structure the IPM factors each iteration
(kkt_system.hpp:161-193 with ρ = δ = 0).  Dense data factors the saddle
directly with the blocked signed Cholesky of ``ops/ldlt.py``; stage data
goes through ``kkt.factor``'s multistage registration (the adjoint
weights are a ``KKTState`` built by ``kkt.compute_scalings`` from the
solution's slacks and duals with tiny ρ, δ), both with iterative
refinement against the exact saddle operator.  ∂F/∂θ is never formed: θ̄
is one ``torch.autograd.grad`` of F in θ.

Weakly active constraints (z ≈ s ≈ 0) are non-differentiable points of
the solution map; the slack floor below picks a subgradient there, as
implicit-differentiation QP layers do (OptNet, Amos & Kolter 2017).
"""

from __future__ import annotations

import dataclasses
from functools import singledispatch

import torch
from torch.autograd.function import once_differentiable

from . import kkt, ruiz, solver
from .api import has_cone, prepare_data
from .multistage import StageQPData
from .ops import ldlt
from .ops import matvec as ops
from .types import BasicVars, QPData, Settings, Vars

# Active slacks are floored here before the z/s weights are formed: at a
# tightly active constraint the IPM leaves s ~ mu/z, whose weight z/s would
# wreck the saddle's conditioning; at 1e-8 the constraint acts as an
# equality in the derivative to O(1e-8) and the factorization stays well
# inside float64.
SLACK_FLOOR = 1e-8

# Adjoint saddle regularization of the stage route, corrected by
# refinement: W = 1/(s/z + delta) is ~9% low on floored active rows at
# delta = 1e-9, so refinement contracts at ~0.1 a round and 4 rounds
# leave O(1e-5) relative error.
_ADJ_RHO = 1e-11
_ADJ_DELTA = 1e-9
_ADJ_REFINE = 4


def _kkt_residual(data, x, y, z_l, z_u, z_bl, z_bu):
    """The stationary KKT map F(θ, w) (module docstring) through the
    dispatched matvecs, so autograd in θ gives a gradient for every float
    field of either data representation."""
    B = data.x_b_scaling
    F1 = ops.P_x(data, x) + data.c + B * (
        torch.where(data.xu_mask, z_bu, 0.0) - torch.where(data.xl_mask, z_bl, 0.0)
    )
    if data.p > 0:
        F1 = F1 + ops.AT_y(data, y)
        F2 = ops.A_x(data, x) - data.b
    else:
        F2 = torch.zeros_like(y)
    if data.m > 0:
        F1 = F1 + ops.GT_z(data, z_u - z_l)
        Gx = ops.G_x(data, x)
        F3l = torch.where(data.hl_mask, z_l * (Gx - data.h_l), z_l)
        F3u = torch.where(data.hu_mask, z_u * (data.h_u - Gx), z_u)
    else:
        F3l, F3u = torch.zeros_like(z_l), torch.zeros_like(z_u)
    Bx = B * x
    F4l = torch.where(data.xl_mask, z_bl * (Bx - data.x_l), z_bl)
    F4u = torch.where(data.xu_mask, z_bu * (data.x_u - Bx), z_bu)
    return F1, F2, F3l, F3u, F4l, F4u


def _clamped_slacks(data, x):
    """Primal slacks recomputed from x, 1 at inactive bounds and floored
    at ``SLACK_FLOOR`` elsewhere."""
    Bx = data.x_b_scaling * x

    def cl(v):
        return torch.clamp(v, min=SLACK_FLOOR)

    if data.m > 0:
        Gx = ops.G_x(data, x)
        s_l = torch.where(data.hl_mask, cl(Gx - data.h_l), 1.0)
        s_u = torch.where(data.hu_mask, cl(data.h_u - Gx), 1.0)
    else:
        s_l = s_u = x.new_ones((x.shape[0], 0))
    s_bl = torch.where(data.xl_mask, cl(Bx - data.x_l), 1.0)
    s_bu = torch.where(data.xu_mask, cl(data.x_u - Bx), 1.0)
    return s_l, s_u, s_bl, s_bu


def _weights(data, w: BasicVars, slacks):
    s_l, s_u, s_bl, s_bu = slacks
    return (
        torch.where(data.hl_mask, w.z_l / s_l, 0.0),
        torch.where(data.hu_mask, w.z_u / s_u, 0.0),
        torch.where(data.xl_mask, w.z_bl / s_bl, 0.0),
        torch.where(data.xu_mask, w.z_bu / s_bu, 0.0),
    )


# ---------------------------------------------------------------------------
# adjoint saddle solve, dispatched on the data representation
# ---------------------------------------------------------------------------

def _saddle_dense(H, A, r1, r2, refine: int = 2):
    """Solve [H A'; A 0][u1; u2] = [r1; r2] for every problem by the blocked
    signed Cholesky of the (tiny-)regularized quasi-definite matrix, with
    refinement against the exact unregularized operator."""
    Bsz, n = H.shape[0], H.shape[-1]
    p = A.shape[-2]
    N = n + p
    K0 = torch.cat([torch.cat([H, A.mT], dim=-1),
                    torch.cat([A, H.new_zeros((Bsz, p, p))], dim=-1)], dim=-2)
    Np = ldlt.padded_dim(N)
    signs = ldlt.kkt_signs(n, p, 0, Np, H.dtype, H.device)
    # scaled by the problem's magnitude, not by max|H|: H carries the ~1e8
    # active-constraint weights, and a regularization sized by them would
    # drown the O(1) blocks it must protect
    scale = 1.0 + A.abs().amax(dim=(-2, -1)) if p > 0 else H.new_ones((Bsz,))
    K0p = ldlt.pad_quasidef(K0, Np)
    Kp = K0p + torch.diag_embed((1e-11 * scale)[:, None] * signs)
    L, Linvs = ldlt.signed_cholesky(Kp, signs)

    rhs = torch.cat([r1, r2, r1.new_zeros((Bsz, Np - N))], dim=-1)
    u = ldlt.signed_solve(L, Linvs, signs, rhs)
    for _ in range(refine):
        res = rhs - torch.matmul(K0p, u.unsqueeze(-1)).squeeze(-1)
        u = u + ldlt.signed_solve(L, Linvs, signs, res)
    return u[:, :n], u[:, n:N]


@singledispatch
def _solve_adjoint(data, settings, w: BasicVars, slacks, weights, r1, r2):
    """Solve the adjoint saddle system [H A'; A 0][u1; u2] = [r1; r2].

    Dense data (every ``QPData`` type): form H and factor the saddle
    directly.  Stage data is registered below."""
    w_l, w_u, w_bl, w_bu = weights
    B = data.x_b_scaling
    H = data.P + torch.diag_embed(B * B * (w_bl + w_bu))
    if data.m > 0:
        H = H + torch.matmul(data.G.mT, data.G * (w_l + w_u).unsqueeze(-1))
    return _saddle_dense(H, data.A, r1, r2)


@_solve_adjoint.register
def _(data: StageQPData, settings, w: BasicVars, slacks, weights, r1, r2):
    """Adjoint solve through the multistage condensed factorization, so
    the backward pass keeps the forward pass's O(T) structure.

    compute_scalings with the solution's duals, the floored slacks and
    tiny (ρ, δ) gives W_inv = 1/(s/z + δ) ≈ z/s; ``kkt.factor`` factors
    it in float64 (on the card through K2 at every cyclic-reduction
    level).  The δ-softening and the δ-regularized elimination of y are
    corrected by refinement against the exact z/s-weighted operator."""
    s_l, s_u, s_bl, s_bu = slacks
    w_l, w_u, w_bl, w_bu = weights
    x = w.x
    Bsz, dt, dev = x.shape[0], x.dtype, x.device
    vars_adj = Vars(
        x=x, y=w.y, z_l=w.z_l, z_u=w.z_u, z_bl=w.z_bl, z_bu=w.z_bu,
        s_l=s_l, s_u=s_u, s_bl=s_bl, s_bu=s_bu,
    )
    ks = kkt.compute_scalings(
        data, settings, vars_adj,
        rho=torch.full((Bsz,), _ADJ_RHO, dtype=dt, device=dev),
        delta=torch.full((Bsz,), _ADJ_DELTA, dtype=dt, device=dev),
        use_ir=torch.zeros((Bsz,), dtype=torch.bool, device=dev),
        P_diag=torch.zeros_like(x),
    )
    ks, _ok = kkt.factor(data, ks, mixed=False, pre=kkt.precompute(data))

    B = data.x_b_scaling
    xw = B * B * (w_bl + w_bu)

    def Hmul(u):
        out = ops.P_x(data, u) + xw * u
        if data.m > 0:
            out = out + ops.GT_z(data, (w_l + w_u) * ops.G_x(data, u))
        return out

    zeros_z = x.new_zeros((Bsz, data.m))
    u1, u2, _ = kkt._backend_solve(data, ks, r1, r2, zeros_z)
    for _ in range(_ADJ_REFINE):
        res1 = r1 - Hmul(u1)
        if data.p > 0:
            res1 = res1 - ops.AT_y(data, u2)
            res2 = r2 - ops.A_x(data, u1)
        else:
            res2 = torch.zeros_like(r2)
        d1, d2, _ = kkt._backend_solve(data, ks, res1, res2, zeros_z)
        u1 = u1 + d1
        u2 = u2 + d2
    return u1, u2


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

def _adjoint(data, settings: Settings, w: BasicVars, wbar: BasicVars):
    """u = (u1, u2, u3l, u3u, u4l, u4u) with (∂F/∂w)' u = w̄."""
    B = data.x_b_scaling
    slacks = _clamped_slacks(data, w.x)
    weights = _weights(data, w, slacks)
    w_l, w_u, w_bl, w_bu = weights
    s_l, s_u, s_bl, s_bu = slacks

    # the w̄_z parts of the eliminated complementarity rows, moved to the RHS
    r1 = wbar.x - B * (w_bl * wbar.z_bl) + B * (w_bu * wbar.z_bu)
    if data.m > 0:
        r1 = r1 - ops.GT_z(data, w_l * wbar.z_l - w_u * wbar.z_u)
    u1, u2 = _solve_adjoint(data, settings, w, slacks, weights, r1, wbar.y)

    Bu1 = B * u1
    if data.m > 0:
        Gu1 = ops.G_x(data, u1)
        u3l = torch.where(data.hl_mask, (wbar.z_l + Gu1) / s_l, wbar.z_l)
        u3u = torch.where(data.hu_mask, (wbar.z_u - Gu1) / s_u, wbar.z_u)
    else:
        u3l, u3u = wbar.z_l, wbar.z_u
    u4l = torch.where(data.xl_mask, (wbar.z_bl + Bu1) / s_bl, wbar.z_bl)
    u4u = torch.where(data.xu_mask, (wbar.z_bu - Bu1) / s_bu, wbar.z_bu)
    return u1, u2, u3l, u3u, u4l, u4u


class _SolveQPDiff(torch.autograd.Function):
    """The IPM solve with the implicit-function VJP.  The data's fields
    come in flattened (``names`` in ``cls``'s field order) so autograd
    sees each one."""

    @staticmethod
    def forward(ctx, cls, names, settings, cone, *values):
        data = cls(**dict(zip(names, values)))
        sdata, sc = ruiz.equilibrate(
            data, max_iter=settings.preconditioner_iter,
            scale_cost=settings.preconditioner_scale_cost,
        )
        res = solver.solve_scaled(sdata, sc, settings, cone)
        out = (res.x, res.y, res.z_l, res.z_u, res.z_bl, res.z_bu)
        ctx.cls, ctx.names, ctx.settings = cls, names, settings
        ctx.save_for_backward(*values, *out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, *wbar):
        saved = ctx.saved_tensors
        k = len(ctx.names)
        values, w = saved[:k], BasicVars(*saved[k:])
        data = ctx.cls(**dict(zip(ctx.names, values)))
        u = _adjoint(data, ctx.settings, w, BasicVars(*wbar))

        floats = [i for i, v in enumerate(values) if v.is_floating_point()]
        with torch.enable_grad():
            leaves = {i: values[i].detach().requires_grad_() for i in floats}
            d = ctx.cls(**{name: leaves.get(i, values[i])
                           for i, name in enumerate(ctx.names)})
            F = _kkt_residual(d, w.x, w.y, w.z_l, w.z_u, w.z_bl, w.z_bu)
            pairs = [(f, -ui) for f, ui in zip(F, u) if f.requires_grad]
            grads = torch.autograd.grad(
                [f for f, _ in pairs], list(leaves.values()),
                grad_outputs=[g for _, g in pairs], allow_unused=True,
            )
        out = [None] * k
        for i, g in zip(floats, grads):
            out[i] = torch.zeros_like(values[i]) if g is None else g
        return (None, None, None, None, *out)


def solve_qp_diff(data, settings: Settings = Settings(), cone: bool = True) -> BasicVars:
    """Solve the batch of QPs and return (x, y, z_l, z_u, z_bl, z_bu),
    differentiable in every float field of ``data`` by implicit
    differentiation of the KKT conditions (the JAX package's
    ``custom_vjp``; ``torch.autograd.functional.jacobian`` stands in for
    ``jax.jacrev``).

    ``data`` is batched ``QPData`` (``api.prepare_data``,
    ``batch.prepare_batch``) or ``multistage.StageQPData``; its backend
    follows the data's type.  ``cone`` mirrors ``api.has_cone``: pass False
    only for equality-constrained problems.  The in-loop refinement runs
    exact (``refine_mu_factor=0``), because the implicit function theorem
    differentiates the KKT point itself; solve to tight tolerances
    (eps_abs <= 1e-10) for accurate gradients."""
    if settings.refine_mu_factor:
        settings = dataclasses.replace(settings, refine_mu_factor=0.0)
    names = tuple(f.name for f in dataclasses.fields(data))
    out = _SolveQPDiff.apply(type(data), names, settings, cone,
                             *(getattr(data, k) for k in names))
    return BasicVars(*out)


def qp_layer(P, c, A=None, b=None, G=None, h_l=None, h_u=None, x_l=None,
             x_u=None, settings: Settings | None = None, device=None):
    """OptNet-style layer: canonicalize one QP once on the host, and
    return a differentiable ``solve(data) -> x`` with the prepared batched
    ``QPData`` (B = 1) on ``device`` (CUDA unless the caller names
    another).

    >>> solve, data = qp_layer(P, c, G=G, h_u=h, device="cpu")
    >>> data.c.requires_grad_()
    >>> solve(data).sum().backward()   # data.c.grad: d sum(x*) / dc
    """
    settings = settings or Settings()
    data = prepare_data(P, c, A, b, G, h_l, h_u, x_l, x_u,
                        dtype=settings.torch_dtype, device=device)
    cone = has_cone(data)

    def solve(d: QPData) -> torch.Tensor:
        return solve_qp_diff(d, settings, cone).x

    return solve, data
