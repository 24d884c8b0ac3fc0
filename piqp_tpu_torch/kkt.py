"""Condensed KKT system, dense backend (``piqp_tpu/kkt.py``): scalings,
assembly, factorization, solves, iterative refinement and slack/dual
recovery, batched over a leading problem dimension.

References: kkt_system.hpp:143-369 (condensation of the 10-block KKT
system to (x, y, z)) and dense/kkt.hpp:39-177 (the n-by-n condensed matrix
K = P + diag(x_reg) + A'A/delta + G' W^-1 G and its Cholesky factor).

The factor has two representations, chosen by ``Settings.pallas_kernels``:
(L, Linv) from ``ops.chol_inv.cholesky_with_inverse`` (the hand-written
kernel on CUDA), after which every solve is two matrix products against
Linv; or L alone from the library Cholesky, solved by two triangular
solves.  Every reduction is per problem, and the adaptive refinement loop
stops each problem on its own.

As in the JAX package, the data's type selects the backend: ``precompute``,
``factor``, ``condensed_solve_x`` and ``_backend_solve`` dispatch on it
(``functools.singledispatch``).  ``QPData`` is the condensed dense
backend; ``FullKKTQPData`` and ``LDLTKKTQPData`` (``dense_lu`` and
``dense_ldlt``, kkt.py:355-488 of the JAX package) factor the full
3-block KKT matrix instead; ``multistage.py`` registers ``StageQPData``.
"""

from __future__ import annotations

import dataclasses
from functools import singledispatch
from typing import Optional

import torch

from .ops import ldlt
from .ops import matvec as ops
from .ops.chol_inv import cholesky_with_inverse, inv_solve
from .ops.signed_chol_inv import signed_cholesky_with_inverse, signed_inv_solve
from .types import FullKKTQPData, LDLTKKTQPData, QPData, Settings, Vars, max0, select
from .utils.profiling import annotate


@dataclasses.dataclass
class KKTState:
    """Factorization-time state (kkt_system.hpp:32-65 plus the factor).
    Scalars are (B,), vectors (B, k)."""

    rho: torch.Tensor
    delta: torch.Tensor  # unregularized
    delta_reg: torch.Tensor  # delta + static reg (if refinement active)

    # slack / dual copies at factorization time (kkt_system.hpp:152-159)
    s_l: torch.Tensor
    s_u: torch.Tensor
    s_bl: torch.Tensor
    s_bu: torch.Tensor
    z_l_inv: torch.Tensor  # masked-safe 1/z (0 where bound inactive)
    z_u_inv: torch.Tensor
    z_bl_inv: torch.Tensor
    z_bu_inv: torch.Tensor

    W_l_inv: torch.Tensor  # (B, m) 1/(s_l/z_l + delta), 0 where inactive
    W_u_inv: torch.Tensor
    W_bl_inv: torch.Tensor  # (B, n) box analogs
    W_bu_inv: torch.Tensor
    x_reg: torch.Tensor  # (B, n) rho + box terms (+ static reg if IR)
    z_reg: torch.Tensor  # (B, m) 1/(W_l_inv + W_u_inv), no static reg
    z_reg_fact: torch.Tensor  # (B, m) z_reg + static reg; used by the factor

    use_ir: torch.Tensor  # (B,) bool: static regularization active
    L: Optional[torch.Tensor] = None  # (B, n, n) lower factor of K
    Linv: Optional[torch.Tensor] = None  # (B, n, n) L^-1, inverse form only
    # the factor of the other backends, a tuple (dense_lu, dense_ldlt) or a
    # nested tuple (multistage) of batched tensors, as the JAX package's L
    factor: Optional[tuple] = None


def _safe_inv(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, 1.0 / torch.where(mask, x, 1.0), 0.0)


def compute_scalings(
    data: QPData,
    settings: Settings,
    vars: Vars,
    rho: torch.Tensor,
    delta: torch.Tensor,
    use_ir: torch.Tensor,
    P_diag: torch.Tensor,
) -> KKTState:
    """Diagonal scalings x_reg/z_reg (kkt_system.hpp:143-211).  ``use_ir``
    adds the static regularization of iterative refinement
    (kkt_system.hpp:195-207) to x_reg, z_reg_fact and delta_reg; the
    refinement target keeps the unregularized z_reg and delta."""
    d = delta[:, None]
    z_l_inv = _safe_inv(vars.z_l, data.hl_mask)
    z_u_inv = _safe_inv(vars.z_u, data.hu_mask)
    z_bl_inv = _safe_inv(vars.z_bl, data.xl_mask)
    z_bu_inv = _safe_inv(vars.z_bu, data.xu_mask)

    W_l_inv = torch.where(data.hl_mask, 1.0 / (z_l_inv * vars.s_l + d), 0.0)
    W_u_inv = torch.where(data.hu_mask, 1.0 / (z_u_inv * vars.s_u + d), 0.0)
    W_bl_inv = torch.where(data.xl_mask, 1.0 / (z_bl_inv * vars.s_bl + d), 0.0)
    W_bu_inv = torch.where(data.xu_mask, 1.0 / (z_bu_inv * vars.s_bu + d), 0.0)

    xb2 = data.x_b_scaling * data.x_b_scaling
    x_reg = rho[:, None] + xb2 * W_bl_inv + xb2 * W_bu_inv  # kkt_system.hpp:161-175

    z_reg_sum = W_l_inv + W_u_inv
    pos = z_reg_sum > 0
    z_reg = torch.where(pos, 1.0 / torch.where(pos, z_reg_sum, 1.0), 0.0)

    # static regularization (kkt_system.hpp:195-207), sized per problem
    max_diag = torch.maximum(max0((P_diag + x_reg).abs()), max0(z_reg.abs()))
    reg = (
        settings.iterative_refinement_static_regularization_eps
        + settings.static_reg_rel() * max_diag
    )
    reg = torch.where(use_ir, reg, 0.0)

    return KKTState(
        rho=rho, delta=delta, delta_reg=delta + reg,
        s_l=vars.s_l, s_u=vars.s_u, s_bl=vars.s_bl, s_bu=vars.s_bu,
        z_l_inv=z_l_inv, z_u_inv=z_u_inv, z_bl_inv=z_bl_inv, z_bu_inv=z_bu_inv,
        W_l_inv=W_l_inv, W_u_inv=W_u_inv, W_bl_inv=W_bl_inv, W_bu_inv=W_bu_inv,
        x_reg=x_reg + reg[:, None],
        z_reg=z_reg,
        z_reg_fact=z_reg + reg[:, None],
        use_ir=use_ir,
    )


@singledispatch
def precompute(data, mixed: bool = False):
    """Loop-invariant terms reused by every factorization (the reference
    caches A'A at setup, dense/kkt.hpp:51-55), or None when the backend
    has nothing to cache.  ``mixed=True`` also keeps float32 copies of the
    matrices (``data32``, and ``AtA32`` for dense data) for the float32
    phase of mixed precision."""
    return None


@precompute.register
def _(data: QPData, mixed: bool = False) -> dict:
    pre = {}
    if data.p > 0:
        pre["AtA"] = torch.matmul(data.A.mT, data.A)
    if mixed:
        f32 = torch.float32
        pre["data32"] = dataclasses.replace(
            data, P=data.P.to(f32), A=data.A.to(f32), G=data.G.to(f32)
        )
        if data.p > 0:
            pre["AtA32"] = pre["AtA"].to(f32)
    return pre


def assemble_condensed(data: QPData, ks: KKTState, pre: dict | None = None):
    """K = P + diag(x_reg) + (1/delta_reg) A'A + G' diag(1/z_reg_fact) G
    (dense/kkt.hpp:140-160), in the dtype of ``data.P``."""
    K = data.P + torch.diag_embed(ks.x_reg)
    if data.p > 0:
        AtA = (pre or {}).get("AtA")
        if AtA is None:
            AtA = torch.matmul(data.A.mT, data.A)
        if K.dtype == torch.float32 and pre and "AtA32" in pre:
            AtA = pre["AtA32"]
        K = K + AtA.to(K.dtype) / ks.delta_reg[:, None, None]
    if data.m > 0:
        z_reg_fact_inv = 1.0 / ks.z_reg_fact
        K = K + torch.matmul(data.G.mT, z_reg_fact_inv[:, :, None] * data.G)
    return K


def _all_finite(M: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(M).flatten(1).all(dim=1)


@singledispatch
def factor(
    data, ks: KKTState, mixed: bool = False, pre=None, inverse: bool = True,
) -> tuple[KKTState, torch.Tensor]:
    """Factor the KKT system of every problem; the backend is chosen by the
    data's type.  ``ok`` (B,) is False where the factor came out
    non-finite.  ``mixed=True`` factors in float32; ``inverse=True``
    (``Settings.factor_inverse``) keeps explicit inverses from the
    hand-written kernels."""
    raise NotImplementedError(type(data))


@factor.register
def _factor_dense(
    data: QPData, ks: KKTState, mixed: bool = False, pre: dict | None = None,
    inverse: bool = True,
) -> tuple[KKTState, torch.Tensor]:
    """Factor the condensed matrix of every problem; ``ok`` (B,) is False
    where the factor came out non-finite (dense/kkt.hpp:82-83).

    ``mixed=True`` assembles and factors in float32 after a Jacobi scaling
    to unit diagonal (chol(K) = D chol(D^-1 K D^-1) exactly), which keeps
    the pivots inside float32 range.  ``inverse=True`` keeps (L, Linv)
    from ``cholesky_with_inverse`` (always Jacobi-scaled, as in the JAX
    package); False keeps the library Cholesky factor L."""
    dt = torch.float32 if mixed else data.P.dtype
    if mixed or inverse:
        if mixed and pre and "data32" in pre:
            dd = pre["data32"]
        else:
            dd = dataclasses.replace(
                data, P=data.P.to(dt), A=data.A.to(dt), G=data.G.to(dt)
            )
        ks_f = dataclasses.replace(
            ks, x_reg=ks.x_reg.to(dt), z_reg_fact=ks.z_reg_fact.to(dt),
            delta_reg=ks.delta_reg.to(dt),
        )
        K = assemble_condensed(dd, ks_f, pre)
        dK = torch.sqrt(torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1), min=1e-30))
        dinv = 1.0 / dK
        Ks = K * dinv[:, :, None] * dinv[:, None, :]
        if inverse:
            Ls, Lsinv = cholesky_with_inverse(Ks)
            L = Ls * dK[:, :, None]
            Linv = Lsinv * dinv[:, None, :]
            ok = _all_finite(L) & _all_finite(Linv)
            return dataclasses.replace(ks, L=L, Linv=Linv), ok
        L, info = torch.linalg.cholesky_ex(Ks)
        L = L * dK[:, :, None]
    else:
        K = assemble_condensed(data, ks, pre)
        L, info = torch.linalg.cholesky_ex(K)
    # a failed library Cholesky reports through ``info``; give it the
    # non-finite factor the kernel route gives
    L = torch.where((info == 0)[:, None, None], L, torch.nan)
    return dataclasses.replace(ks, L=L, Linv=None), _all_finite(L)


@singledispatch
def condensed_solve_x(data, ks: KKTState, v: torch.Tensor) -> torch.Tensor:
    """Solve K lx = v with the factored condensed matrix, in the factor's
    precision, and cast back to v's dtype."""
    raise NotImplementedError(type(data))


@condensed_solve_x.register
def _(data: QPData, ks: KKTState, v: torch.Tensor) -> torch.Tensor:
    if ks.Linv is not None:
        return inv_solve(ks.Linv, v.to(ks.Linv.dtype)).to(v.dtype)
    vf = v.to(ks.L.dtype).unsqueeze(-1)
    lx = torch.linalg.solve_triangular(ks.L, vf, upper=False)
    lx = torch.linalg.solve_triangular(ks.L.mT, lx, upper=True)
    return lx.squeeze(-1).to(v.dtype)


@singledispatch
def _backend_solve(data, ks: KKTState, rx, ry, rz, mat32=None):
    """Condensed backend solve (dense/kkt.hpp:86-105), given the dispatched
    matvecs and K-solve.  ``mat32``: float32 copy of the data (precompute's
    data32); the condensation and recovery matvecs then read float32
    matrices with float32 operands."""
    if mat32 is not None:
        f32 = torch.float32
        v = ops.add_AtGt(
            mat32, rx,
            (ry / ks.delta_reg[:, None]).to(f32),
            (rz / ks.z_reg_fact).to(f32),
        )
        lx = condensed_solve_x(data, ks, v)
        Ax, Gx = ops.AG_x(mat32, lx.to(f32))
    else:
        v = ops.add_AtGt(data, rx, ry / ks.delta_reg[:, None], rz / ks.z_reg_fact)
        lx = condensed_solve_x(data, ks, v)
        Ax, Gx = ops.AG_x(data, lx)
    ly = (Ax - ry) / ks.delta_reg[:, None] if data.p > 0 else torch.zeros_like(ry)
    lz = (Gx - rz) / ks.z_reg_fact if data.m > 0 else torch.zeros_like(rz)
    return lx, ly, lz


# ---------------------------------------------------------------------------
# full 3-block dense KKT backends (KKTBackend.dense_lu / dense_ldlt)
# ---------------------------------------------------------------------------

def assemble_full_kkt(data: QPData, ks: KKTState, dt) -> torch.Tensor:
    """The full regularized 3-block (n+p+m) KKT matrix of every problem

        [ P + diag(x_reg)   A'                G'               ]
        [ A                 -delta_reg I                       ]
        [ G                                   -diag(z_reg_fac) ]

    in dtype ``dt`` (the dense analog of the reference's KKT_FULL mode,
    sparse/kkt_full.hpp:22-252)."""
    n, p, m = data.n, data.p, data.m
    K = data.P.new_zeros((data.B, n + p + m, n + p + m), dtype=dt)
    K[:, :n, :n] = data.P.to(dt) + torch.diag_embed(ks.x_reg.to(dt))
    A, G = data.A.to(dt), data.G.to(dt)
    K[:, n:n + p, :n] = A
    K[:, :n, n:n + p] = A.mT
    K[:, n + p:, :n] = G
    K[:, :n, n + p:] = G.mT
    eye_p = torch.eye(p, dtype=dt, device=K.device)
    K[:, n:n + p, n:n + p] = -ks.delta_reg.to(dt)[:, None, None] * eye_p
    K[:, n + p:, n + p:] = -torch.diag_embed(ks.z_reg_fact.to(dt))
    return K


@precompute.register
def _(data: FullKKTQPData, mixed: bool = False):
    return None


@factor.register
def _factor_full_lu(
    data: FullKKTQPData, ks: KKTState, mixed: bool = False, pre=None,
    inverse: bool = True,
):
    """Pivoted LU of the full KKT matrix (library LU, which the JAX package
    also leaves to XLA): the full form keeps the condition number at
    kappa(KKT) instead of the condensed form's kappa^2.  ``inverse`` has no
    effect here."""
    K = assemble_full_kkt(data, ks, torch.float32 if mixed else data.P.dtype)
    LU, piv, _ = torch.linalg.lu_factor_ex(K)
    return dataclasses.replace(ks, factor=(LU, piv)), _all_finite(LU)


@_backend_solve.register
def _(data: FullKKTQPData, ks: KKTState, rx, ry, rz, mat32=None):
    LU, piv = ks.factor
    rhs = torch.cat([rx, ry, rz], dim=-1).to(LU.dtype)
    sol = torch.linalg.lu_solve(LU, piv, rhs.unsqueeze(-1)).squeeze(-1).to(rx.dtype)
    n, p = data.n, data.p
    return sol[:, :n], sol[:, n:n + p], sol[:, n + p:]


@precompute.register
def _(data: LDLTKKTQPData, mixed: bool = False):
    return None


@factor.register
def _factor_full_ldlt(
    data: LDLTKKTQPData, ks: KKTState, mixed: bool = False, pre=None,
    inverse: bool = True,
):
    """Signed Cholesky (LDL^T without pivoting) of the full quasi-definite
    KKT matrix, embedded with identity padding in ``ldlt.padded_dim`` rows
    (the reference's dense::LDLTNoPivot, dense/ldlt_no_pivot.hpp:279-354).
    ``inverse=True``: (L, Linv) from ``signed_cholesky_with_inverse`` (the
    K3 kernel on CUDA); False: (L, block inverses) from the blocked
    ``ldlt.signed_cholesky``."""
    dt = torch.float32 if mixed else data.P.dtype
    K = assemble_full_kkt(data, ks, dt)
    Np = ldlt.padded_dim(data.n + data.p + data.m)
    Kp = ldlt.pad_quasidef(K, Np)
    signs = ldlt.kkt_signs(data.n, data.p, data.m, Np, dt, K.device)
    if inverse:
        L, Linvs = signed_cholesky_with_inverse(Kp, signs)
    else:
        L, Linvs = ldlt.signed_cholesky(Kp, signs)
    ok = _all_finite(L) & _all_finite(Linvs)
    return dataclasses.replace(ks, factor=(L, Linvs)), ok


@_backend_solve.register
def _(data: LDLTKKTQPData, ks: KKTState, rx, ry, rz, mat32=None):
    L, Linvs = ks.factor
    n, p, m = data.n, data.p, data.m
    Np = L.shape[-1]
    signs = ldlt.kkt_signs(n, p, m, Np, L.dtype, L.device)
    rhs = torch.cat([rx, ry, rz], dim=-1).to(L.dtype)
    rhs = torch.cat([rhs, rhs.new_zeros((rhs.shape[0], Np - n - p - m))], dim=-1)
    if Linvs.ndim == 3:
        sol = signed_inv_solve(Linvs, signs, rhs)
    else:
        sol = ldlt.signed_solve(L, Linvs, signs, rhs)
    sol = sol.to(rx.dtype)
    return sol[:, :n], sol[:, n:n + p], sol[:, n + p:n + p + m]


def mul_condensed(data: QPData, ks: KKTState, lx, ly, lz, mat32=None):
    """Condensed KKT matvec for refinement (kkt_system.hpp:507-519): the
    (possibly statically regularized) x_reg with the unregularized delta
    and z_reg, as the reference does.  ``mat32``: float32 matrices and
    operands (mixed phase A)."""
    md = data if mat32 is None else mat32
    f32 = torch.float32
    lxm = lx if mat32 is None else lx.to(f32)
    Px, Ax, Gx = ops.PAG_x(md, lxm)
    rx0 = Px + ks.x_reg * lx
    if mat32 is None:
        rx = ops.add_AtGt(md, rx0, ly, lz)
    else:
        rx = ops.add_AtGt(md, rx0, ly.to(f32), lz.to(f32))
    ry = Ax - ks.delta[:, None] * ly if data.p > 0 else torch.zeros_like(ly)
    rz = Gx - ks.z_reg * lz if data.m > 0 else torch.zeros_like(lz)
    return rx, ry, rz


def mul_full(data: QPData, ks: KKTState, lhs: Vars) -> Vars:
    """Full (uncondensed) 10-block regularized KKT matvec
    (kkt_system.hpp:392-425); the round-trip oracle of the tests."""
    delta = ks.delta[:, None]
    rx = ops.P_x(data, lhs.x) + ks.rho[:, None] * lhs.x
    ry = torch.zeros_like(lhs.y)
    if data.p > 0:
        rx = rx + ops.AT_y(data, lhs.y)
        ry = ops.A_x(data, lhs.x) - delta * lhs.y
    Gx = ops.G_x(data, lhs.x) if data.m > 0 else torch.zeros_like(lhs.z_l)
    if data.m > 0:
        rx = rx + ops.GT_z(data, lhs.z_u - lhs.z_l)
    rz_l = torch.where(data.hl_mask, -Gx + lhs.s_l - delta * lhs.z_l, 0.0)
    rz_u = torch.where(data.hu_mask, Gx + lhs.s_u - delta * lhs.z_u, 0.0)
    # complementarity rows: S dz + Z ds (ks holds s and 1/z at factor time)
    z_l = _safe_inv(ks.z_l_inv, data.hl_mask)
    z_u = _safe_inv(ks.z_u_inv, data.hu_mask)
    z_bl = _safe_inv(ks.z_bl_inv, data.xl_mask)
    z_bu = _safe_inv(ks.z_bu_inv, data.xu_mask)
    rs_l = ks.s_l * lhs.z_l + z_l * lhs.s_l
    rs_u = ks.s_u * lhs.z_u + z_u * lhs.s_u

    xb = data.x_b_scaling
    rx = rx - torch.where(data.xl_mask, xb * lhs.z_bl, 0.0)
    rx = rx + torch.where(data.xu_mask, xb * lhs.z_bu, 0.0)
    rz_bl = torch.where(
        data.xl_mask, -xb * lhs.x - delta * lhs.z_bl + lhs.s_bl, 0.0
    )
    rz_bu = torch.where(
        data.xu_mask, xb * lhs.x - delta * lhs.z_bu + lhs.s_bu, 0.0
    )
    rs_bl = ks.s_bl * lhs.z_bl + z_bl * lhs.s_bl
    rs_bu = ks.s_bu * lhs.z_bu + z_bu * lhs.s_bu
    return Vars(
        x=rx, y=ry, z_l=rz_l, z_u=rz_u, z_bl=rz_bl, z_bu=rz_bu,
        s_l=rs_l, s_u=rs_u, s_bl=rs_bl, s_bu=rs_bu,
    )


def _inf3(x, y, z):
    """max(|x|, |y|, |z|) per problem."""
    return torch.maximum(
        max0(x.abs()), torch.maximum(max0(y.abs()), max0(z.abs()))
    )


def _refine_error(data, ks, lx, ly, lz, rx, ry, rz, mat32=None):
    ex, ey, ez = mul_condensed(data, ks, lx, ly, lz, mat32)
    ex, ey, ez = rx - ex, ry - ey, rz - ez
    return ex, ey, ez, _inf3(ex, ey, ez)


def _finite_sum(*vs) -> torch.Tensor:
    total = sum(v.sum(dim=-1) for v in vs)
    return torch.isfinite(total)


def _solve_condensed_refined(
    data: QPData, settings: Settings, ks: KKTState, rx, ry, rz, mu=None,
    mat32=None, active=None,
):
    """Backend solve + iterative refinement (kkt_system.hpp:254-308), always
    on, against the unregularized target.

    ``mu`` (B,): with ``settings.refine_mu_factor > 0`` the exit tolerance
    is relaxed to ``max(tol, refine_mu_factor * mu)`` (inexact IPM).  With
    ``mat32`` as well and ``refine_static_passes >= 0`` (mixed phase A),
    exactly that many correction passes run with no error norms.
    Otherwise the adaptive loop runs: each problem stops on its own when
    its error is below tolerance, stops improving or turns non-finite.
    ``active`` (B,) limits the loop to the problems whose result is used.
    Returns (lx, ly, lz, ok) with ok (B,)."""
    lx, ly, lz = _backend_solve(data, ks, rx, ry, rz, mat32)

    if (
        mat32 is not None
        and mu is not None
        and settings.refine_mu_factor > 0
        and settings.refine_static_passes >= 0
    ):
        for _ in range(settings.refine_static_passes):
            ex, ey, ez = mul_condensed(data, ks, lx, ly, lz, mat32)
            dx, dy, dz = _backend_solve(
                data, ks, rx - ex, ry - ey, rz - ez, mat32
            )
            lx, ly, lz = lx + dx, ly + dy, lz + dz
        return lx, ly, lz, _finite_sum(lx, ly, lz)

    rhs_norm = _inf3(rx, ry, rz)
    ex, ey, ez, err = _refine_error(data, ks, lx, ly, lz, rx, ry, rz, mat32)
    ok = torch.isfinite(err)

    tol = (
        settings.iterative_refinement_eps_abs
        + settings.iterative_refinement_eps_rel * rhs_norm
    )
    if settings.refine_mu_factor > 0 and mu is not None:
        tol = torch.maximum(tol, settings.refine_mu_factor * mu)
    if mat32 is not None:
        # the residual is computed against float32 matrices: error below
        # float32 noise is unmeasurable
        tol = torch.maximum(
            tol, 32.0 * torch.finfo(torch.float32).eps * rhs_norm
        )

    done = torch.zeros_like(ok)
    for _ in range(settings.iterative_refinement_max_iter):
        run = ~done & ok & (err > tol)
        if active is not None:
            run = run & active
        if not bool(run.any()):
            break
        dx, dy, dz = _backend_solve(data, ks, ex, ey, ez, mat32)
        cx, cy, cz = lx + dx, ly + dy, lz + dz
        nex, ney, nez, nerr = _refine_error(
            data, ks, cx, cy, cz, rx, ry, rz, mat32
        )
        nok = torch.isfinite(nerr)
        rate = err / nerr
        slow = rate < settings.iterative_refinement_min_improvement_rate
        # kkt_system.hpp:289-301: on slow improvement keep the better
        # iterate and stop; otherwise accept and continue
        accept = run & nok & (~slow | (rate > 1.0))
        lx, ly, lz, ex, ey, ez, err = select(
            accept, (cx, cy, cz, nex, ney, nez, nerr),
            (lx, ly, lz, ex, ey, ez, err),
        )
        done = torch.where(run, slow, done)
        ok = torch.where(run, nok, ok)
    return lx, ly, lz, ok


def solve(
    data: QPData, settings: Settings, ks: KKTState, rhs: Vars, mu=None,
    mat32=None, active=None,
) -> tuple[Vars, torch.Tensor]:
    """Full KKT solve: condense the right-hand side, solve the (x, y, z)
    system, recover the slack/dual directions (kkt_system.hpp:213-369).
    Returns (lhs, ok) with ok (B,)."""
    with annotate("piqp.kkt.solve"):
        return _solve(data, settings, ks, rhs, mu, mat32, active)


def _solve(data, settings, ks, rhs, mu, mat32, active):
    # condensed inequality RHS (kkt_system.hpp:219-234)
    rz_l_bar = torch.where(data.hl_mask, rhs.z_l - ks.z_l_inv * rhs.s_l, 0.0)
    rz_u_bar = torch.where(data.hu_mask, rhs.z_u - ks.z_u_inv * rhs.s_u, 0.0)
    rhs_z_bar = ks.z_reg * (-ks.W_l_inv * rz_l_bar + ks.W_u_inv * rz_u_bar)

    # condensed primal RHS with box eliminations (kkt_system.hpp:236-252)
    rb_l_bar = torch.where(data.xl_mask, rhs.z_bl - ks.z_bl_inv * rhs.s_bl, 0.0)
    rb_u_bar = torch.where(data.xu_mask, rhs.z_bu - ks.z_bu_inv * rhs.s_bu, 0.0)
    rhs_x_bar = (
        rhs.x
        - data.x_b_scaling * ks.W_bl_inv * rb_l_bar
        + data.x_b_scaling * ks.W_bu_inv * rb_u_bar
    )

    lx, ly, lz, ok = _solve_condensed_refined(
        data, settings, ks, rhs_x_bar, rhs.y, rhs_z_bar, mu, mat32, active
    )

    # inequality dual/slack recovery (kkt_system.hpp:310-345)
    r_sum = ks.W_l_inv * ks.W_u_inv * (rz_l_bar + rz_u_bar)
    lz_l = torch.where(data.hl_mask, -ks.z_reg * (r_sum + ks.W_l_inv * lz), 0.0)
    lz_u = torch.where(data.hu_mask, -ks.z_reg * (r_sum - ks.W_u_inv * lz), 0.0)
    ls_l = torch.where(data.hl_mask, ks.z_l_inv * (rhs.s_l - ks.s_l * lz_l), 0.0)
    ls_u = torch.where(data.hu_mask, ks.z_u_inv * (rhs.s_u - ks.s_u * lz_u), 0.0)

    # box dual/slack recovery (kkt_system.hpp:347-366)
    xb = data.x_b_scaling
    lz_bl = torch.where(
        data.xl_mask,
        (-xb * lx - rhs.z_bl + ks.z_bl_inv * rhs.s_bl) * ks.W_bl_inv, 0.0,
    )
    lz_bu = torch.where(
        data.xu_mask,
        (xb * lx - rhs.z_bu + ks.z_bu_inv * rhs.s_bu) * ks.W_bu_inv, 0.0,
    )
    ls_bl = torch.where(
        data.xl_mask, ks.z_bl_inv * (rhs.s_bl - ks.s_bl * lz_bl), 0.0
    )
    ls_bu = torch.where(
        data.xu_mask, ks.z_bu_inv * (rhs.s_bu - ks.s_bu * lz_bu), 0.0
    )
    lhs = Vars(
        x=lx, y=ly, z_l=lz_l, z_u=lz_u, z_bl=lz_bl, z_bu=lz_bu,
        s_l=ls_l, s_u=ls_u, s_bl=ls_bl, s_bu=ls_bu,
    )
    return lhs, ok
