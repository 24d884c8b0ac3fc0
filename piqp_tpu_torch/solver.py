"""The proximal interior-point method (``piqp_tpu/solver.py``; reference
SolverBase::solve_impl, solver.hpp:379-1259), batched.

The JAX package runs each problem's IPM as a ``lax.while_loop`` and gets
a batch from ``vmap``.  Here every loop is a host loop over a batched
state with a per-problem mask, and every update is ``types.select``, which
reproduces ``vmap`` of a ``while_loop``: a problem whose loop condition is
false is frozen while the others go on, so each problem takes exactly the
iterations it would take alone.  A ``lax.cond`` becomes "compute, then
select per problem"; both branches are only computed when some problem
takes them.  Every reduction runs over a problem's own entries, never
across the batch.  The loops cost one host synchronisation per trip.
"""

from __future__ import annotations

import dataclasses

import torch

from . import graphs, kkt
from .ops import matvec as ops
from .types import (
    CERT_EQ_TOL,
    CERT_NEG_TOL,
    CERT_SUP_TOL,
    PIQP_INF,
    BasicVars,
    Info,
    QPData,
    Result,
    Scaling,
    Settings,
    Status,
    Vars,
    init_info,
    max0,
    min0,
    select,
    tree_map,
)
from .utils.profiling import annotate

_TINY = 1e-30
_RUNNING = int(Status.RUNNING)


@dataclasses.dataclass
class IPMState:
    """Per-problem IPM state.  Unlike the JAX package's IPMState it holds no
    KKT factor: every iteration refactors before its first solve, so the
    factor never outlives the iteration that made it."""

    vars: Vars
    prox: BasicVars  # proximal center (xi, lambda, nu) (solver.hpp:53)
    res_nr: BasicVars  # non-regularized residuals
    res: Vars  # regularized residuals / KKT RHS workspace
    info: Info
    use_ir: torch.Tensor  # (B,) bool: iterative refinement enabled


def _inf_norm(v: torch.Tensor) -> torch.Tensor:
    return max0(v.abs())


def _masked_signed_max(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """max over active entries of the *signed* value, 0 if none
    (solver.hpp:1047,1066,1081,1139-1143)."""
    return max0(torch.where(mask, v, 0.0))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


def _col(s: torch.Tensor) -> torch.Tensor:
    """(B,) per-problem scalar -> (B, 1) for broadcasting against vectors."""
    return s[:, None]


# ---------------------------------------------------------------------------
# residuals
# ---------------------------------------------------------------------------

def residuals_nr(
    data: QPData, sc: Scaling, vars: Vars, info: Info, mat32=None
) -> tuple[BasicVars, Info]:
    """Non-regularized residuals, objectives and relative norms
    (solver.hpp:960-1105).  ``mat32``: float32 copy of the matrices (mixed
    phase A); outputs are cast back to the solver dtype."""
    x, y = vars.x, vars.y
    dt = x.dtype

    if mat32 is not None:
        Px, Ax, Gx = ops.PAG_x(mat32, x.to(torch.float32))
        Px, Ax, Gx = Px.to(dt), Ax.to(dt), Gx.to(dt)
    else:
        Px, Ax, Gx = ops.PAG_x(data, x)
    if data.p == 0:
        Ax = torch.zeros_like(vars.y)
    if data.m == 0:
        Gx = torch.zeros_like(vars.z_l)
    dz = vars.z_u - vars.z_l

    c_inv = 1.0 / sc.c
    ud_x = sc.d_x * _col(c_inv)  # unscale_dual_res factor (preconditioner.hpp:414-417)

    dual_rel = _inf_norm(Px * ud_x)

    # objectives & duality gap (solver.hpp:987-1016)
    xPx = _dot(x, Px)
    cx = _dot(data.c, x)
    by = _dot(data.b, y)
    hlzl = _dot(data.h_l, vars.z_l)
    huzu = _dot(data.h_u, vars.z_u)
    xlzbl = _dot(data.x_l, vars.z_bl)
    xuzbu = _dot(data.x_u, vars.z_bu)

    primal_obj = 0.5 * xPx + cx
    dual_obj = -0.5 * xPx - by + hlzl - huzu + xlzbl - xuzbu
    gap_rel_norm = c_inv * torch.stack(
        [xPx.abs(), cx.abs(), by.abs(), hlzl.abs(), huzu.abs(), xlzbl.abs(),
         xuzbu.abs()], dim=-1,
    ).amax(dim=-1)
    duality_gap = (primal_obj - dual_obj).abs() * c_inv
    primal_obj = primal_obj * c_inv
    dual_obj = dual_obj * c_inv
    duality_gap_rel = duality_gap / torch.clamp(gap_rel_norm, min=1.0)

    # dual residual (solver.hpp:1018-1032)
    work_x = (
        torch.where(data.xu_mask, data.x_b_scaling * vars.z_bu, 0.0)
        - torch.where(data.xl_mask, data.x_b_scaling * vars.z_bl, 0.0)
    )
    if mat32 is not None:
        f32 = torch.float32
        work_x = ops.add_AtGt(
            mat32, work_x.to(f32), y.to(f32), dz.to(f32)
        ).to(dt)
    else:
        work_x = ops.add_AtGt(data, work_x, y, dz)
    dual_rel = torch.maximum(dual_rel, _inf_norm(data.c * ud_x))
    dual_rel = torch.maximum(dual_rel, _inf_norm(work_x * ud_x))
    res_x = -Px - data.c - work_x

    # primal residuals (solver.hpp:1034-1095)
    d_y_inv = 1.0 / sc.d_y
    d_z_inv = 1.0 / sc.d_z
    d_b_inv = 1.0 / sc.d_b

    primal_rel = torch.maximum(
        _inf_norm(Ax * d_y_inv), _inf_norm(data.b * d_y_inv)
    )
    res_y = data.b - Ax

    res_z_l = torch.where(data.hl_mask, Gx - data.h_l - vars.s_l, 0.0)
    res_z_u = torch.where(data.hu_mask, -Gx + data.h_u - vars.s_u, 0.0)
    m_rows = torch.cat(
        [Gx, data.h_l, vars.s_l, -Gx, data.h_u, vars.s_u], dim=-1
    ) * d_z_inv.repeat(1, 6)
    m_mask = torch.cat([data.hl_mask] * 3 + [data.hu_mask] * 3, dim=-1)
    primal_rel = torch.maximum(primal_rel, _masked_signed_max(m_rows, m_mask))

    bx = data.x_b_scaling * x
    res_z_bl = torch.where(data.xl_mask, bx - data.x_l - vars.s_bl, 0.0)
    res_z_bu = torch.where(data.xu_mask, -bx + data.x_u - vars.s_bu, 0.0)
    n_rows = torch.cat(
        [bx, data.x_l, vars.s_bl, -bx, data.x_u, vars.s_bu], dim=-1
    ) * d_b_inv.repeat(1, 6)
    n_mask = torch.cat([data.xl_mask] * 3 + [data.xu_mask] * 3, dim=-1)
    primal_rel = torch.maximum(primal_rel, _masked_signed_max(n_rows, n_mask))

    res_nr = BasicVars(res_x, res_y, res_z_l, res_z_u, res_z_bl, res_z_bu)

    primal_res = _primal_res_norm(data, sc, res_nr)
    dual_res = _inf_norm(res_x * ud_x)

    info = dataclasses.replace(
        info,
        prev_primal_res=info.primal_res,
        prev_dual_res=info.dual_res,
        primal_res=primal_res,
        primal_res_rel=primal_res / torch.clamp(primal_rel, min=1.0),
        dual_res=dual_res,
        dual_res_rel=dual_res / torch.clamp(dual_rel, min=1.0),
        primal_obj=primal_obj,
        dual_obj=dual_obj,
        duality_gap=duality_gap,
        duality_gap_rel=duality_gap_rel,
    )
    return res_nr, info


def _primal_res_norm(data: QPData, sc: Scaling, r) -> torch.Tensor:
    """Infinity norm of the unscaled primal residual (solver.hpp:1130-1146);
    box contributions are signed per-index maxima, as in the reference."""
    inf = _inf_norm(r.y / sc.d_y)
    inf = torch.maximum(inf, _inf_norm(torch.cat([r.z_l, r.z_u], -1) / sc.d_z.repeat(1, 2)))
    zb = torch.cat([r.z_bl, r.z_bu], -1) / sc.d_b.repeat(1, 2)
    zb_mask = torch.cat([data.xl_mask, data.xu_mask], -1)
    return torch.maximum(inf, _masked_signed_max(zb, zb_mask))


def residuals_r(
    data: QPData, sc: Scaling, vars: Vars, prox: BasicVars,
    res_nr: BasicVars, res: Vars, info: Info,
) -> tuple[Vars, Info]:
    """Regularized residuals + proximal infeasibility measures
    (solver.hpp:1107-1128)."""
    rho, delta = _col(info.rho), _col(info.delta)
    res = dataclasses.replace(
        res,
        x=res_nr.x - rho * (vars.x - prox.x),
        y=res_nr.y - delta * (prox.y - vars.y),
        z_l=res_nr.z_l - delta * (prox.z_l - vars.z_l),
        z_u=res_nr.z_u - delta * (prox.z_u - vars.z_u),
        z_bl=res_nr.z_bl - delta * (prox.z_bl - vars.z_bl),
        z_bu=res_nr.z_bu - delta * (prox.z_bu - vars.z_bu),
    )

    primal_rel_scaling = torch.where(
        info.primal_res_rel > 0, info.primal_res / info.primal_res_rel, 1.0
    )
    dual_rel_scaling = torch.where(
        info.dual_res_rel > 0, info.dual_res / info.dual_res_rel, 1.0
    )

    c_inv = _col(1.0 / sc.c)
    primal_res_reg = _primal_res_norm(data, sc, res)
    dual_res_reg = _inf_norm(res.x * sc.d_x * c_inv)

    # primal_prox_inf (solver.hpp:1166-1182): dual-variable drift from the
    # proximal center, in unscaled dual units.
    ppi = _inf_norm((prox.y - vars.y) * sc.d_y * c_inv)
    ppi = torch.maximum(ppi, _inf_norm((prox.z_l - vars.z_l) * sc.d_z * c_inv))
    ppi = torch.maximum(ppi, _inf_norm((prox.z_u - vars.z_u) * sc.d_z * c_inv))
    ppi = torch.maximum(ppi, _masked_signed_max(
        (prox.z_bl - vars.z_bl) * sc.d_b * c_inv, data.xl_mask))
    ppi = torch.maximum(ppi, _masked_signed_max(
        (prox.z_bu - vars.z_bu) * sc.d_b * c_inv, data.xu_mask))

    dpi = _inf_norm((vars.x - prox.x) * sc.d_x)

    info = dataclasses.replace(
        info,
        primal_res_reg=primal_res_reg,
        primal_res_reg_rel=primal_res_reg / primal_rel_scaling,
        dual_res_reg=dual_res_reg,
        dual_res_reg_rel=dual_res_reg / dual_rel_scaling,
        primal_prox_inf=ppi * info.delta,
        dual_prox_inf=dpi * info.rho,
    )
    return res, info


# ---------------------------------------------------------------------------
# Farkas certificate validation (piqp_tpu/solver.py:261-491)
# ---------------------------------------------------------------------------

def _certificate_qualities(data, sc, vars: Vars, prox: BasicVars):
    """Score the proximal drift as unscaled Farkas certificates; returns
    (p_eq, p_neg, p_sup, d_eq, d_cone, d_obj), each (B,).  Valid
    certificates have eq ~ 0, neg/cone ~ 0 and a clearly negative
    sup/obj."""
    adata = ops.abs_data(data)
    c_inv = _col(1.0 / sc.c)
    ud_x = sc.d_x * c_inv

    # ---- primal certificate: drift of (y, z_l, z_u, z_bl, z_bu)
    dy = vars.y - prox.y
    dz_l = torch.where(data.hl_mask, vars.z_l - prox.z_l, 0.0)
    dz_u = torch.where(data.hu_mask, vars.z_u - prox.z_u, 0.0)
    dz_bl = torch.where(data.xl_mask, vars.z_bl - prox.z_bl, 0.0)
    dz_bu = torch.where(data.xu_mask, vars.z_bu - prox.z_bu, 0.0)

    norms = torch.stack([
        _inf_norm(dy * sc.d_y * c_inv),
        _inf_norm(dz_l * sc.d_z * c_inv), _inf_norm(dz_u * sc.d_z * c_inv),
        _inf_norm(torch.where(data.xl_mask, dz_bl * sc.d_b * c_inv, 0.0)),
        _inf_norm(torch.where(data.xu_mask, dz_bu * sc.d_b * c_inv, 0.0)),
    ], dim=-1)
    p_norm = norms.amax(dim=-1)
    negs = torch.stack([
        -min0(dz_l * sc.d_z * c_inv),
        -min0(dz_u * sc.d_z * c_inv),
        -min0(torch.where(data.xl_mask, dz_bl * sc.d_b * c_inv, 0.0)),
        -min0(torch.where(data.xu_mask, dz_bu * sc.d_b * c_inv, 0.0)),
    ], dim=-1)
    p_neg = negs.amax(dim=-1) / torch.clamp(p_norm, min=_TINY)

    xb = data.x_b_scaling
    t = ops.AT_y(data, dy) if data.p > 0 else torch.zeros_like(vars.x)
    den = ops.AT_y(adata, dy.abs()) if data.p > 0 else torch.zeros_like(vars.x)
    if data.m > 0:
        t = t + ops.GT_z(data, dz_u - dz_l)
        den = den + ops.GT_z(adata, dz_u.abs() + dz_l.abs())
    t = t - torch.where(data.xl_mask, xb * dz_bl, 0.0)
    t = t + torch.where(data.xu_mask, xb * dz_bu, 0.0)
    den = den + torch.where(data.xl_mask, xb * dz_bl.abs(), 0.0)
    den = den + torch.where(data.xu_mask, xb * dz_bu.abs(), 0.0)
    p_eq = _inf_norm(t * ud_x) / torch.clamp(max0(den * ud_x), min=_TINY)

    sup = _dot(data.x_u, dz_bu) - _dot(data.x_l, dz_bl)
    sup_den = _dot(data.x_u.abs(), dz_bu.abs()) + _dot(data.x_l.abs(), dz_bl.abs())
    if data.p > 0:
        sup = sup + _dot(data.b, dy)
        sup_den = sup_den + _dot(data.b.abs(), dy.abs())
    if data.m > 0:
        sup = sup + _dot(data.h_u, dz_u) - _dot(data.h_l, dz_l)
        sup_den = sup_den + _dot(data.h_u.abs(), dz_u.abs())
        sup_den = sup_den + _dot(data.h_l.abs(), dz_l.abs())
    p_sup = sup / torch.clamp(sup_den, min=_TINY)
    # an empty ray is not a certificate
    p_eq = torch.where(p_norm > 0, p_eq, torch.inf)

    # ---- dual certificate: drift of x
    dx = vars.x - prox.x
    d_norm = _inf_norm(dx * sc.d_x)
    t1 = ops.P_x(data, dx) * ud_x
    den1 = ops.P_x(adata, dx.abs()) * ud_x
    d_eq_t = _inf_norm(t1)
    d_eq_den = max0(den1)
    if data.p > 0:
        t2 = ops.A_x(data, dx) / sc.d_y
        den2 = ops.A_x(adata, dx.abs()) / sc.d_y
        d_eq_t = torch.maximum(d_eq_t, _inf_norm(t2))
        d_eq_den = torch.maximum(d_eq_den, max0(den2))
    d_eq = d_eq_t / torch.clamp(d_eq_den, min=_TINY)
    d_eq = torch.where(d_norm > 0, d_eq, torch.inf)

    cone = torch.zeros_like(d_norm)
    if data.m > 0:
        gdx = ops.G_x(data, dx) / sc.d_z
        gden = torch.clamp(ops.G_x(adata, dx.abs()) / sc.d_z, min=_TINY)
        cone = torch.maximum(
            _masked_signed_max(gdx / gden, data.hu_mask),
            _masked_signed_max(-gdx / gden, data.hl_mask),
        )
    bdx = xb * dx / sc.d_b / _col(torch.clamp(d_norm, min=_TINY))
    cone = torch.maximum(cone, _masked_signed_max(bdx, data.xu_mask))
    d_cone = torch.maximum(cone, _masked_signed_max(-bdx, data.xl_mask))

    d_obj = _dot(data.c, dx) / torch.clamp(_dot(data.c.abs(), dx.abs()), min=_TINY)
    return p_eq, p_neg, p_sup, d_eq, d_cone, d_obj


def _violation_certificate(data, sc, vars: Vars):
    """Unscaled Farkas ray candidate from the constraint violations of the
    final iterate, plus its (eq_rel, sup_rel) quality and norm."""
    adata = ops.abs_data(data)
    x = vars.x

    dy = (ops.A_x(data, x) - data.b) / sc.d_y if data.p > 0 else torch.zeros_like(vars.y)
    if data.m > 0:
        gx = ops.G_x(data, x) / sc.d_z
        dz_u = torch.where(data.hu_mask, torch.clamp(gx - data.h_u / sc.d_z, min=0.0), 0.0)
        dz_l = torch.where(data.hl_mask, torch.clamp(data.h_l / sc.d_z - gx, min=0.0), 0.0)
    else:
        dz_u = dz_l = torch.zeros_like(vars.z_l)
    bx = data.x_b_scaling * x / sc.d_b
    dz_bu = torch.where(data.xu_mask, torch.clamp(bx - data.x_u / sc.d_b, min=0.0), 0.0)
    dz_bl = torch.where(data.xl_mask, torch.clamp(data.x_l / sc.d_b - bx, min=0.0), 0.0)

    # unscaled-matvec identities: A_s = D_y A D_x  =>  A' w = [A_s' (w/d_y)] / d_x
    if data.p > 0:
        t = ops.AT_y(data, dy / sc.d_y) / sc.d_x
        den = ops.AT_y(adata, dy.abs() / sc.d_y) / sc.d_x
    else:
        t = torch.zeros_like(x)
        den = torch.zeros_like(x)
    if data.m > 0:
        t = t + ops.GT_z(data, (dz_u - dz_l) / sc.d_z) / sc.d_x
        den = den + ops.GT_z(adata, (dz_u + dz_l) / sc.d_z) / sc.d_x
    t = t + dz_bu - dz_bl
    den = den + dz_bu + dz_bl
    eq_rel = _inf_norm(t) / torch.clamp(max0(den), min=_TINY)

    b_u = data.b / sc.d_y if data.p > 0 else vars.y
    hu_u = data.h_u / sc.d_z
    hl_u = data.h_l / sc.d_z
    xu_u = data.x_u / sc.d_b
    xl_u = data.x_l / sc.d_b
    sup = (_dot(b_u, dy) + _dot(hu_u, dz_u) - _dot(hl_u, dz_l)
           + _dot(xu_u, dz_bu) - _dot(xl_u, dz_bl))
    sup_den = (
        _dot(b_u.abs(), dy.abs()) + _dot(hu_u.abs(), dz_u)
        + _dot(hl_u.abs(), dz_l) + _dot(xu_u.abs(), dz_bu)
        + _dot(xl_u.abs(), dz_bl)
    )
    sup_rel = sup / torch.clamp(sup_den, min=_TINY)

    norm = torch.stack([
        _inf_norm(dy), _inf_norm(dz_l), _inf_norm(dz_u),
        _inf_norm(dz_bl), _inf_norm(dz_bu),
    ], dim=-1).amax(dim=-1)
    eq_rel = torch.where(norm > 0, eq_rel, torch.inf)
    return (dy, dz_l, dz_u, dz_bl, dz_bu), eq_rel, sup_rel, norm


def _posthoc_certificates(data, sc, state: IPMState, result: Result) -> Result:
    """Post-hoc certificate search for the problems that hit max_iter
    (drift-primal, then drift-dual, then the violation ray): an infeasible
    problem can freeze at a proximal equilibrium where the stall counters
    never trip; certify it from a *validated* ray instead."""
    at_max = result.info.status == int(Status.MAX_ITER_REACHED)
    if not bool(at_max.any()):
        return result
    vars, prox = state.vars, state.prox
    p_eq, p_neg, p_sup, d_eq, d_cone, d_obj = _certificate_qualities(
        data, sc, vars, prox
    )
    drift_p = (p_eq <= CERT_EQ_TOL) & (p_neg <= CERT_NEG_TOL) & (p_sup <= -CERT_SUP_TOL)
    drift_d = (d_eq <= CERT_EQ_TOL) & (d_cone <= CERT_NEG_TOL) & (d_obj <= -CERT_SUP_TOL)
    vray, v_eq, v_sup, v_norm = _violation_certificate(data, sc, vars)
    viol_p = (v_eq <= CERT_EQ_TOL) & (v_sup <= -CERT_SUP_TOL)

    cert_p_drift = drift_p
    cert_d = ~drift_p & drift_d
    cert_p_viol = ~drift_p & ~drift_d & viol_p

    status = torch.where(
        cert_p_drift | cert_p_viol,
        int(Status.PRIMAL_INFEASIBLE),
        torch.where(cert_d, int(Status.DUAL_INFEASIBLE), result.info.status),
    ).to(torch.int32)

    # return the validated ray (unscaled, unit inf-norm) as the certificate
    c_inv = _col(1.0 / sc.c)
    dray = (
        (vars.y - prox.y) * sc.d_y * c_inv,
        torch.where(data.hl_mask, (vars.z_l - prox.z_l) * sc.d_z * c_inv, 0.0),
        torch.where(data.hu_mask, (vars.z_u - prox.z_u) * sc.d_z * c_inv, 0.0),
        torch.where(data.xl_mask, (vars.z_bl - prox.z_bl) * sc.d_b * c_inv, 0.0),
        torch.where(data.xu_mask, (vars.z_bu - prox.z_bu) * sc.d_b * c_inv, 0.0),
    )
    d_norm = torch.clamp(
        torch.stack([_inf_norm(r) for r in dray], dim=-1).amax(dim=-1), min=_TINY
    )
    v_nrm = torch.clamp(v_norm, min=_TINY)

    def pick(drift_c, viol_c, old):
        return torch.where(
            _col(cert_p_drift), drift_c / _col(d_norm),
            torch.where(_col(cert_p_viol), viol_c / _col(v_nrm), old),
        )

    searched = dataclasses.replace(
        result,
        y=pick(dray[0], vray[0], result.y),
        z_l=pick(dray[1], vray[1], result.z_l),
        z_u=pick(dray[2], vray[2], result.z_u),
        z_bl=pick(dray[3], vray[3], result.z_bl),
        z_bu=pick(dray[4], vray[4], result.z_bu),
        info=dataclasses.replace(result.info, status=status),
    )
    return select(at_max, searched, result)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _bound_count(data: QPData) -> torch.Tensor:
    return (
        data.hl_mask.sum(-1) + data.hu_mask.sum(-1)
        + data.xl_mask.sum(-1) + data.xu_mask.sum(-1)
    ).to(data.c.dtype)


def calculate_mu(data: QPData, v: Vars) -> torch.Tensor:
    """Complementarity measure (solver.hpp:884-891), per problem."""
    total = (_dot(v.s_l, v.z_l) + _dot(v.s_u, v.z_u)
             + _dot(v.s_bl, v.z_bl) + _dot(v.s_bu, v.z_bu))
    return total / _bound_count(data)


def calculate_step(v: Vars, step: Vars, data: QPData):
    """Fraction-to-the-boundary min-ratio test (solver.hpp:893-958), per
    problem."""

    def ratio(val, stp, mask):
        neg = mask & (stp < 0)
        r = torch.where(neg, -val / torch.where(neg, stp, -1.0), 1.0)
        if r.shape[-1] == 0:
            return r.new_ones(r.shape[:-1])
        return torch.clamp(r.amin(dim=-1), max=1.0)

    m_mask = torch.cat([data.hl_mask, data.hu_mask], -1)
    n_mask = torch.cat([data.xl_mask, data.xu_mask], -1)
    cat = lambda a, b: torch.cat([a, b], -1)  # noqa: E731
    alpha_s = torch.minimum(
        ratio(cat(v.s_l, v.s_u), cat(step.s_l, step.s_u), m_mask),
        ratio(cat(v.s_bl, v.s_bu), cat(step.s_bl, step.s_bu), n_mask),
    )
    alpha_z = torch.minimum(
        ratio(cat(v.z_l, v.z_u), cat(step.z_l, step.z_u), m_mask),
        ratio(cat(v.z_bl, v.z_bu), cat(step.z_bl, step.z_bu), n_mask),
    )
    return alpha_s, alpha_z


def _factor_attempt(data, settings: Settings, P_diag, vars: Vars, rho, delta, ir,
                    mixed: bool, pre):
    """One factorization attempt: the KKT scalings and ``kkt.factor``;
    returns (ks, ok)."""
    ks = kkt.compute_scalings(data, settings, vars, rho, delta, ir, P_diag)
    return kkt.factor(data, ks, mixed, pre, settings.factor_inverse)


@dataclasses.dataclass
class _Ladder:
    """Where each problem stands on the numerics-recovery ladder."""

    rho: torch.Tensor
    delta: torch.Tensor
    retries: torch.Tensor
    reg_limit: torch.Tensor
    ir: torch.Tensor
    ok: torch.Tensor  # the current factor is finite
    failed: torch.Tensor  # the ladder is exhausted


def _ladder(info: Info, use_ir, ok) -> _Ladder:
    """The ladder after the first attempt (at ``info``'s rho and delta)."""
    return _Ladder(info.rho, info.delta, info.factor_retires, info.reg_limit, use_ir, ok,
                   torch.zeros_like(ok))


def _ladder_run(lad: _Ladder, active) -> torch.Tensor:
    """The (active) problems whose factor still needs a rung."""
    run = ~lad.ok & ~lad.failed
    if active is not None:
        run = run & active
    return run


def _ladder_climb(data, settings: Settings, P_diag, vars: Vars, mixed: bool, pre, ks,
                  lad: _Ladder, run) -> tuple:
    """One rung for the ``run`` problems: iterative refinement first, then
    rho/delta x100 while retries remain, else failure; a refactorization
    when some problem can still boost.  Returns (ks, ladder)."""
    can_boost = lad.retries < settings.max_factor_retires
    boost = run & lad.ir & can_boost
    failed = torch.where(run, lad.ir & ~can_boost, lad.failed)
    rho = torch.where(boost, lad.rho * 100.0, lad.rho)
    delta = torch.where(boost, lad.delta * 100.0, lad.delta)
    reg_limit = torch.where(
        boost, torch.clamp(10.0 * lad.reg_limit, max=settings.eps_abs), lad.reg_limit
    )
    retries = torch.where(boost, lad.retries + 1, lad.retries)
    ir = lad.ir | run
    ok = lad.ok
    refactor = run & ~failed
    if bool(refactor.any()):
        with annotate("piqp.kkt.factor"):
            ks2, ok2 = _factor_attempt(data, settings, P_diag, vars, rho, delta, ir, mixed, pre)
        ks, ok = select(refactor, (ks2, ok2), (ks, ok))
    return ks, _Ladder(rho, delta, retries, reg_limit, ir, ok, failed)


def _ladder_info(info: Info, lad: _Ladder) -> Info:
    return dataclasses.replace(
        info,
        rho=lad.rho,
        delta=lad.delta,
        # reference resets the retry counter after success (solver.hpp:466,709)
        factor_retires=torch.where(lad.failed, lad.retries, torch.zeros_like(lad.retries)),
        reg_limit=lad.reg_limit,
    )


def factor_ladder(
    data: QPData, settings: Settings, P_diag, vars: Vars, info: Info, use_ir,
    mixed: bool = False, pre=None, active=None,
):
    """Factor with the numerics-recovery ladder (solver.hpp:446-465,
    687-708): a problem whose factor failed first enables iterative
    refinement, then boosts rho/delta x100 up to max_factor_retires times,
    else gives up (-> NUMERICS).  Each problem climbs its own ladder; a
    refactorization runs only while some (active) problem needs one.
    Returns (ks, info, use_ir, failed)."""
    with annotate("piqp.kkt.factor"):
        ks, ok = _factor_attempt(
            data, settings, P_diag, vars, info.rho, info.delta, use_ir, mixed, pre
        )
    lad = _ladder(info, use_ir, ok)
    while True:
        run = _ladder_run(lad, active)
        if not bool(run.any()):
            break
        ks, lad = _ladder_climb(data, settings, P_diag, vars, mixed, pre, ks, lad, run)
    return ks, _ladder_info(info, lad), lad.ir, lad.failed


# ---------------------------------------------------------------------------
# init (solver.hpp:398-577)
# ---------------------------------------------------------------------------

def _warm_vars(data: QPData, sc: Scaling, warm: BasicVars) -> Vars:
    """Scale a user-space warm-start point (x, y, z_*) into the equilibrated
    IPM space (inverse of ``_finalize``) and derive the primal slacks from
    the constraint values; negative duals are clipped to the cone."""
    c = _col(sc.c)
    x = warm.x / sc.d_x
    y = warm.y * c / sc.d_y

    def cone_dual(z, d, mask):
        return torch.where(mask, torch.clamp(z * c / d, min=0.0), 0.0)

    z_l = cone_dual(warm.z_l, sc.d_z, data.hl_mask)
    z_u = cone_dual(warm.z_u, sc.d_z, data.hu_mask)
    z_bl = cone_dual(warm.z_bl, sc.d_b, data.xl_mask)
    z_bu = cone_dual(warm.z_bu, sc.d_b, data.xu_mask)

    Gx = ops.G_x(data, x) if data.m > 0 else torch.zeros_like(z_l)
    bx = data.x_b_scaling * x
    return Vars(
        x=x, y=y, z_l=z_l, z_u=z_u, z_bl=z_bl, z_bu=z_bu,
        s_l=torch.where(data.hl_mask, Gx - data.h_l, 0.0),
        s_u=torch.where(data.hu_mask, data.h_u - Gx, 0.0),
        s_bl=torch.where(data.xl_mask, bx - data.x_l, 0.0),
        s_bu=torch.where(data.xu_mask, data.x_u - bx, 0.0),
    )


def _init_state(
    data: QPData, sc: Scaling, settings: Settings, has_cone: bool,
    P_diag, mixed: bool = False, pre=None, warm: BasicVars | None = None,
) -> tuple[IPMState, torch.Tensor]:
    dtype, device = data.c.dtype, data.c.device
    B, n, m = data.B, data.n, data.m

    info = init_info(settings, B, dtype, device)

    def ones(mask):
        return mask.to(dtype)

    vars0 = Vars(
        x=torch.zeros((B, n), dtype=dtype, device=device),
        y=torch.zeros((B, data.p), dtype=dtype, device=device),
        z_l=ones(data.hl_mask), z_u=ones(data.hu_mask),
        z_bl=ones(data.xl_mask), z_bu=ones(data.xu_mask),
        s_l=ones(data.hl_mask), s_u=ones(data.hu_mask),
        s_bl=ones(data.xl_mask), s_bu=ones(data.xu_mask),
    )
    if warm is not None:
        vars0 = _warm_vars(data, sc, warm)
        if has_cone:
            # warm interior push before the factorization: the elementwise
            # sqrt(warm_start_mu) floor keeps the warm slacks and duals
            eps_ws = torch.sqrt(torch.tensor(settings.warm_start_mu, dtype=dtype)).item()

            def push(v, mask):
                return torch.where(mask, torch.clamp(v, min=eps_ws), 0.0)

            vars0 = dataclasses.replace(
                vars0,
                s_l=push(vars0.s_l, data.hl_mask),
                s_u=push(vars0.s_u, data.hu_mask),
                s_bl=push(vars0.s_bl, data.xl_mask),
                s_bu=push(vars0.s_bu, data.xu_mask),
                z_l=push(vars0.z_l, data.hl_mask),
                z_u=push(vars0.z_u, data.hu_mask),
                z_bl=push(vars0.z_bl, data.xl_mask),
                z_bu=push(vars0.z_bu, data.xu_mask),
            )

    use_ir = torch.full(
        (B,),
        bool(settings.iterative_refinement_always_enabled or settings.mixed_precision),
        device=device,
    )
    if warm is not None:
        # a warm start makes no init KKT solve, and the first iteration
        # refactors before its first solve: no init factorization
        failed = torch.zeros((B,), dtype=torch.bool, device=device)
        vars = vars0
        res = Vars(**{
            f.name: torch.zeros_like(getattr(vars0, f.name))
            for f in dataclasses.fields(Vars)
        })
    else:
        ks, info, use_ir, failed = factor_ladder(
            data, settings, P_diag, vars0, info, use_ir, mixed, pre
        )
        # first KKT solve from the raw problem vectors (solver.hpp:473-492)
        res = Vars(
            x=-data.c,
            y=data.b,
            z_l=torch.where(data.hl_mask, -data.h_l, 0.0),
            z_u=torch.where(data.hu_mask, data.h_u, 0.0),
            z_bl=torch.where(data.xl_mask, -data.x_l, 0.0),
            z_bu=torch.where(data.xu_mask, data.x_u, 0.0),
            s_l=torch.zeros((B, m), dtype=dtype, device=device),
            s_u=torch.zeros((B, m), dtype=dtype, device=device),
            s_bl=torch.zeros((B, n), dtype=dtype, device=device),
            s_bu=torch.zeros((B, n), dtype=dtype, device=device),
        )
        vars, _ = kkt.solve(data, settings, ks, res)

    if has_cone and warm is not None:
        info = dataclasses.replace(info, mu=calculate_mu(data, vars))
    elif has_cone:
        # shift slacks/duals strictly positive and mu-recenter
        # (solver.hpp:504-570)
        neg_mins = torch.stack([
            -min0(vars.s_l), -min0(vars.s_u),
            -min0(vars.s_bl), -min0(vars.s_bu),
        ], dim=-1)
        delta_s = _col(torch.clamp(neg_mins.amax(dim=-1), min=0.0))
        neg_mins_z = torch.stack([
            -min0(vars.z_l), -min0(vars.z_u),
            -min0(vars.z_bl), -min0(vars.z_bu),
        ], dim=-1)
        delta_z = _col(torch.clamp(neg_mins_z.amax(dim=-1), min=0.0))

        def shift(v, d, mask):
            return torch.where(mask, v + d, 0.0)

        vars = dataclasses.replace(
            vars,
            s_l=shift(vars.s_l, delta_s, data.hl_mask),
            s_u=shift(vars.s_u, delta_s, data.hu_mask),
            s_bl=shift(vars.s_bl, delta_s, data.xl_mask),
            s_bu=shift(vars.s_bu, delta_s, data.xu_mask),
            z_l=shift(vars.z_l, delta_z, data.hl_mask),
            z_u=shift(vars.z_u, delta_z, data.hu_mask),
            z_bl=shift(vars.z_bl, delta_z, data.xl_mask),
            z_bu=shift(vars.z_bu, delta_z, data.xu_mask),
        )

        mu = _col(torch.clamp(calculate_mu(data, vars), min=1e-10))

        def recenter(z, mask):
            c0 = z - delta_z
            z_new = 0.5 * (c0 + torch.sqrt(c0 * c0 + 4.0 * mu))
            return torch.where(mask, z_new, 0.0), torch.where(mask, z_new - c0, 0.0)

        z_l, s_l = recenter(vars.z_l, data.hl_mask)
        z_u, s_u = recenter(vars.z_u, data.hu_mask)
        z_bl, s_bl = recenter(vars.z_bl, data.xl_mask)
        z_bu, s_bu = recenter(vars.z_bu, data.xu_mask)
        vars = dataclasses.replace(
            vars, z_l=z_l, z_u=z_u, z_bl=z_bl, z_bu=z_bu,
            s_l=s_l, s_u=s_u, s_bl=s_bl, s_bu=s_bu,
        )
        info = dataclasses.replace(info, mu=calculate_mu(data, vars))

    prox = vars.basic()
    res_nr, info = residuals_nr(data, sc, vars, info)
    # iter == 0 bootstrap of prev residuals (solver.hpp:581-586)
    info = dataclasses.replace(
        info, prev_primal_res=info.primal_res, prev_dual_res=info.dual_res,
        status=torch.where(failed, int(Status.NUMERICS), info.status).to(torch.int32),
    )
    state = IPMState(
        vars=vars, prox=prox, res_nr=res_nr, res=res, info=info, use_ir=use_ir,
    )
    return state, failed


# ---------------------------------------------------------------------------
# one IPM iteration (solver.hpp:579-878)
# ---------------------------------------------------------------------------

def _check_termination(data, sc, settings, st: IPMState) -> IPMState:
    info = st.info
    converged = (
        (info.primal_res < settings.eps_abs) | (info.primal_res_rel < settings.eps_rel)
    ) & ((info.dual_res < settings.eps_abs) | (info.dual_res_rel < settings.eps_rel))
    if settings.check_duality_gap:
        converged = converged & (
            (info.duality_gap < settings.eps_duality_gap_abs)
            | (info.duality_gap_rel < settings.eps_duality_gap_rel)
        )

    res, info = residuals_r(data, sc, st.vars, st.prox, st.res_nr, st.res, info)

    primal_inf = (
        (info.no_dual_update > min(5, settings.reg_finetune_dual_update_threshold))
        & (info.primal_prox_inf > settings.infeasibility_threshold)
        & ((info.primal_res_reg < settings.eps_abs)
           | (info.primal_res_reg_rel < settings.eps_rel))
    )
    dual_inf = (
        (info.no_primal_update > min(5, settings.reg_finetune_primal_update_threshold))
        & (info.dual_prox_inf > settings.infeasibility_threshold)
        & ((info.dual_res_reg < settings.eps_abs)
           | (info.dual_res_reg_rel < settings.eps_rel))
    )
    status = torch.where(
        converged, int(Status.SOLVED),
        torch.where(
            primal_inf, int(Status.PRIMAL_INFEASIBLE),
            torch.where(dual_inf, int(Status.DUAL_INFEASIBLE), _RUNNING),
        ),
    ).to(torch.int32)
    return dataclasses.replace(st, res=res, info=dataclasses.replace(info, status=status))


def _iteration_open(data, settings, has_cone, st: IPMState) -> tuple[Vars, Info]:
    """An iteration's start: the iteration count, the boundary guard and
    the regularization fine-tuning; returns (vars, info)."""
    info = dataclasses.replace(st.info, iter=st.info.iter + 1)
    vars = st.vars
    eps = torch.finfo(data.c.dtype).eps

    # boundary guard (solver.hpp:634-666): per-entry shift for inequality
    # duals, whole-vector shift for box duals; the any()s are per problem
    if has_cone:
        shifted_l = data.hl_mask & (vars.z_l < eps)
        shifted_u = data.hu_mask & (vars.z_u < eps)
        z_l = torch.where(shifted_l, vars.z_l + eps, vars.z_l)
        z_u = torch.where(shifted_u, vars.z_u + eps, vars.z_u)
        bl_any = (data.xl_mask & (vars.z_bl < eps)).any(-1, keepdim=True)
        bu_any = (data.xu_mask & (vars.z_bu < eps)).any(-1, keepdim=True)
        z_bl = torch.where(bl_any & data.xl_mask, vars.z_bl + eps, vars.z_bl)
        z_bu = torch.where(bu_any & data.xu_mask, vars.z_bu + eps, vars.z_bu)
        any_shift = (
            shifted_l.any(-1) | shifted_u.any(-1) | bl_any[:, 0] | bu_any[:, 0]
        )
        vars = dataclasses.replace(vars, z_l=z_l, z_u=z_u, z_bl=z_bl, z_bu=z_bu)
        info = dataclasses.replace(
            info, mu=torch.where(any_shift, calculate_mu(data, vars), info.mu)
        )

    # regularization fine-tuning (solver.hpp:668-681)
    finetune_trigger = (
        (info.no_primal_update > settings.reg_finetune_primal_update_threshold)
        & (info.rho == info.reg_limit)
        & (info.reg_limit != settings.reg_finetune_lower_limit)
    ) | (
        (info.no_dual_update > settings.reg_finetune_dual_update_threshold)
        & (info.delta == info.reg_limit)
        & (info.reg_limit != settings.reg_finetune_lower_limit)
    )
    finetune = (
        finetune_trigger
        & (info.dual_prox_inf < settings.infeasibility_threshold)
        & (info.primal_prox_inf < settings.infeasibility_threshold)
    )
    info = dataclasses.replace(
        info,
        reg_limit=torch.where(finetune, settings.reg_finetune_lower_limit, info.reg_limit),
        no_primal_update=torch.where(finetune, 0, info.no_primal_update),
        no_dual_update=torch.where(finetune, 0, info.no_dual_update),
    )
    return vars, info


def _numerics(st: IPMState) -> IPMState:
    return dataclasses.replace(
        st, info=dataclasses.replace(
            st.info, status=torch.full_like(st.info.status, int(Status.NUMERICS))
        ),
    )


def _predictor_rhs(vars: Vars, res: Vars) -> Vars:
    """The predictor's right-hand side (solver.hpp:722-737)."""
    return dataclasses.replace(
        res,
        s_l=-vars.s_l * vars.z_l,
        s_u=-vars.s_u * vars.z_u,
        s_bl=-vars.s_bl * vars.z_bl,
        s_bu=-vars.s_bu * vars.z_bu,
    )


def _corrector_rhs(data, settings, vars: Vars, res: Vars, step: Vars, mu) -> tuple:
    """The centering parameter from the predictor ``step`` and the
    corrector's right-hand side (solver.hpp:747-769); (sigma, res)."""
    alpha_s, alpha_z = calculate_step(vars, step, data)
    a_s = _col(alpha_s * settings.tau)
    a_z = _col(alpha_z * settings.tau)

    # centering parameter sigma (solver.hpp:747-753)
    sigma = _dot(vars.s_l + a_s * step.s_l, vars.z_l + a_z * step.z_l)
    sigma = sigma + _dot(vars.s_u + a_s * step.s_u, vars.z_u + a_z * step.z_u)
    sigma = sigma + _dot(vars.s_bl + a_s * step.s_bl, vars.z_bl + a_z * step.z_bl)
    sigma = sigma + _dot(vars.s_bu + a_s * step.s_bu, vars.z_bu + a_z * step.z_bu)
    sigma = sigma / (mu * _bound_count(data))
    sigma = torch.clamp(sigma, 0.0, 1.0) ** 3

    # ---- corrector (solver.hpp:755-769)
    sm = _col(sigma * mu)
    res = dataclasses.replace(
        res,
        s_l=res.s_l + torch.where(data.hl_mask, -step.s_l * step.z_l + sm, 0.0),
        s_u=res.s_u + torch.where(data.hu_mask, -step.s_u * step.z_u + sm, 0.0),
        s_bl=res.s_bl + torch.where(data.xl_mask, -step.s_bl * step.z_bl + sm, 0.0),
        s_bu=res.s_bu + torch.where(data.xu_mask, -step.s_bu * step.z_bu + sm, 0.0),
    )
    return sigma, res


# Gondzio's multiple centrality correctors (opt-in; no reference analog)
_DA, _BMIN, _BMAX, _GAMMA = 0.1, 0.1, 10.0, 0.01


def _gondzio_rhs(data, vars: Vars, res: Vars, step: Vars, alpha_s, alpha_z, sigma,
                 mu) -> Vars:
    """A corrector round's trial right-hand side, aimed at a step
    ``_DA`` longer."""
    mu_g = _col(sigma * mu)
    a_s_t = _col(torch.clamp(alpha_s + _DA, max=1.0))
    a_z_t = _col(torch.clamp(alpha_z + _DA, max=1.0))

    def corr(s, z, ds, dz, mask):
        v = (s + a_s_t * ds) * (z + a_z_t * dz)
        t = torch.minimum(torch.maximum(v, _BMIN * mu_g), _BMAX * mu_g)
        return torch.where(mask, t - v, 0.0)

    return dataclasses.replace(
        res,
        s_l=res.s_l + corr(vars.s_l, vars.z_l, step.s_l, step.z_l, data.hl_mask),
        s_u=res.s_u + corr(vars.s_u, vars.z_u, step.s_u, step.z_u, data.hu_mask),
        s_bl=res.s_bl + corr(vars.s_bl, vars.z_bl, step.s_bl, step.z_bl,
                             data.xl_mask),
        s_bu=res.s_bu + corr(vars.s_bu, vars.z_bu, step.s_bu, step.z_bu,
                             data.xu_mask),
    )


def _gondzio_accept(data, vars: Vars, step, res, alpha_s, alpha_z, step_t, res_t):
    """Keep a round's trial step only where it lengthens the step; returns
    (step, res, alpha_s, alpha_z)."""
    a_s2, a_z2 = calculate_step(vars, step_t, data)
    accept = (
        (a_s2 >= alpha_s) & (a_z2 >= alpha_z)
        & (a_s2 + a_z2 > alpha_s + alpha_z + _GAMMA * _DA)
    )
    return select(accept, (step_t, res_t, a_s2, a_z2), (step, res, alpha_s, alpha_z))


def _centering_update(
    data, sc, settings, st: IPMState, res: Vars, step: Vars, alpha_s, alpha_z, sigma,
    mat32=None,
) -> IPMState:
    """The step, mu, the residuals and the proximal parameter updates
    (solver.hpp:778-829); ``res`` is the corrector's right-hand side."""
    vars, info = st.vars, st.info
    primal_step = alpha_s * settings.tau
    dual_step = alpha_z * settings.tau
    ps, ds = _col(primal_step), _col(dual_step)

    # ---- update (solver.hpp:778-792)
    vars = Vars(
        x=vars.x + ps * step.x,
        y=vars.y + ds * step.y,
        z_l=vars.z_l + ds * step.z_l,
        z_u=vars.z_u + ds * step.z_u,
        z_bl=vars.z_bl + ds * step.z_bl,
        z_bu=vars.z_bu + ds * step.z_bu,
        s_l=vars.s_l + ps * step.s_l,
        s_u=vars.s_u + ps * step.s_u,
        s_bl=vars.s_bl + ps * step.s_bl,
        s_bu=vars.s_bu + ps * step.s_bu,
    )

    mu_prev = info.mu
    mu = calculate_mu(data, vars)
    mu_rate = torch.clamp((mu_prev - mu) / mu_prev, min=0.0)
    info = dataclasses.replace(
        info, mu=mu, sigma=sigma, primal_step=primal_step, dual_step=dual_step
    )

    res_nr, info = residuals_nr(data, sc, vars, info, mat32)

    # ---- proximal parameter updates (solver.hpp:794-829)
    prox = st.prox
    dual_progress = (info.dual_res < 0.95 * info.prev_dual_res) | (
        (info.dual_res < settings.eps_abs) | (info.dual_res_rel < settings.eps_rel)
    ) | (
        (info.rho == settings.reg_finetune_lower_limit)
        & (info.dual_prox_inf < settings.infeasibility_threshold)
    )
    new_prox_x = torch.where(_col(dual_progress), vars.x, prox.x)
    rho_fast = torch.maximum(info.reg_limit, (1.0 - mu_rate) * info.rho)
    rho_slow_ok = (info.iter < 5) | (info.dual_prox_inf < settings.infeasibility_threshold)
    rho_slow = torch.where(
        rho_slow_ok,
        torch.maximum(info.reg_limit, (1.0 - 0.666 * mu_rate) * info.rho),
        info.rho,
    )
    info = dataclasses.replace(
        info,
        rho=torch.where(dual_progress, rho_fast, rho_slow),
        no_primal_update=torch.where(
            dual_progress, info.no_primal_update, info.no_primal_update + 1
        ),
    )

    primal_progress = (info.primal_res < 0.95 * info.prev_primal_res) | (
        (info.primal_res < settings.eps_abs) | (info.primal_res_rel < settings.eps_rel)
    ) | (
        (info.delta == settings.reg_finetune_lower_limit)
        & (info.primal_prox_inf < settings.infeasibility_threshold)
    )
    pp = _col(primal_progress)
    prox = BasicVars(
        x=new_prox_x,
        y=torch.where(pp, vars.y, prox.y),
        z_l=torch.where(pp, vars.z_l, prox.z_l),
        z_u=torch.where(pp, vars.z_u, prox.z_u),
        z_bl=torch.where(pp, vars.z_bl, prox.z_bl),
        z_bu=torch.where(pp, vars.z_bu, prox.z_bu),
    )
    delta_fast = torch.maximum(info.reg_limit, (1.0 - mu_rate) * info.delta)
    delta_slow_ok = (info.iter < 5) | (info.primal_prox_inf < settings.infeasibility_threshold)
    delta_slow = torch.where(
        delta_slow_ok,
        torch.maximum(info.reg_limit, (1.0 - 0.666 * mu_rate) * info.delta),
        info.delta,
    )
    info = dataclasses.replace(
        info,
        delta=torch.where(primal_progress, delta_fast, delta_slow),
        no_dual_update=torch.where(
            primal_progress, info.no_dual_update, info.no_dual_update + 1
        ),
    )
    return dataclasses.replace(st, vars=vars, prox=prox, res_nr=res_nr, res=res, info=info)


def _equality_update(data, sc, settings, st: IPMState, step: Vars, mat32=None) -> IPMState:
    """The full step, the residuals and the proximal parameter updates of
    the equality-only path."""
    vars, res, info = st.vars, st.res, st.info
    vars = dataclasses.replace(vars, x=vars.x + step.x, y=vars.y + step.y)
    info = dataclasses.replace(
        info,
        primal_step=torch.ones_like(info.primal_step),
        dual_step=torch.ones_like(info.dual_step),
    )

    res_nr, info = residuals_nr(data, sc, vars, info, mat32)

    prox = st.prox
    dual_progress = (info.dual_res < 0.95 * info.prev_dual_res) | (
        (info.dual_res < settings.eps_abs) | (info.dual_res_rel < settings.eps_rel)
    )
    rho_slow_ok = (info.iter < 5) | (info.dual_prox_inf < settings.infeasibility_threshold)
    info = dataclasses.replace(
        info,
        rho=torch.where(
            dual_progress,
            torch.maximum(info.reg_limit, 0.1 * info.rho),
            torch.where(
                rho_slow_ok, torch.maximum(info.reg_limit, 0.5 * info.rho), info.rho
            ),
        ),
        no_primal_update=torch.where(
            dual_progress, info.no_primal_update, info.no_primal_update + 1
        ),
    )
    prox = dataclasses.replace(prox, x=torch.where(_col(dual_progress), vars.x, prox.x))

    primal_progress = (info.primal_res < 0.95 * info.prev_primal_res) | (
        (info.primal_res < settings.eps_abs) | (info.primal_res_rel < settings.eps_rel)
    )
    delta_slow_ok = (info.iter < 5) | (info.primal_prox_inf < settings.infeasibility_threshold)
    info = dataclasses.replace(
        info,
        delta=torch.where(
            primal_progress,
            torch.maximum(info.reg_limit, 0.1 * info.delta),
            torch.where(
                delta_slow_ok, torch.maximum(info.reg_limit, 0.5 * info.delta),
                info.delta,
            ),
        ),
        no_dual_update=torch.where(
            primal_progress, info.no_dual_update, info.no_dual_update + 1
        ),
    )
    prox = dataclasses.replace(prox, y=torch.where(_col(primal_progress), vars.y, prox.y))
    return dataclasses.replace(st, vars=vars, prox=prox, res_nr=res_nr, res=res, info=info)


# ---------------------------------------------------------------------------
# the IPM loop
# ---------------------------------------------------------------------------

def _validate_exit(data, sc, settings, st: IPMState) -> IPMState:
    """Gate an infeasibility exit on the Farkas certificate itself: a
    rejected certificate relaxes the regularization floor, resets the
    stall counters, tightens the corresponding proximal penalty and sets
    the status back to RUNNING so the IPM resumes."""
    info = st.info
    is_p = info.status == int(Status.PRIMAL_INFEASIBLE)
    is_d = info.status == int(Status.DUAL_INFEASIBLE)
    candidate = is_p | is_d
    if not bool(candidate.any()):
        return st
    p_eq, p_neg, p_sup, d_eq, d_cone, d_obj = _certificate_qualities(
        data, sc, st.vars, st.prox
    )
    p_valid = (p_eq <= CERT_EQ_TOL) & (p_neg <= CERT_NEG_TOL) & (p_sup <= -CERT_SUP_TOL)
    d_valid = (d_eq <= CERT_EQ_TOL) & (d_cone <= CERT_NEG_TOL) & (d_obj <= -CERT_SUP_TOL)
    p_reject = is_p & ~p_valid
    d_reject = is_d & ~d_valid
    reject = p_reject | d_reject
    reg_limit = torch.where(reject, settings.reg_finetune_lower_limit, info.reg_limit)
    info = dataclasses.replace(
        info,
        status=torch.where(reject, _RUNNING, info.status).to(torch.int32),
        reg_limit=reg_limit,
        no_primal_update=torch.where(reject, 0, info.no_primal_update),
        no_dual_update=torch.where(reject, 0, info.no_dual_update),
        delta=torch.where(p_reject, torch.maximum(reg_limit, 0.1 * info.delta), info.delta),
        rho=torch.where(d_reject, torch.maximum(reg_limit, 0.1 * info.rho), info.rho),
    )
    return dataclasses.replace(st, info=info)


def _print_iterations(st: IPMState, active: torch.Tensor) -> None:
    """Per-iteration table row (solver.hpp:588-604) of each active problem."""
    i = st.info
    for b in torch.nonzero(active).flatten().tolist():
        print(
            f"{int(i.iter[b]):3d}   {float(i.primal_obj[b]): .5e}   "
            f"{float(i.dual_obj[b]): .5e}   {float(i.duality_gap[b]):.5e}   "
            f"{float(i.primal_res[b]):.5e}   {float(i.dual_res[b]):.5e}   "
            f"{float(i.rho[b]):.3e}   {float(i.delta[b]):.3e}   {float(i.mu[b]):.3e}   "
            f"{float(i.primal_step[b]):.4f}   {float(i.dual_step[b]):.4f}"
        )


def _cond(settings: Settings, st: IPMState) -> torch.Tensor:
    return (st.info.status == _RUNNING) & (st.info.iter < settings.max_iter)


def _in_phase_a(settings: Settings, st: IPMState) -> torch.Tensor:
    in_a = st.info.mu > settings.mixed_precision_mu_switch
    if settings.mixed_phase_a_patience > 0:
        # stall exit (Settings.mixed_phase_a_patience): a plateaued
        # problem gains nothing from more float32 iterations
        stalled = torch.maximum(
            st.info.no_primal_update, st.info.no_dual_update
        ) >= settings.mixed_phase_a_patience
        backstop = st.info.iter >= settings.max_iter // 2
        in_a = in_a & ~(stalled | backstop)
    return in_a


def _running(settings: Settings, st: IPMState, active, phase_a: bool) -> torch.Tensor:
    """The problems of ``active`` whose loop goes on in this phase."""
    act = active & _cond(settings, st)
    return act & _in_phase_a(settings, st) if phase_a else act


def solve_scaled(
    data: QPData, sc: Scaling, settings: Settings, has_cone: bool,
    warm: BasicVars | None = None,
) -> Result:
    """Run the IPM on already-equilibrated batched data; returns the
    *unscaled* result (solver.hpp:109-112).  ``warm``: optional user-space
    (unscaled) iterates (x, y, z_*) of a nearby problem, per problem.

    Where ``graphs.engages`` (condensed dense data on a CUDA device) and
    the device has room for the cache entry, the loop's segments run as
    CUDA graphs on persistent buffers, with the same decisions and
    arithmetic; elsewhere every kernel is launched from Python."""
    if graphs.engages(data, settings):
        key = graphs.key(data, settings, has_cone)
        with torch.cuda.device(data.c.device), graphs.CACHE.entry(
                key, graphs.room(data)) as entry:
            if entry is not None:
                return _solve_loop(data, sc, settings, has_cone, warm, entry.slots,
                                   entry.segments.run)
    return _solve_eager(data, sc, settings, has_cone, warm)


def _solve_eager(
    data: QPData, sc: Scaling, settings: Settings, has_cone: bool,
    warm: BasicVars | None = None,
) -> Result:
    """``solve_scaled``'s loop with every kernel launched from Python."""
    return _solve_loop(data, sc, settings, has_cone, warm, graphs.Names(), graphs.eager)


def _pick(mask, new, old):
    """``select`` that keeps a tensor both sides share as it is: the same
    values, one kernel fewer."""
    def pick(a, b):
        return a if a is b else select(mask, a, b)

    return tree_map(pick, new, old)


def _solve_loop(
    data: QPData, sc: Scaling, settings: Settings, has_cone: bool,
    warm: BasicVars | None, ws, run,
) -> Result:
    """The IPM loop, cut at its host decisions (each ``bool(... .any())``)
    and at its spans into straight-line segments (``graphs.py``).
    ``run(key, fn)`` runs a segment; a segment reads its inputs from the
    buffers ``ws`` and ends by putting its outputs there (``ws.put``), so
    whatever order the decisions run the segments in, none overwrites
    what an earlier one still needs.  Init and the result, and the rare
    branches (a ladder rung, a failed factor, the certificate checks),
    run outside the segments on the same buffers.

    A trip is the exit test, the factorization with its recovery ladder,
    then Mehrotra's predictor-corrector step (solver.hpp:720-829) with
    the opt-in Gondzio correctors, or the full step of the equality-only
    path (solver.hpp:831-877).  Mixed precision runs two phases: float32
    factors while the barrier is loose, solver-dtype factors for the
    endgame; a problem that left phase A waits until every active problem
    has left it."""
    mixed = settings.mixed_precision
    pre = kkt.precompute(data, mixed)
    P_diag = ops.P_diag(data)
    state, _ = _init_state(data, sc, settings, has_cone, P_diag, mixed, pre, warm)
    ws.put(data=data, sc=sc, pre=pre, P_diag=P_diag, st=state)

    def running(st, phase_a) -> dict:
        act = _running(settings, st, ws.outer, phase_a)
        return dict(act=act, act_any=act.any())

    def trip(phase_a):
        """One trip of the loop for the ``ws.act`` problems, and the exit
        test after it."""
        ks_slot = "ks32" if phase_a else "ks"

        def mat32():
            return ws.pre.get("data32") if (phase_a and ws.pre) else None

        def opening():
            new = _check_termination(ws.data, ws.sc, settings, ws.st)
            st = _pick(ws.act, new, ws.st)
            go = ws.act & (st.info.status == _RUNNING)
            ws.put(st=st, go=go, go_any=go.any())

        def iteration():
            vars, info = _iteration_open(ws.data, settings, has_cone, ws.st)
            ws.put(it_vars=vars, it_info=info)

        def put_ladder(ks, lad):
            go = _ladder_run(lad, ws.go)
            live = ws.go & ~lad.failed
            ws.put(**{ks_slot: ks}, lad=lad, run=go, run_any=go.any(), live=live,
                   live_any=live.any())

        def factor():
            info, use_ir = ws.it_info, ws.st.use_ir
            ks, ok = _factor_attempt(ws.data, settings, ws.P_diag, ws.it_vars, info.rho,
                                     info.delta, use_ir, phase_a, ws.pre)
            put_ladder(ks, _ladder(info, use_ir, ok))

        def laddered() -> IPMState:
            return dataclasses.replace(ws.st, vars=ws.it_vars, use_ir=ws.lad.ir,
                                       info=_ladder_info(ws.it_info, ws.lad))

        def residuals():
            st = laddered()
            res, info = residuals_r(ws.data, ws.sc, st.vars, st.prox, st.res_nr, st.res,
                                    st.info)
            rhs = dict(rhs=_predictor_rhs(st.vars, res)) if has_cone else {}
            ws.put(res=res, info_r=info, **rhs)

        def kkt_solve(rhs: str, out: str):
            """``kkt.solve`` of ``ws.<rhs>`` into ``ws.<out>``."""
            def read():
                mu = ws.info_r.mu if has_cone else None
                return ws.data, getattr(ws, ks_slot), getattr(ws, rhs), mu, mat32(), ws.live

            with annotate("piqp.kkt.solve"):
                kkt.solve_segments(settings, read, ws, run, (phase_a, rhs, out), out)

        def corrector():
            sigma, res = _corrector_rhs(ws.data, settings, ws.it_vars, ws.rhs, ws.step,
                                        ws.info_r.mu)
            ws.put(sigma=sigma, rhs=res)

        def alpha():
            ws.put(alpha=calculate_step(ws.it_vars, ws.step, ws.data))

        def gondzio():
            ws.put(rhs_t=_gondzio_rhs(ws.data, ws.it_vars, ws.rhs, ws.step, *ws.alpha,
                                      ws.sigma, ws.info_r.mu))

        def accept():
            step, res, a_s, a_z = _gondzio_accept(ws.data, ws.it_vars, ws.step, ws.rhs,
                                                  *ws.alpha, ws.step_t, ws.rhs_t)
            ws.put(step=step, rhs=res, alpha=(a_s, a_z))

        def update():
            st = dataclasses.replace(laddered(), res=ws.res, info=ws.info_r)
            if not has_cone:
                new = _equality_update(ws.data, ws.sc, settings, st, ws.step, mat32())
            else:
                a_s, a_z = (ws.alpha if settings.centrality_correctors
                            else calculate_step(ws.it_vars, ws.step, ws.data))
                new = _centering_update(ws.data, ws.sc, settings, st, ws.rhs, ws.step,
                                        a_s, a_z, ws.sigma, mat32())
            new = _pick(ws.go, _pick(ws.lad.failed, _numerics(laddered()), new), ws.st)
            ws.put(st=new, **running(new, phase_a))

        def exit_test():
            run(("running", phase_a), lambda: ws.put(**running(ws.st, phase_a)))

        if settings.verbose:
            _print_iterations(ws.st, ws.act)
        run(("trip", phase_a), opening)
        if not bool(ws.go_any):
            exit_test()
            return
        run(("iteration", phase_a), iteration)
        # factorization with its recovery ladder (rungs eager)
        with annotate("piqp.kkt.factor"):
            run(("factor", phase_a), factor)
        while bool(ws.run_any):
            put_ladder(*_ladder_climb(ws.data, settings, ws.P_diag, ws.it_vars, phase_a,
                                      ws.pre, getattr(ws, ks_slot), ws.lad, ws.run))
        if not bool(ws.live_any):
            ws.put(st=select(ws.go, _numerics(laddered()), ws.st))
            exit_test()
            return
        run(("residuals", phase_a), residuals)
        if not has_cone:
            kkt_solve("res", "step")
        else:
            # predictor, corrector, then the Gondzio rounds, each kept only
            # where it lengthens the step
            kkt_solve("rhs", "step")
            run(("corrector", phase_a), corrector)
            kkt_solve("rhs", "step")
            if settings.centrality_correctors:
                run(("alpha", phase_a), alpha)
            for _ in range(settings.centrality_correctors):
                run(("gondzio", phase_a), gondzio)
                kkt_solve("rhs_t", "step_t")
                run(("accept", phase_a), accept)
        run(("update", phase_a), update)

    def loop(phase_a):
        run(("running", phase_a), lambda: ws.put(**running(ws.st, phase_a)))
        go = bool(ws.act_any)
        while go:
            # a trip: the step, then the exit test it leads to
            with annotate("piqp.ipm.iter"):
                trip(phase_a)
                go = bool(ws.act_any)

    def run_ipm(outer):
        ws.put(outer=outer)
        if mixed:
            loop(True)
        loop(False)

    if settings.verify_certificates:
        # outer loop: re-enter the IPM after a rejected certificate
        while True:
            outer = _cond(settings, ws.st)
            if not bool(outer.any()):
                break
            run_ipm(outer)
            ws.put(st=select(outer, _validate_exit(ws.data, ws.sc, settings, ws.st), ws.st))
    else:
        run_ipm(_cond(settings, ws.st))
    # the result holds no buffer of ``ws``: the next solve overwrites them
    state = dataclasses.replace(ws.st, info=tree_map(torch.clone, ws.st.info))
    return _result(data, sc, settings, state)


def _result(data, sc, settings: Settings, state: IPMState) -> Result:
    info = state.info
    info = dataclasses.replace(
        info,
        status=torch.where(
            info.status == _RUNNING, int(Status.MAX_ITER_REACHED), info.status
        ).to(torch.int32),
    )
    result = _finalize(data, sc, state.vars, info)
    if settings.verify_certificates:
        result = _posthoc_certificates(data, sc, state, result)
    return result


def _finalize(data: QPData, sc: Scaling, v: Vars, info: Info) -> Result:
    """Unscale and restore the user-facing solution (solver.hpp:1205-1259)."""
    c_inv = _col(1.0 / sc.c)
    x = v.x * sc.d_x
    y = v.y * sc.d_y * c_inv
    z_l = v.z_l * sc.d_z * c_inv
    z_u = v.z_u * sc.d_z * c_inv
    s_l = v.s_l / sc.d_z
    s_u = v.s_u / sc.d_z
    z_bl = torch.where(data.xl_mask, v.z_bl * sc.d_b * c_inv, 0.0)
    z_bu = torch.where(data.xu_mask, v.z_bu * sc.d_b * c_inv, 0.0)
    s_bl = torch.where(data.xl_mask, v.s_bl / sc.d_b, PIQP_INF)
    s_bu = torch.where(data.xu_mask, v.s_bu / sc.d_b, PIQP_INF)

    # restore_dual (solver.hpp:1229-1241): inactive constraints report
    # infinite slack
    s_l = torch.where(z_l == 0, PIQP_INF, s_l)
    s_u = torch.where(z_u == 0, PIQP_INF, s_u)
    return Result(
        x=x, y=y, z_l=z_l, z_u=z_u, z_bl=z_bl, z_bu=z_bu,
        s_l=s_l, s_u=s_u, s_bl=s_bl, s_bu=s_bu, info=info,
    )
