"""The plain reference: a batched primal-dual interior-point method in
plain PyTorch, and the host KKT check of a solution.

It solves

    min 0.5 x'Px + c'x   s.t.  Ax = b,  h_l <= Gx <= h_u,  x_l <= x <= x_u

from the dense arrays of ``problems.dense_form`` (infinite bounds as
+-inf), independently of the program: Mehrotra's predictor-corrector on
the inequality rows with finite bounds, each Newton system reduced to
H = P + G'WG + W_x (a Cholesky factor) and the Schur complement
A H^-1 A' on the equalities (a second one).  Every problem runs until its
residuals and complementarity reach the float64 targets below and then
stays still while the others go on.  In float32 the same iteration is the
benchmark's control (``--control``): it stops at its best iterate when the
targets are out of reach.

This module imports numpy and torch only, and nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

# stopping targets, relative to 1 + the data's size; float64 reaches them
# on every problem of the benchmark's configurations in 15-40 iterations
EPS_RES = 1e-10
EPS_MU = 1e-10
MAX_ITER = 80
# passes of iterative refinement of each Newton step
REFINE = 2
# fraction of the step to the boundary
TAU = 0.99
# the central-path neighbourhood a step keeps to, and the step's cuts
GAMMA = 1e-3
BACKTRACK = 0.8
STEPS = 16


def _tensors(dense: dict, device, dtype) -> dict:
    out = {k: torch.as_tensor(np.ascontiguousarray(v), device=device).to(dtype)
           for k, v in dense.items()}
    P = out["P"]
    # the program reads P's upper triangle; so does the reference
    out["P"] = torch.triu(P) + torch.triu(P, 1).mT
    return out


def solve(dense: dict, device="cpu", dtype=torch.float64, max_iter: int = MAX_ITER):
    """Solve every problem of ``dense`` (stacked arrays, leading batch
    axis).  Returns (x, y, z_l, z_u, z_bl, z_bu, converged, iterations) as
    float64 numpy arrays (z_* in the sign convention of the program's
    results: every one >= 0) and the per-problem flag and count."""
    d = _tensors(dense, device, dtype)
    P, c, A, b, G = d["P"], d["c"], d["A"], d["b"], d["G"]
    B, n = c.shape
    p = b.shape[1]
    # the four groups of inequality rows: C x - s = r, s >= 0
    #   gl: G x - s = h_l   gu: -G x - s = -h_u   xl: x - s = x_l   xu: -x - s = -x_u
    lo_g, hi_g, lo_x, hi_x = d["h_l"], d["h_u"], d["x_l"], d["x_u"]
    masks = [torch.isfinite(v) for v in (lo_g, hi_g, lo_x, hi_x)]
    # a row whose two bounds are equal is an equality: as two inequalities
    # it would leave the feasible set no interior.  It joins A (the rows
    # of G that are not such rows are zero there, with a unit diagonal in
    # the Schur complement, so that their multipliers stay 0)
    p0 = p
    eqrow = masks[0] & masks[1] & (lo_g == hi_g)
    masks[0], masks[1] = masks[0] & ~eqrow, masks[1] & ~eqrow
    A = torch.cat([A, G * eqrow[..., None]], dim=1)
    b = torch.cat([b, torch.where(eqrow, lo_g, 0.0)], dim=1)
    dummy = torch.cat([torch.zeros_like(d["b"]), (~eqrow).to(dtype)], dim=1)
    p = A.shape[1]
    rhs = [torch.where(masks[0], lo_g, 0.0), torch.where(masks[1], -hi_g, 0.0),
           torch.where(masks[2], lo_x, 0.0), torch.where(masks[3], -hi_x, 0.0)]
    fm = [mk.to(dtype) for mk in masks]
    rows = sum(f.sum(-1) for f in fm).clamp(min=1.0)

    def apply(x):
        Gx = torch.einsum("bmn,bn->bm", G, x)
        return [Gx, -Gx, x, -x]

    def apply_t(v):
        return torch.einsum("bmn,bm->bn", G, v[0] - v[1]) + v[2] - v[3]

    # start: the equality-constrained solve with unit weights, slacks
    # pushed to at least 1
    x = torch.zeros(B, n, device=device, dtype=dtype)
    y = torch.zeros(B, p, device=device, dtype=dtype)
    s = [torch.ones_like(r) for r in rhs]
    z = [torch.ones_like(r) for r in rhs]
    scale_p = 1.0 + torch.stack([b.abs().amax(-1) if p else torch.zeros(B, device=device, dtype=dtype)]
                                + [r.abs().amax(-1) if r.shape[1] else torch.zeros(B, device=device, dtype=dtype)
                                   for r in rhs]).amax(0)
    scale_d = 1.0 + c.abs().amax(-1)

    def residuals(x, y, s, z):
        Cx = apply(x)
        r_d = torch.einsum("bij,bj->bi", P, x) + c - torch.einsum("bpn,bp->bn", A, y) - apply_t(
            [zi * f for zi, f in zip(z, fm)])
        r_p = torch.einsum("bpn,bn->bp", A, x) - b
        r_i = [(cx - si - ri) * f for cx, si, ri, f in zip(Cx, s, rhs, fm)]
        mu = sum((si * zi * f).sum(-1) for si, zi, f in zip(s, z, fm)) / rows
        return r_d, r_p, r_i, mu

    def factor(s, z):
        w = [zi / si * f for zi, si, f in zip(z, s, fm)]
        H = P + (G * (w[0] + w[1])[..., None]).mT @ G
        H = H + torch.diag_embed(w[2] + w[3])
        LH, info_h = torch.linalg.cholesky_ex(H)
        HinvAt = torch.cholesky_solve(A.mT, LH)
        S = A @ HinvAt + torch.diag_embed(dummy)
        LS, info_s = torch.linalg.cholesky_ex(S)
        return LH, HinvAt, LS, (info_h == 0) & (info_s == 0)

    def newton(fac, r_d, r_p, r_i, r_c, s, z):
        """The Newton step, then REFINE passes of iterative refinement on
        the unreduced system: the reduction to H loses the digits that
        the weights z/s amplify near the solution."""
        dx, dy, ds, dz = reduced(fac, r_d, r_p, r_i, r_c, s, z)
        for _ in range(REFINE):
            e_d = (torch.einsum("bij,bj->bi", P, dx) - torch.einsum("bpn,bp->bn", A, dy)
                   - apply_t([dzi * f for dzi, f in zip(dz, fm)]) + r_d)
            e_p = torch.einsum("bpn,bn->bp", A, dx) + r_p
            e_i = [(cd - dsi + ri) * f for cd, dsi, ri, f in zip(apply(dx), ds, r_i, fm)]
            e_c = [(zi * dsi + si * dzi + rc) * f for zi, dsi, si, dzi, rc, f in zip(z, ds, s, dz, r_c, fm)]
            cx, cy, cs, cz = reduced(fac, e_d, e_p, e_i, e_c, s, z)
            dx, dy = dx + cx, dy + cy
            ds = [a + b for a, b in zip(ds, cs)]
            dz = [a + b for a, b in zip(dz, cz)]
        return dx, dy, ds, dz

    def reduced(fac, r_d, r_p, r_i, r_c, s, z):
        LH, HinvAt, LS, _ = fac
        t = [(rc + zi * ri) / si * f for rc, zi, ri, si, f in zip(r_c, z, r_i, s, fm)]
        rhs1 = -r_d - apply_t(t)
        h = torch.cholesky_solve(rhs1[..., None], LH)
        dy = torch.cholesky_solve((-r_p[..., None] - A @ h), LS)
        dx = (h + HinvAt @ dy)[..., 0]
        Cdx = apply(dx)
        ds = [(cd + ri) * f for cd, ri, f in zip(Cdx, r_i, fm)]
        dz = [-(rc + zi * dsi) / si * f for rc, zi, dsi, si, f in zip(r_c, z, ds, s, fm)]
        return dx, dy[..., 0], ds, dz

    def max_step(v, dv):
        ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, np.inf))
        return ratio.amin(-1) if v.shape[-1] else torch.full(v.shape[:-1], np.inf, device=device,
                                                             dtype=dtype)

    def step_to_boundary(s, z, ds, dz):
        a = torch.stack([max_step(si, dsi) for si, dsi in zip(s + z, ds + dz)]).amin(0)
        return a

    def central_step(s, z, ds, dz, a_max):
        """The longest of the steps a_max * BACKTRACK^k that keeps every
        product s_i z_i at least GAMMA times their mean (the wide
        neighbourhood of the central path): no slack collapses while the
        others are far from their bounds."""
        k = torch.arange(STEPS, device=device, dtype=dtype)
        a = a_max[:, None] * BACKTRACK ** k  # (B, STEPS)
        prods = torch.cat([((si[:, None, :] + a[..., None] * dsi[:, None, :])
                            * (zi[:, None, :] + a[..., None] * dzi[:, None, :]))
                           .masked_fill(f[:, None, :] == 0, np.inf)
                           for si, zi, dsi, dzi, f in zip(s, z, ds, dz, fm)], dim=-1)
        finite = torch.isfinite(prods)
        mean = torch.where(finite, prods, 0.0).sum(-1) / rows[:, None]
        fine = (prods.amin(-1) >= GAMMA * mean) | ~finite.any(-1)
        first = torch.where(fine.any(-1), fine.to(torch.int64).argmax(-1), STEPS - 1)
        return a.gather(1, first[:, None])[:, 0]

    def merit(r_d, r_p, r_i):
        pres = torch.stack([r_p.abs().amax(-1) if p else torch.zeros(B, device=device, dtype=dtype)]
                           + [ri.abs().amax(-1) if ri.shape[1] else torch.zeros(B, device=device,
                                                                                    dtype=dtype)
                              for ri in r_i]).amax(0) / scale_p
        dres = r_d.abs().amax(-1) / scale_d
        return pres, dres

    # the start point
    fac = factor(s, z)
    r_d, r_p, r_i, mu = residuals(x, y, s, z)
    dx, dy, _, _ = newton(fac, r_d, r_p, [torch.zeros_like(r) for r in r_i],
                          [torch.zeros_like(r) for r in r_i], s, z)
    x, y = x + dx, y + dy
    s = [torch.where(f > 0, torch.clamp(cx - ri, min=1.0), 1.0) for cx, ri, f in zip(apply(x), rhs, fm)]

    done = torch.zeros(B, dtype=torch.bool, device=device)
    iters = torch.zeros(B, dtype=torch.int64, device=device)
    best = None
    for _ in range(max_iter):
        r_d, r_p, r_i, mu = residuals(x, y, s, z)
        pres, dres = merit(r_d, r_p, r_i)
        worst = torch.stack([pres / EPS_RES, dres / EPS_RES, mu / EPS_MU]).amax(0)
        score = torch.nan_to_num(worst, nan=np.inf)
        if best is None:
            best = (score, x, y, s, z)
        else:
            better = score < best[0]
            best = (torch.where(better, score, best[0]),
                    torch.where(better[:, None], x, best[1]),
                    torch.where(better[:, None], y, best[2]),
                    [torch.where(better[:, None], a, o) for a, o in zip(s, best[3])],
                    [torch.where(better[:, None], a, o) for a, o in zip(z, best[4])])
        done = done | (worst <= 1.0)
        if bool(done.all()):
            break
        fac = factor(s, z)
        ok = fac[3] & ~done
        # predictor
        r_c = [si * zi * f for si, zi, f in zip(s, z, fm)]
        dx, dy, ds, dz = newton(fac, r_d, r_p, r_i, r_c, s, z)
        a_aff = torch.clamp(step_to_boundary(s, z, ds, dz), max=1.0)
        mu_aff = sum(((si + a_aff[:, None] * dsi) * (zi + a_aff[:, None] * dzi) * f).sum(-1)
                     for si, dsi, zi, dzi, f in zip(s, ds, z, dz, fm)) / rows
        sigma = torch.clamp(mu_aff / mu.clamp(min=torch.finfo(dtype).tiny), max=1.0) ** 3
        # corrector
        r_c = [(si * zi + dsi * dzi - (sigma * mu)[:, None]) * f
               for si, zi, dsi, dzi, f in zip(s, z, ds, dz, fm)]
        dx, dy, ds, dz = newton(fac, r_d, r_p, r_i, r_c, s, z)
        a = central_step(s, z, ds, dz, torch.clamp(TAU * step_to_boundary(s, z, ds, dz), max=1.0))
        a = torch.where(ok & torch.isfinite(a), a, torch.zeros_like(a))
        a = torch.nan_to_num(a)
        go = a[:, None]
        x = x + go * torch.nan_to_num(dx)
        y = y + go * torch.nan_to_num(dy)
        s = [si + go * torch.nan_to_num(dsi) for si, dsi in zip(s, ds)]
        z = [zi + go * torch.nan_to_num(dzi) for zi, dzi in zip(z, dz)]
        iters = iters + (~done).to(iters.dtype)
        if not bool(ok.any()):
            break
    _, x, y, s, z = best

    def kkt_merit(x, y, z):
        """The worst of primal violation, stationarity, a negative
        multiplier, complementarity (scaled as the stopping targets are)
        and the duality gap (scaled as ``optimality`` scales it) of
        (x, y, z)."""
        slack = [(cx - ri) * f for cx, ri, f in zip(apply(x), rhs, fm)]
        prim = torch.stack([(torch.einsum("bpn,bn->bp", A, x) - b).abs().amax(-1) if p
                            else torch.zeros(B, device=device, dtype=dtype)]
                           + [(-sl).clamp(min=0).amax(-1) if sl.shape[1]
                              else torch.zeros(B, device=device, dtype=dtype) for sl in slack]
                           ).amax(0) / scale_p
        stat = (torch.einsum("bij,bj->bi", P, x) + c - torch.einsum("bpn,bp->bn", A, y)
                - apply_t([zi * f for zi, f in zip(z, fm)])).abs().amax(-1) / scale_d
        neg = torch.stack([(-zi * f).clamp(min=0).amax(-1) if zi.shape[1]
                           else torch.zeros(B, device=device, dtype=dtype)
                           for zi, f in zip(z, fm)]).amax(0)
        comp = torch.stack([(zi * sl.clamp(min=0) * f).abs().amax(-1) if zi.shape[1]
                            else torch.zeros(B, device=device, dtype=dtype)
                            for zi, sl, f in zip(z, slack, fm)]).amax(0)
        xPx = torch.einsum("bi,bij,bj->b", x, P, x)
        primal_obj = 0.5 * xPx + (c * x).sum(-1)
        dual_obj = (-0.5 * xPx + (b * y).sum(-1)
                    + sum((ri * zi * f).sum(-1) for ri, zi, f in zip(rhs, z, fm)))
        gap = (primal_obj - dual_obj).abs() / primal_obj.abs().clamp(min=1.0)
        return torch.nan_to_num(torch.stack([prim, stat, neg, comp, gap]).amax(0), nan=np.inf)

    # polish: the equality-constrained QP of the rows the iterate holds
    # active (z > s), solved directly; kept where its system is regular and
    # its KKT merit, the duality gap with it, is lower
    groups = [g for g in range(4) if bool(masks[g].any())]
    active = [((z[g] > s[g]) & masks[g]) for g in groups]
    n_rows = [rhs[g].shape[1] for g in groups]
    N = n + p + sum(n_rows)
    M = torch.zeros(B, N, N, device=device, dtype=dtype)
    v = torch.zeros(B, N, device=device, dtype=dtype)
    M[:, :n, :n] = P
    M[:, :n, n:n + p] = -A.mT
    M[:, n:n + p, :n] = A
    M[:, n:n + p, n:n + p] = torch.diag_embed(dummy)
    v[:, :n] = -c
    v[:, n:n + p] = b
    eye = torch.eye(n, device=device, dtype=dtype).expand(B, n, n)
    ops = {0: G, 1: -G, 2: eye, 3: -eye}
    at = n + p
    for g, act, k in zip(groups, active, n_rows):
        Cg = ops[g]
        sl = slice(at, at + k)
        M[:, :n, sl] = -Cg.mT
        M[:, sl, :n] = Cg * act[..., None]
        M[:, sl, sl] = torch.diag_embed((~act).to(dtype))
        v[:, sl] = rhs[g] * act
        at += k
    # a problem whose iterate is not finite keeps it (and fails its check)
    finite = torch.isfinite(M).all(-1).all(-1) & torch.isfinite(v).all(-1)
    # more rows held active than variables: the active set is degenerate
    # and its system singular
    finite &= sum(a.sum(-1) for a in active) + (1.0 - dummy).sum(-1) <= n
    eye_N = torch.eye(N, device=device, dtype=dtype).expand(B, N, N)
    sol, info = torch.linalg.solve_ex(torch.where(finite[:, None, None], M, eye_N),
                                      torch.where(finite[:, None], v, 0.0))
    # fewer active rows than variables can still be dependent ones: an
    # exactly singular factor keeps the iterate too
    finite &= info == 0
    xp, yp = sol[:, :n], sol[:, n:n + p]
    zp = [torch.zeros_like(r) for r in rhs]
    at = n + p
    for g, k in zip(groups, n_rows):
        zp[g] = sol[:, at:at + k]
        at += k
    better = finite & (kkt_merit(xp, yp, zp) < kkt_merit(x, y, z))
    x = torch.where(better[:, None], xp, x)
    y = torch.where(better[:, None], yp, y)
    z = [torch.where(better[:, None], a, o) for a, o in zip(zp, z)]
    y_eq = y[:, p0:]
    z[0] = z[0] * fm[0] + y_eq.clamp(min=0)
    z[1] = z[1] * fm[1] + (-y_eq).clamp(min=0)
    y = y[:, :p0]
    zz = [(zi * f).double().cpu().numpy() for zi, f in zip(z[:2], (1.0, 1.0))] + [
        (zi * f).double().cpu().numpy() for zi, f in zip(z[2:], fm[2:])]
    # the program's sign convention: z_l for h_l <= Gx, z_u for Gx <= h_u,
    # y with A'y on the side of c (Px + c + A'y + G'(z_u - z_l) + z_bu - z_bl = 0)
    return (x.double().cpu().numpy(), -y.double().cpu().numpy(), zz[0], zz[1], zz[2], zz[3],
            done.cpu().numpy(), iters.cpu().numpy())


def optimality(prob: dict, x, y, z_l, z_u, z_bl, z_bu) -> float:
    """Worst scaled violation of the KKT conditions of one solution on the
    original data, in float64: primal feasibility, dual feasibility,
    stationarity, duality gap (a frozen copy of ``chip_smoke.py``'s
    ``_optimality`` for dense P, A, G; P read from its upper triangle)."""
    c, A, b = prob["c"], prob["A"], prob["b"]
    h_l, h_u, x_l, x_u = prob["h_l"], prob["h_u"], prob["x_l"], prob["x_u"]
    inf = 1e30
    hl, hu, xl, xu = h_l > -inf, h_u < inf, x_l > -inf, x_u < inf
    P = np.triu(prob["P"]) + np.triu(prob["P"], 1).T
    G = prob["G"].copy()
    G[~hl & ~hu] = 0.0
    scale = max(1.0, np.abs(x).max(initial=0.0))
    Gx = G @ x
    primal = max(
        np.abs(A @ x - b).max(initial=0.0),
        np.maximum(Gx[hu] - h_u[hu], 0).max(initial=0.0),
        np.maximum(h_l[hl] - Gx[hl], 0).max(initial=0.0),
        np.maximum(x[xu] - x_u[xu], 0).max(initial=0.0),
        np.maximum(x_l[xl] - x[xl], 0).max(initial=0.0),
    ) / scale
    dual = max(0.0, -min(z_l.min(initial=0), z_u.min(initial=0),
                         z_bl.min(initial=0), z_bu.min(initial=0)))
    grad = P @ x + c + A.T @ y + G.T @ (z_u - z_l) + z_bu - z_bl
    gscale = max(1.0, np.abs(P @ x).max(initial=0.0), np.abs(c).max(initial=0.0))
    primal_obj = 0.5 * x @ P @ x + c @ x
    dual_obj = (-0.5 * x @ P @ x - b @ y + np.where(hl, h_l, 0) @ z_l
                - np.where(hu, h_u, 0) @ z_u + np.where(xl, x_l, 0) @ z_bl
                - np.where(xu, x_u, 0) @ z_bu)
    gap = abs(primal_obj - dual_obj) / max(1.0, abs(primal_obj))
    return max(primal, dual, np.abs(grad).max() / gscale, gap)
