"""Host sparse backend (``piqp_tpu/hostsparse.py``): the same proximal
IPM over scipy.sparse, on the CPU.

The JAX package routes large general sparse QPs with no block structure
here, and the port keeps the route as it is: a scalar etree-chasing
LDL^T (the reference's sparse/ldlt.hpp:101-169) suits neither
accelerator.  ``SparseSolver`` takes it for ``kkt_solver=sparse_host`` or
a ``dense_cholesky`` problem above ``dense_routing_max_n``.  A NumPy twin
of the IPM (solver.py), iteration for iteration identical in its update
rules, over the reference's full 3-block sparse KKT mode:

    [ P + diag(x_reg)   A'              G'               ] [dx]   [rx]
    [ A                 -delta_reg I                     ] [dy] = [ry]
    [ G                                 -diag(z_reg_fac) ] [dz]   [rz]

(the KKT_FULL backend, sparse/kkt_full.hpp:22-252, with the condensation
and recovery of kkt_system.hpp:213-369) and its eliminated modes
(``_KKT``), factored with SuperLU instead of an up-looking LDL^T; the
iterative refinement loop (kkt_system.hpp:254-308) recovers any accuracy
difference.

This module is a copy of the JAX package's, which imports only numpy,
scipy and its types; here it imports the port's ``types``, and the
copy leaves out the JAX package's certificate trace (an environment
switch that prints every iteration).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from .types import PIQP_INF, Settings, Status

MIN_SCALING = 1e-4
MAX_SCALING = 1e4


@dataclasses.dataclass
class HostData:
    P: sp.csc_matrix  # full symmetric
    c: np.ndarray
    A: sp.csc_matrix
    b: np.ndarray
    G: sp.csc_matrix
    h_l: np.ndarray
    h_u: np.ndarray
    x_l: np.ndarray
    x_u: np.ndarray
    x_b_scaling: np.ndarray
    hl_mask: np.ndarray
    hu_mask: np.ndarray
    xl_mask: np.ndarray
    xu_mask: np.ndarray

    @property
    def AT(self):
        """Cached Aᵀ — repeated transpose construction per matvec was a
        measurable share of small-problem solve time."""
        if getattr(self, "_AT", None) is None:
            self._AT = self.A.T.tocsr()
        return self._AT

    @property
    def GT(self):
        if getattr(self, "_GT", None) is None:
            self._GT = self.G.T.tocsr()
        return self._GT

    @property
    def n(self):
        return self.P.shape[0]

    @property
    def p(self):
        return self.A.shape[0]

    @property
    def m(self):
        return self.G.shape[0]


@dataclasses.dataclass
class HostScaling:
    c: float
    d_x: np.ndarray
    d_y: np.ndarray
    d_z: np.ndarray
    d_b: np.ndarray


@dataclasses.dataclass
class HostResult:
    x: np.ndarray
    y: np.ndarray
    z_l: np.ndarray
    z_u: np.ndarray
    z_bl: np.ndarray
    z_bu: np.ndarray
    s_l: np.ndarray
    s_u: np.ndarray
    s_bl: np.ndarray
    s_bu: np.ndarray
    info: "HostInfo"


@dataclasses.dataclass
class HostInfo:
    status: int = int(Status.UNSOLVED)
    iter: int = 0
    rho: float = 0.0
    delta: float = 0.0
    mu: float = 0.0
    sigma: float = 0.0
    primal_step: float = 0.0
    dual_step: float = 0.0
    primal_res: float = np.inf
    primal_res_rel: float = np.inf
    dual_res: float = np.inf
    dual_res_rel: float = np.inf
    primal_obj: float = 0.0
    dual_obj: float = 0.0
    duality_gap: float = np.inf
    duality_gap_rel: float = np.inf
    factor_retires: int = 0
    no_primal_update: int = 0
    no_dual_update: int = 0
    primal_res_reg: float = np.inf
    primal_res_reg_rel: float = np.inf
    dual_res_reg: float = np.inf
    dual_res_reg_rel: float = np.inf
    primal_prox_inf: float = 0.0
    dual_prox_inf: float = 0.0
    # the rest of the device Info's fields, so that the host route's info
    # has every field of results.hpp:44-89 (the C interface reads them all)
    prev_primal_res: float = np.inf
    prev_dual_res: float = np.inf
    reg_limit: float = 0.0
    # wall-time metrics (results.hpp:83-88); filled by the API wrapper
    setup_time: float = 0.0
    update_time: float = 0.0
    solve_time: float = 0.0
    kkt_factor_time: float = 0.0
    kkt_solve_time: float = 0.0
    run_time: float = 0.0


def prepare_sparse(
    P, c, A=None, b=None, G=None, h_l=None, h_u=None, x_l=None, x_u=None
) -> HostData:
    """Canonicalize into masked CSC form; mirrors api.prepare_data
    (upper-triangle symmetrization, PIQP_INF masking,
    disable_inf_constraints — dense/data.hpp:100-169)."""
    P = sp.csc_matrix(P).astype(np.float64)
    n = P.shape[0]
    P = sp.triu(P) + sp.triu(P, 1).T

    A = sp.csc_matrix((0, n)) if A is None else sp.csc_matrix(A).astype(np.float64)
    G = sp.csc_matrix((0, n)) if G is None else sp.csc_matrix(G).astype(np.float64)
    p, m = A.shape[0], G.shape[0]
    c = np.zeros(n) if c is None else np.asarray(c, np.float64).ravel()
    b = np.zeros(p) if b is None else np.asarray(b, np.float64).ravel()
    h_l = np.full(m, -np.inf) if h_l is None else np.asarray(h_l, np.float64).ravel()
    h_u = np.full(m, np.inf) if h_u is None else np.asarray(h_u, np.float64).ravel()
    x_l = np.full(n, -np.inf) if x_l is None else np.asarray(x_l, np.float64).ravel()
    x_u = np.full(n, np.inf) if x_u is None else np.asarray(x_u, np.float64).ravel()

    hl_mask = h_l > -PIQP_INF
    hu_mask = h_u < PIQP_INF
    dead = ~hl_mask & ~hu_mask
    if dead.any():
        Glil = G.tolil()
        Glil[np.where(dead)[0], :] = 0.0
        G = Glil.tocsc()
        h_l = np.where(dead, -1.0, h_l)
        h_u = np.where(dead, 1.0, h_u)
        hl_mask = h_l > -PIQP_INF
        hu_mask = h_u < PIQP_INF
    xl_mask = x_l > -PIQP_INF
    xu_mask = x_u < PIQP_INF

    return HostData(
        P=P.tocsc(), c=c, A=A.tocsc(), b=b, G=G.tocsc(),
        h_l=np.where(hl_mask, h_l, 0.0),
        h_u=np.where(hu_mask, h_u, 0.0),
        x_l=np.where(xl_mask, x_l, 0.0),
        x_u=np.where(xu_mask, x_u, 0.0),
        x_b_scaling=np.ones(n),
        hl_mask=hl_mask, hu_mask=hu_mask, xl_mask=xl_mask, xu_mask=xu_mask,
    )


def _limit_scaling(d):
    d = np.where(d < MIN_SCALING, 1.0, d)
    return np.where(d > MAX_SCALING, MAX_SCALING, d)


def equilibrate_host(data: HostData, max_iter=10, scale_cost=False, epsilon=1e-3):
    """Ruiz equilibration over CSC (same semantics as ruiz.py /
    sparse::RuizEquilibration, sparse/preconditioner.hpp:26-60+)."""
    n, p, m = data.n, data.p, data.m
    # scale the CSC value arrays in place (pattern is fixed across Ruiz
    # iterations); building diag matrices + matmuls per iteration dominated
    # small-problem setup time
    P, A, G = data.P.tocsc(copy=True), data.A.tocsc(copy=True), data.G.tocsc(copy=True)
    Pcol = np.repeat(np.arange(n), np.diff(P.indptr))
    Acol = np.repeat(np.arange(n), np.diff(A.indptr))
    Gcol = np.repeat(np.arange(n), np.diff(G.indptr))
    c = data.c.copy()
    xb = data.x_b_scaling.copy()
    cost = 1.0
    d_x, d_y, d_z, d_b = np.ones(n), np.ones(p), np.ones(m), np.ones(n)

    def segmax(vals, idx, size):
        out = np.zeros(size)
        np.maximum.at(out, idx, np.abs(vals))
        return out

    for _ in range(max_iter):
        norm_x = segmax(P.data, Pcol, n)
        if p:
            norm_x = np.maximum(norm_x, segmax(A.data, Acol, n))
        if m:
            norm_x = np.maximum(norm_x, segmax(G.data, Gcol, n))
        norm_x = np.maximum(norm_x, xb)
        dx = 1.0 / np.sqrt(_limit_scaling(norm_x))
        dy = (1.0 / np.sqrt(_limit_scaling(segmax(A.data, A.indices, p)))
              if p else np.ones(0))
        dz = (1.0 / np.sqrt(_limit_scaling(segmax(G.data, G.indices, m)))
              if m else np.ones(0))
        db = 1.0 / np.sqrt(_limit_scaling(xb))

        P.data *= dx[P.indices] * dx[Pcol]
        if p:
            A.data *= dy[A.indices] * dx[Acol]
        if m:
            G.data *= dz[G.indices] * dx[Gcol]
        c = c * dx
        xb = xb * db * dx
        d_x, d_y, d_z, d_b = d_x * dx, d_y * dy, d_z * dz, d_b * db

        if scale_cost:
            # mean column norm of P vs |c|_inf (preconditioner.hpp:148-169)
            pn = segmax(P.data, Pcol, n)
            gamma = _limit_scaling(np.asarray(pn.sum() / max(n, 1)))
            gamma = 1.0 / float(
                _limit_scaling(np.maximum(gamma, np.abs(c).max(initial=0.0)))
            )
            P.data *= gamma
            c = c * gamma
            cost *= gamma

        measure = max(
            np.abs(1.0 - dx).max(initial=0.0),
            np.abs(1.0 - dy).max(initial=0.0) if p else 0.0,
            np.abs(1.0 - dz).max(initial=0.0) if m else 0.0,
            np.abs(1.0 - db).max(initial=0.0),
        )
        if measure < epsilon:
            break

    scaled = HostData(
        P=P, c=c, A=A, b=data.b * d_y, G=G,
        h_l=data.h_l * d_z, h_u=data.h_u * d_z,
        x_l=data.x_l * d_b, x_u=data.x_u * d_b,
        x_b_scaling=xb,
        hl_mask=data.hl_mask, hu_mask=data.hu_mask,
        xl_mask=data.xl_mask, xu_mask=data.xu_mask,
    )
    return scaled, HostScaling(cost, d_x, d_y, d_z, d_b)


def _safe_inv(x, mask):
    return np.where(mask, 1.0 / np.where(mask, x, 1.0), 0.0)


class _KKT:
    """Scalings + sparse KKT factor/solve (KKTSystem over the reference's
    four KKT modes, sparse/kkt_full.hpp / kkt_eq_eliminated.hpp /
    kkt_ineq_eliminated.hpp / kkt_all_eliminated.hpp):

      - ``full``: the (n+p+m) quasidefinite 3-block system;
      - ``eq``:   equalities eliminated — (n+m) system with
                  P + diag(x_reg) + delta^-1 A'A in the top-left
                  (kkt_eq_eliminated.hpp:22-120);
      - ``ineq``: inequalities eliminated — (n+p) system with
                  P + diag(x_reg) + G'WG in the top-left
                  (kkt_ineq_eliminated.hpp:22-120);
      - ``cond``: everything eliminated — the n x n SPD system
                  (kkt_all_eliminated.hpp:22-100).

    ``mode="auto"`` (default) picks full-vs-cond by structural nnz
    (_choose_route); the explicit modes mirror the reference's user-chosen
    KKTMode settings (sparse_ldlt_eq_cond / sparse_ldlt_ineq_cond)."""

    def __init__(self, data: HostData, settings: Settings, mode: str = "auto"):
        if mode not in ("auto", "full", "eq", "ineq", "cond"):
            raise ValueError(f"unknown kkt_mode {mode!r}")
        self._mode = mode
        self.data = data
        self.settings = settings
        self.P_diag = data.P.diagonal()
        # refinement (without static reg) is always on: SuperLU's pivoted
        # factors of the quasidefinite KKT lose accuracy on ill-conditioned
        # instances (Netlib pilotnov stalls at primal_res ~2e-2 unrefined);
        # refining against the unperturbed system leaves well-conditioned
        # trajectories bit-identical while recovering the hard ones.
        self.refine = True
        self.refine_stalled = False
        self._Kc = None  # cached (K pattern, diag positions, base values)
        # condensed ALL_ELIMINATED route (kkt_all_eliminated.hpp:22-100):
        # factor the n x n K = P + diag(x_reg) + (1/delta) A'A + G'WG
        # instead of the (n+p+m) full KKT when the condensed pattern stays
        # sparse.  Chosen once per instance by _choose_route; falls back to
        # the full KKT permanently on any numerical failure.
        self._route = None
        self._condc = None  # cached (AtA csc, G csr)
        self._force_full = False
        self._using_cond = False
        self._using_elim = None
        self._w_f = None
        # exact cumulative phase timers (results.hpp:87-88); instance
        # attributes shadow the methods with timed wrappers
        self.factor_time = 0.0
        self.solve_time = 0.0
        self.factor = self._timed(self.factor, "factor_time")
        self.solve = self._timed(self.solve, "solve_time")

    def _timed(self, fn, attr):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                setattr(self, attr, getattr(self, attr) + time.perf_counter() - t0)

        return wrapper

    def compute_scalings(self, v, rho, delta, use_ir):
        d, s = self.data, self
        s.rho, s.delta = rho, delta
        s.z_l_inv = _safe_inv(v.z_l, d.hl_mask)
        s.z_u_inv = _safe_inv(v.z_u, d.hu_mask)
        s.z_bl_inv = _safe_inv(v.z_bl, d.xl_mask)
        s.z_bu_inv = _safe_inv(v.z_bu, d.xu_mask)
        s.s_l, s.s_u, s.s_bl, s.s_bu = v.s_l, v.s_u, v.s_bl, v.s_bu
        s.W_l_inv = np.where(d.hl_mask, 1.0 / (s.z_l_inv * v.s_l + delta), 0.0)
        s.W_u_inv = np.where(d.hu_mask, 1.0 / (s.z_u_inv * v.s_u + delta), 0.0)
        s.W_bl_inv = np.where(d.xl_mask, 1.0 / (s.z_bl_inv * v.s_bl + delta), 0.0)
        s.W_bu_inv = np.where(d.xu_mask, 1.0 / (s.z_bu_inv * v.s_bu + delta), 0.0)
        xb2 = d.x_b_scaling**2
        s.x_reg = rho + xb2 * s.W_bl_inv + xb2 * s.W_bu_inv
        zs = s.W_l_inv + s.W_u_inv
        s.z_reg = np.where(zs > 0, 1.0 / np.where(zs > 0, zs, 1.0), 0.0)
        # static regularization (kkt_system.hpp:195-207).  Unlike the
        # device backends, refinement itself is ALWAYS on for the host LU
        # (see solve_host); the static regularization — which perturbs the
        # factored system and hence the iterate trajectory — is only added
        # when the recovery ladder requests it, exactly like the reference.
        max_diag = np.abs(self.P_diag + s.x_reg).max(initial=0.0)
        max_diag = max(max_diag, np.abs(s.z_reg).max(initial=0.0))
        reg = (
            settings_reg(self.settings) + self.settings.static_reg_rel() * max_diag
            if use_ir else 0.0
        )
        s.use_ir = use_ir
        s.x_reg_f = s.x_reg + reg
        s.z_reg_f = s.z_reg + reg
        s.delta_f = delta + reg

    def _kkt_cache(self):
        """Assemble the KKT pattern ONCE; later factorizations scatter only
        the three changing diagonals into the cached value array (the scipy
        analog of the reference's nnz-map diagonal scatter,
        sparse/kkt.hpp:83-105).  Data (P/A/G values) is immutable for the
        lifetime of a _KKT instance, so only x_reg_f/delta_f/z_reg_f vary."""
        if self._Kc is None:
            d = self.data
            n, p, m = d.n, d.p, d.m
            # +1/-1 placeholders materialize every diagonal slot in the
            # pattern even where P's diagonal is structurally zero
            Pb = d.P.tocsc() + sp.diags(np.ones(n))
            row_x = [Pb] + ([d.A.T] if p else []) + ([d.G.T] if m else [])
            blocks = [row_x]
            if p:
                blocks.append([d.A, -sp.eye(p)] + ([None] if m else []))
            if m:
                blocks.append(
                    [d.G] + ([None] if p else []) + [-sp.diags(np.ones(m))]
                )
            K = sp.bmat(blocks, format="csc") if (p or m) else Pb.tocsc()
            K.sort_indices()
            N = n + p + m
            diag_pos = np.empty(N, dtype=np.int64)
            for j in range(N):
                lo, hi = K.indptr[j], K.indptr[j + 1]
                diag_pos[j] = lo + np.searchsorted(K.indices[lo:hi], j)
            base = K.data.copy()
            base[diag_pos[:n]] -= 1.0
            base[diag_pos[n:]] += 1.0
            self._Kc = (K, diag_pos, base)
        return self._Kc

    def _cond_cache(self):
        if self._condc is None:
            d = self.data
            AtA = (d.AT @ d.A).tocsc() if d.p else None
            Gcsr = d.G.tocsr() if d.m else None
            self._condc = (AtA, Gcsr)
        return self._condc

    def _choose_route(self):
        """Pick full-KKT vs condensed ALL_ELIMINATED by structural nnz:
        the condensed system is n x n instead of (n+p+m) x (n+p+m), which
        cuts SuperLU fill dramatically on constraint-heavy instances
        (CVXQP1_L: 1.4 s vs 17.4 s per factorization, measured on this
        container) — but a single dense-ish row of A or G densifies A'A /
        G'G, so the product patterns are estimated first and the condensed
        route is taken only when its pattern stays comparable to the full
        KKT's (the same tradeoff the reference leaves to the
        KKT_ALL_ELIMINATED setting, kkt_all_eliminated.hpp:22-100)."""
        d = self.data
        if d.p == 0 and d.m == 0:
            return "full"  # full KKT already is the n x n system
        if d.n == 0 or d.P.diagonal().min() <= 0.0:
            # LPs / non-strictly-convex QPs: the condensed diagonal is pure
            # regularization (rho ~ 1e-6) against delta^-1 A'A ~ 1e6, and
            # the degraded solve accuracy loses infeasibility certificates
            # (Netlib qual/vol1 regressed from PRIMAL_INFEASIBLE to
            # MAX_ITER when condensed); keep the full quasidefinite KKT
            return "full"
        nnz_full = d.P.nnz + d.n + 2 * (d.A.nnz + d.G.nnz) + d.p + d.m
        # cheap upper bound on the product nnz: sum_r nnz_row^2
        est = 0
        for M in (d.A, d.G):
            if M.shape[0]:
                rc = np.diff(M.tocsr().indptr)
                est += int(np.sum(rc.astype(np.int64) ** 2))
        if est > 30 * nnz_full:
            return "full"
        try:
            AtA, Gcsr = self._cond_cache()
        except MemoryError:
            return "full"
        nnz_cond = d.P.nnz + d.n + (AtA.nnz if AtA is not None else 0)
        if Gcsr is not None:
            try:
                GtG = Gcsr.T @ Gcsr
            except MemoryError:
                return "full"
            nnz_cond += GtG.nnz
        return "cond" if nnz_cond <= 2 * nnz_full else "full"

    def _factor_cond(self):
        d = self.data
        AtA, Gcsr = self._cond_cache()
        K = d.P + sp.diags(self.x_reg_f)
        if d.p:
            K = K + (1.0 / self.delta_f) * AtA
        if d.m:
            zs_f = np.where(self.z_reg_f > 0, self.z_reg_f, 1.0)
            w_f = np.where(self.z_reg_f > 0, 1.0 / zs_f, 0.0)
            # dead rows (z_reg = 0: both bounds infinite, G row zeroed by
            # disable_inf_constraints) contribute nothing and recover z = 0
            self._w_f = w_f
            K = K + Gcsr.T @ sp.diags(w_f) @ Gcsr
        try:
            # SPD system under a fixed fill-reducing ordering: symmetric
            # mode + minimum degree on K'+K beats COLAMD ~2.5x here
            self.lu = spla.splu(
                K.tocsc(), permc_spec="MMD_AT_PLUS_A",
                diag_pivot_thresh=0.001,
                options=dict(SymmetricMode=True),
            )
            ok = (np.isfinite(self.lu.L.data).all()
                  and np.isfinite(self.lu.U.data).all())
        except (RuntimeError, MemoryError):
            self.lu = None
            ok = False
        return bool(ok)

    def _factor_elim(self, which):
        """Partially eliminated quasidefinite KKT (kkt_eq_eliminated.hpp /
        kkt_ineq_eliminated.hpp): eliminate ONE constraint block into the
        top-left, keep the other as an explicit bordered block."""
        d = self.data
        AtA, Gcsr = self._cond_cache()
        K11 = d.P + sp.diags(self.x_reg_f)
        if which == "eq":
            if d.p:
                K11 = K11 + (1.0 / self.delta_f) * AtA
            if d.m:
                zs_f = np.where(self.z_reg_f > 0, self.z_reg_f, 1.0)
                # dead rows (z_reg = 0) keep a -1 diagonal slot so the
                # bordered block stays invertible; their lz recovers 0
                diag = -np.where(self.z_reg_f > 0, zs_f, 1.0)
                K = sp.bmat([[K11, d.GT], [d.G, sp.diags(diag)]],
                            format="csc")
            else:
                K = K11.tocsc()
        else:  # ineq
            if d.m:
                zs_f = np.where(self.z_reg_f > 0, self.z_reg_f, 1.0)
                w_f = np.where(self.z_reg_f > 0, 1.0 / zs_f, 0.0)
                self._w_f = w_f
                K11 = K11 + Gcsr.T @ sp.diags(w_f) @ Gcsr
            if d.p:
                K = sp.bmat(
                    [[K11, d.AT],
                     [d.A, -self.delta_f * sp.eye(d.p)]], format="csc",
                )
            else:
                K = K11.tocsc()
        try:
            self.lu = spla.splu(K)
            ok = (np.isfinite(self.lu.L.data).all()
                  and np.isfinite(self.lu.U.data).all())
        except (RuntimeError, MemoryError):
            self.lu = None
            ok = False
        return bool(ok)

    def factor(self):
        if self._mode in ("eq", "ineq") and not self._force_full:
            if self._factor_elim(self._mode):
                self._using_cond = False
                self._using_elim = self._mode
                return True
            self._force_full = True  # numerical failure: full KKT forever
        self._using_elim = None
        if self._route is None:
            self._route = (self._mode if self._mode in ("full", "cond")
                           else self._choose_route())
        if self._route == "cond" and not self._force_full:
            if self._factor_cond():
                self._using_cond = True
                return True
            # permanent fallback: a condensed factorization that failed
            # numerically is re-done (and all later ones) as full KKT
            self._force_full = True
        self._using_cond = False
        d = self.data
        n, p, m = d.n, d.p, d.m
        K, diag_pos, base = self._kkt_cache()
        vals = base.copy()
        vals[diag_pos[:n]] += self.x_reg_f
        if p:
            vals[diag_pos[n:n + p]] -= self.delta_f
        if m:
            vals[diag_pos[n + p:]] -= self.z_reg_f
        K.data[:] = vals
        try:
            self.lu = spla.splu(K)
            ok = np.isfinite(self.lu.L.data).all() and np.isfinite(self.lu.U.data).all()
        except RuntimeError:
            self.lu = None
            ok = False
        return bool(ok)

    # condensed (x,y,z) matvec for refinement (kkt_system.hpp:507-519):
    # statically regularized x_reg, UNregularized delta / z_reg.
    def mul_condensed(self, lx, ly, lz):
        d = self.data
        rx = d.P @ lx + self.x_reg_f * lx
        ry = np.zeros(d.p)
        rz = np.zeros(d.m)
        if d.p:
            rx = rx + d.AT @ ly
            ry = d.A @ lx - self.delta * ly
        if d.m:
            rx = rx + d.GT @ lz
            rz = d.G @ lx - self.z_reg * lz
        return rx, ry, rz

    def _raw_solve(self, rx, ry, rz):
        """One unrefined solve of the factored (regularized) 3-block
        system, via whichever factorization ``factor`` produced: the full
        KKT LU, or the condensed n x n LU + y/z recovery
        (kkt_all_eliminated.hpp algebra: y = (A x - ry)/delta,
        z = W (G x - rz))."""
        d = self.data
        if self._using_cond:
            rhs = rx
            if d.p:
                rhs = rhs + d.AT @ ry * (1.0 / self.delta_f)
            if d.m:
                rhs = rhs + d.GT @ (self._w_f * rz)
            lx = self.lu.solve(rhs)
            ly = (d.A @ lx - ry) / self.delta_f if d.p else np.zeros(0)
            lz = self._w_f * (d.G @ lx - rz) if d.m else np.zeros(0)
            return lx, ly, lz
        if self._using_elim == "eq":
            rhs = rx + (d.AT @ ry) * (1.0 / self.delta_f) if d.p else rx
            sol = self.lu.solve(np.concatenate([rhs, rz]))
            lx, lz = sol[: d.n], sol[d.n:]
            ly = (d.A @ lx - ry) / self.delta_f if d.p else np.zeros(0)
            return lx, ly, lz
        if self._using_elim == "ineq":
            rhs = rx + d.GT @ (self._w_f * rz) if d.m else rx
            sol = self.lu.solve(np.concatenate([rhs, ry]))
            lx, ly = sol[: d.n], sol[d.n:]
            lz = self._w_f * (d.G @ lx - rz) if d.m else np.zeros(0)
            return lx, ly, lz
        sol = self.lu.solve(np.concatenate([rx, ry, rz]))
        return sol[: d.n], sol[d.n: d.n + d.p], sol[d.n + d.p:]

    def solve_xyz(self, rx, ry, rz):
        d = self.data
        lx, ly, lz = self._raw_solve(rx, ry, rz)

        if not self.refine:
            return lx, ly, lz, (np.isfinite(lx).all() and np.isfinite(ly).all()
                                and np.isfinite(lz).all())

        st = self.settings
        rhs_norm = max(np.abs(rx).max(initial=0.0), np.abs(ry).max(initial=0.0),
                       np.abs(rz).max(initial=0.0))
        tol = st.iterative_refinement_eps_abs + st.iterative_refinement_eps_rel * rhs_norm
        self.refine_stalled = False
        ex, ey, ez = self.mul_condensed(lx, ly, lz)
        ex, ey, ez = rx - ex, ry - ey, rz - ez
        err = max(np.abs(ex).max(initial=0.0), np.abs(ey).max(initial=0.0),
                  np.abs(ez).max(initial=0.0))
        if not np.isfinite(err):
            return lx, ly, lz, False
        for _ in range(st.iterative_refinement_max_iter):
            if err <= tol:
                break
            dx, dy, dz = self._raw_solve(ex, ey, ez)
            cx, cy, cz = lx + dx, ly + dy, lz + dz
            nex, ney, nez = self.mul_condensed(cx, cy, cz)
            nex, ney, nez = rx - nex, ry - ney, rz - nez
            nerr = max(np.abs(nex).max(initial=0.0), np.abs(ney).max(initial=0.0),
                       np.abs(nez).max(initial=0.0))
            if not np.isfinite(nerr):
                return lx, ly, lz, False
            rate = err / nerr if nerr > 0 else np.inf
            if rate < st.iterative_refinement_min_improvement_rate and rate <= 1.0:
                break  # keep the better iterate (kkt_system.hpp:289-301)
            lx, ly, lz = cx, cy, cz
            ex, ey, ez, err = nex, ney, nez, nerr
            if rate < st.iterative_refinement_min_improvement_rate:
                break
        # refinement stalled far above target accuracy: signal the IPM loop to
        # escalate to statically-regularized factors (the LU analog of the
        # reference's enable-refinement recovery step, solver.hpp:687-708)
        self.refine_stalled = err > 1e3 * tol
        if self.refine_stalled and self._using_cond:
            # the condensed system's delta^-1 amplification is the likely
            # culprit; re-route subsequent factorizations to the full KKT
            self._force_full = True
        return lx, ly, lz, True

    def solve(self, rhs):
        """Full KKT solve with slack/box condensation and recovery
        (kkt_system.hpp:213-369); rhs/lhs are _Vars."""
        d, s = self.data, self
        rz_l_bar = np.where(d.hl_mask, rhs.z_l - s.z_l_inv * rhs.s_l, 0.0)
        rz_u_bar = np.where(d.hu_mask, rhs.z_u - s.z_u_inv * rhs.s_u, 0.0)
        rhs_z = s.z_reg * (-s.W_l_inv * rz_l_bar + s.W_u_inv * rz_u_bar)

        rb_l = np.where(d.xl_mask, rhs.z_bl - s.z_bl_inv * rhs.s_bl, 0.0)
        rb_u = np.where(d.xu_mask, rhs.z_bu - s.z_bu_inv * rhs.s_bu, 0.0)
        rhs_x = (
            rhs.x
            - d.x_b_scaling * s.W_bl_inv * rb_l
            + d.x_b_scaling * s.W_bu_inv * rb_u
        )

        lx, ly, lz, ok = self.solve_xyz(rhs_x, rhs.y, rhs_z)

        r_sum = s.W_l_inv * s.W_u_inv * (rz_l_bar + rz_u_bar)
        lz_l = np.where(d.hl_mask, -s.z_reg * (r_sum + s.W_l_inv * lz), 0.0)
        lz_u = np.where(d.hu_mask, -s.z_reg * (r_sum - s.W_u_inv * lz), 0.0)
        ls_l = np.where(d.hl_mask, s.z_l_inv * (rhs.s_l - s.s_l * lz_l), 0.0)
        ls_u = np.where(d.hu_mask, s.z_u_inv * (rhs.s_u - s.s_u * lz_u), 0.0)
        lz_bl = np.where(
            d.xl_mask,
            (-d.x_b_scaling * lx - rhs.z_bl + s.z_bl_inv * rhs.s_bl) * s.W_bl_inv, 0.0,
        )
        lz_bu = np.where(
            d.xu_mask,
            (d.x_b_scaling * lx - rhs.z_bu + s.z_bu_inv * rhs.s_bu) * s.W_bu_inv, 0.0,
        )
        ls_bl = np.where(d.xl_mask, s.z_bl_inv * (rhs.s_bl - s.s_bl * lz_bl), 0.0)
        ls_bu = np.where(d.xu_mask, s.z_bu_inv * (rhs.s_bu - s.s_bu * lz_bu), 0.0)
        return _Vars(lx, ly, lz_l, lz_u, lz_bl, lz_bu, ls_l, ls_u, ls_bl, ls_bu), ok


def settings_reg(settings: Settings) -> float:
    return settings.iterative_refinement_static_regularization_eps


# Certificate-validation tolerances shared with the device backend
# (calibration notes in types.py).
from .types import (
    CERT_EQ_TOL as _CERT_EQ_TOL,
    CERT_NEG_TOL as _CERT_NEG_TOL,
    CERT_SUP_TOL as _CERT_SUP_TOL,
)


def _primal_ray_quality(d0: HostData, dy, dz_l, dz_u, dz_bl, dz_bu):
    """Score an (unscaled) candidate ray as a Farkas certificate of primal
    infeasibility:

        A'dy + G'(dz_u - dz_l) + (dz_bu - dz_bl) ~ 0,   dz >= 0,
        b'dy + h_u'dz_u - h_l'dz_l + x_u'dz_bu - x_l'dz_bl < 0

    Returns (eq_rel, neg, sup_rel): relative stationarity-ray residual,
    worst sign violation, and normalized support value (valid certificates
    have eq_rel ~ 0, neg ~ 0, sup_rel < 0)."""
    norm = max(_inf(dy), _inf(dz_l), _inf(dz_u), _inf(dz_bl), _inf(dz_bu))
    if not np.isfinite(norm) or norm <= 0.0:
        return np.inf, np.inf, np.inf
    dy, dz_l, dz_u = dy / norm, dz_l / norm, dz_u / norm
    dz_bl, dz_bu = dz_bl / norm, dz_bu / norm

    neg = -min(dz_l.min(initial=0.0), dz_u.min(initial=0.0),
               dz_bl.min(initial=0.0), dz_bu.min(initial=0.0))
    t = dz_bu - dz_bl
    den = np.abs(t)
    if d0.p:
        t = t + d0.A.T @ dy
        den = den + np.abs(d0.A).T @ np.abs(dy)
    if d0.m:
        t = t + d0.G.T @ (dz_u - dz_l)
        den = den + np.abs(d0.G).T @ (np.abs(dz_u) + np.abs(dz_l))
    eq_rel = _inf(t) / max(den.max(initial=0.0), 1e-30)

    sup = (d0.x_u @ dz_bu - d0.x_l @ dz_bl)
    sup_den = np.abs(d0.x_u) @ np.abs(dz_bu) + np.abs(d0.x_l) @ np.abs(dz_bl)
    if d0.p:
        sup += d0.b @ dy
        sup_den += np.abs(d0.b) @ np.abs(dy)
    if d0.m:
        sup += d0.h_u @ dz_u - d0.h_l @ dz_l
        sup_den += np.abs(d0.h_u) @ np.abs(dz_u) + np.abs(d0.h_l) @ np.abs(dz_l)
    sup_rel = sup / max(sup_den, 1e-30)
    return eq_rel, neg, sup_rel


def _drift_primal_ray(d0: HostData, sc: HostScaling, v: "_Vars", prox: "_Vars"):
    """The (unscaled) proximal dual drift.  At a stationary point of the
    delta-regularized problem ``delta*(y - prox.y) = Ax - b`` (and
    analogously for z), i.e. the drift direction is exactly the ray along
    which the dual objective is unbounded when the primal is infeasible.
    The reference certifies from stall counters alone (solver.hpp:616-622);
    we additionally validate this ray before certifying."""
    dy = (v.y - prox.y) * sc.d_y
    dz_l = np.where(d0.hl_mask, (v.z_l - prox.z_l) * sc.d_z, 0.0)
    dz_u = np.where(d0.hu_mask, (v.z_u - prox.z_u) * sc.d_z, 0.0)
    dz_bl = np.where(d0.xl_mask, (v.z_bl - prox.z_bl) * sc.d_b, 0.0)
    dz_bu = np.where(d0.xu_mask, (v.z_bu - prox.z_bu) * sc.d_b, 0.0)
    return dy, dz_l, dz_u, dz_bl, dz_bu


def _farkas_primal_quality(d0: HostData, sc: HostScaling, v: "_Vars", prox: "_Vars"):
    return _primal_ray_quality(d0, *_drift_primal_ray(d0, sc, v, prox))


def _violation_primal_ray(d0: HostData, x):
    """Candidate Farkas ray built from the constraint violations of an
    (unscaled) iterate x.  At the proximal equilibrium of an infeasible
    problem, x minimizes a weighted distance to feasibility, so the
    violation residuals are stationary: A'(Ax-b) + G'((Gx-h_u)+ - (h_l-Gx)+)
    + box terms ~ 0 — exactly the Farkas stationarity equation with
    dy = Ax-b, dz = the one-sided violations."""
    dy = d0.A @ x - d0.b if d0.p else np.zeros(0)
    if d0.m:
        gx = d0.G @ x
        dz_u = np.where(d0.hu_mask, np.maximum(gx - d0.h_u, 0.0), 0.0)
        dz_l = np.where(d0.hl_mask, np.maximum(d0.h_l - gx, 0.0), 0.0)
    else:
        dz_u = dz_l = np.zeros(0)
    dz_bu = np.where(d0.xu_mask, np.maximum(x - d0.x_u, 0.0), 0.0)
    dz_bl = np.where(d0.xl_mask, np.maximum(d0.x_l - x, 0.0), 0.0)
    return dy, dz_l, dz_u, dz_bl, dz_bu


def _phase1_certificate(d0: HostData, settings: Settings):
    """Solve the phase-1 feasibility QP

        min 1/2 (|r|^2 + |w|^2)
        s.t. Ax - r = b,  h_l <= Gx - w <= h_u,  x_l <= x <= x_u

    whose stationarity condition in x is exactly the Farkas system, so when
    the minimal violation is positive the optimal multipliers
    (y, z_l, z_u, z_bl, z_bu) are a certificate of primal infeasibility.
    Returns the candidate ray or None."""
    n, p, m = d0.n, d0.p, d0.m
    if p + m == 0:
        return None, 0.0
    N = n + p + m
    P = sp.diags(np.concatenate([np.zeros(n), np.ones(p + m)])).tocsc()
    c = np.zeros(N)
    A = sp.hstack(
        [d0.A, -sp.eye(p), sp.csc_matrix((p, m))], format="csc"
    ) if p else None
    G = sp.hstack(
        [d0.G, sp.csc_matrix((m, p)), -sp.eye(m)], format="csc"
    ) if m else None
    x_l = np.concatenate(
        [np.where(d0.xl_mask, d0.x_l, -np.inf), np.full(p + m, -np.inf)]
    )
    x_u = np.concatenate(
        [np.where(d0.xu_mask, d0.x_u, np.inf), np.full(p + m, np.inf)]
    )
    h_l = np.where(d0.hl_mask, d0.h_l, -np.inf) if m else None
    h_u = np.where(d0.hu_mask, d0.h_u, np.inf) if m else None
    res = solve_host(
        prepare_sparse(P, c, A, d0.b if p else None, G, h_l, h_u, x_l, x_u),
        dataclasses.replace(settings, verify_certificates=False),
    )
    if res.info.status != int(Status.SOLVED):
        return None, 0.0
    # minimal violation = |(r, w)|_inf at the optimum, relative to the
    # right-hand-side magnitudes (sup_rel is ~ -violation^2/|data| here,
    # too scale-sensitive to threshold directly)
    viol = _inf(res.x[n:])
    scale = max(
        _inf(d0.b) if p else 0.0,
        _msmax(np.abs(d0.h_l), d0.hl_mask), _msmax(np.abs(d0.h_u), d0.hu_mask),
        _msmax(np.abs(d0.x_l), d0.xl_mask), _msmax(np.abs(d0.x_u), d0.xu_mask),
    )
    viol_rel = viol / max(1.0, scale)
    return (res.y, res.z_l, res.z_u, res.z_bl[:n], res.z_bu[:n]), viol_rel


def _farkas_dual_quality(d0: HostData, sc: HostScaling, v: "_Vars", prox: "_Vars"):
    """Score the (unscaled) primal drift dx = x - prox.x as a certificate of
    dual infeasibility (an unbounded descent ray):

        P dx ~ 0,  A dx ~ 0,  (G dx)_i <= 0 on finite-h_u rows / >= 0 on
        finite-h_l rows (same for boxes),  c'dx < 0.

    Returns (eq_rel, cone, obj_rel): relative P/A-ray residual, worst cone
    violation, normalized objective slope (valid: ~0, ~0, < 0)."""
    dx = (v.x - prox.x) * sc.d_x
    norm = _inf(dx)
    if not np.isfinite(norm) or norm <= 0.0:
        return np.inf, np.inf, np.inf
    dx = dx / norm

    adx = np.abs(dx)
    t = np.abs(d0.P @ dx)
    den = np.abs(d0.P) @ adx
    if d0.p:
        t = np.concatenate([t, np.abs(d0.A @ dx)])
        den = np.concatenate([den, np.abs(d0.A) @ adx])
    eq_rel = t.max(initial=0.0) / max(den.max(initial=0.0), 1e-30)

    cone = 0.0
    if d0.m:
        gdx = d0.G @ dx
        gden = np.maximum(np.abs(d0.G) @ adx, 1e-30)
        cone = max(
            _msmax(gdx / gden, d0.hu_mask),
            _msmax(-gdx / gden, d0.hl_mask),
        )
    cone = max(cone, _msmax(dx, d0.xu_mask), _msmax(-dx, d0.xl_mask))

    obj_rel = (d0.c @ dx) / max(np.abs(d0.c) @ adx, 1e-30)
    return eq_rel, cone, obj_rel


@dataclasses.dataclass
class _Vars:
    x: np.ndarray
    y: np.ndarray
    z_l: np.ndarray
    z_u: np.ndarray
    z_bl: np.ndarray
    z_bu: np.ndarray
    s_l: np.ndarray = None
    s_u: np.ndarray = None
    s_bl: np.ndarray = None
    s_bu: np.ndarray = None

    def copy(self):
        return _Vars(*(None if v is None else v.copy() for v in dataclasses.astuple(self)))


def _inf(v):
    return np.abs(v).max(initial=0.0)


def _msmax(v, mask):
    """Signed masked max (solver.py _masked_signed_max)."""
    return np.where(mask, v, 0.0).max(initial=0.0)


def solve_host(
    data: HostData, settings: Settings = Settings(), verbose: bool = False,
    warm=None, kkt_mode: str = "auto",
) -> HostResult:
    """Host-side proximal IPM; mirrors solver.py::solve_scaled step-for-step
    (itself mirroring solve_impl, solver.hpp:379-882).

    ``warm``: optional previous unscaled iterates (object with x, y, z_l,
    z_u, z_bl, z_bu — e.g. a prior HostResult) to seed the IPM from; the
    twin of solver._warm_vars on the device path."""
    sdata, sc = equilibrate_host(
        data, max_iter=settings.preconditioner_iter,
        scale_cost=settings.preconditioner_scale_cost,
    )
    d = sdata
    n, p, m = d.n, d.p, d.m
    has_cone = bool(m > 0 or d.xl_mask.any() or d.xu_mask.any())
    info = HostInfo(
        status=int(Status.RUNNING), rho=settings.rho_init, delta=settings.delta_init
    )
    reg_limit = settings.reg_lower_limit
    kkt = _KKT(d, settings, kkt_mode)
    t_start = time.perf_counter()

    def _fill_times():
        info.reg_limit = reg_limit
        info.solve_time = time.perf_counter() - t_start
        info.run_time = info.solve_time
        info.kkt_factor_time = kkt.factor_time
        info.kkt_solve_time = kkt.solve_time

    one_ml = np.where(d.hl_mask, 1.0, 0.0)
    one_mu = np.where(d.hu_mask, 1.0, 0.0)
    one_nl = np.where(d.xl_mask, 1.0, 0.0)
    one_nu = np.where(d.xu_mask, 1.0, 0.0)
    v = _Vars(
        np.zeros(n), np.zeros(p),
        one_ml.copy(), one_mu.copy(), one_nl.copy(), one_nu.copy(),
        one_ml.copy(), one_mu.copy(), one_nl.copy(), one_nu.copy(),
    )
    # use_ir gates only the static regularization (see _KKT); plain
    # refinement is always on.
    use_ir = settings.iterative_refinement_always_enabled

    bcount = (
        d.hl_mask.sum() + d.hu_mask.sum() + d.xl_mask.sum() + d.xu_mask.sum()
    )

    def calc_mu(v):
        return (
            v.s_l @ v.z_l + v.s_u @ v.z_u + v.s_bl @ v.z_bl + v.s_bu @ v.z_bu
        ) / max(bcount, 1)

    def factor_ladder():
        nonlocal use_ir, reg_limit
        for _ in range(settings.max_factor_retires + 2):
            kkt.compute_scalings(v, info.rho, info.delta, use_ir)
            if kkt.factor():
                info.factor_retires = 0
                return True
            if not use_ir:
                use_ir = True
                continue
            if info.factor_retires < settings.max_factor_retires:
                info.rho *= 100.0
                info.delta *= 100.0
                reg_limit = min(10.0 * reg_limit, settings.eps_abs)
                info.factor_retires += 1
                continue
            return False
        return False

    if warm is not None:
        # scale the user-space warm point (inverse of _finalize_host) and
        # rebuild slacks from the constraint values
        x = np.asarray(warm.x) / sc.d_x
        v.x = x
        v.y = np.asarray(warm.y) * sc.c / sc.d_y
        v.z_l = np.where(d.hl_mask, np.maximum(np.asarray(warm.z_l) * sc.c / np.where(sc.d_z == 0, 1, sc.d_z), 0.0), 0.0)
        v.z_u = np.where(d.hu_mask, np.maximum(np.asarray(warm.z_u) * sc.c / np.where(sc.d_z == 0, 1, sc.d_z), 0.0), 0.0)
        v.z_bl = np.where(d.xl_mask, np.maximum(np.asarray(warm.z_bl) * sc.c / sc.d_b, 0.0), 0.0)
        v.z_bu = np.where(d.xu_mask, np.maximum(np.asarray(warm.z_bu) * sc.c / sc.d_b, 0.0), 0.0)
        Gx = d.G @ x if m > 0 else np.zeros(0)
        bx = d.x_b_scaling * x
        v.s_l = np.where(d.hl_mask, Gx - d.h_l, 0.0)
        v.s_u = np.where(d.hu_mask, d.h_u - Gx, 0.0)
        v.s_bl = np.where(d.xl_mask, bx - d.x_l, 0.0)
        v.s_bu = np.where(d.xu_mask, d.x_u - bx, 0.0)
        if has_cone:
            # elementwise interior push BEFORE the factorization (negative
            # warm slacks must not reach the KKT scalings; see solver.py's
            # warm branch — the cold recenter would discard the warm slacks)
            eps_ws = np.sqrt(settings.warm_start_mu)
            for name, mask in (("s_l", d.hl_mask), ("s_u", d.hu_mask),
                               ("s_bl", d.xl_mask), ("s_bu", d.xu_mask),
                               ("z_l", d.hl_mask), ("z_u", d.hu_mask),
                               ("z_bl", d.xl_mask), ("z_bu", d.xu_mask)):
                setattr(v, name,
                        np.where(mask, np.maximum(getattr(v, name), eps_ws), 0.0))
            info.mu = calc_mu(v)

    if not factor_ladder():
        info.status = int(Status.NUMERICS)
        _fill_times()
        return _finalize_host(d, sc, v, info)

    if warm is None:
        # first solve from raw problem vectors (solver.hpp:473-492)
        rhs = _Vars(
            -d.c, d.b.copy(),
            np.where(d.hl_mask, -d.h_l, 0.0), np.where(d.hu_mask, d.h_u, 0.0),
            np.where(d.xl_mask, -d.x_l, 0.0), np.where(d.xu_mask, d.x_u, 0.0),
            np.zeros(m), np.zeros(m), np.zeros(n), np.zeros(n),
        )
        v_new, _ = kkt.solve(rhs)
        v = v_new

    if has_cone and warm is None:
        delta_s = max(0.0, -min(v.s_l.min(initial=0.0), v.s_u.min(initial=0.0),
                                v.s_bl.min(initial=0.0), v.s_bu.min(initial=0.0)))
        delta_z = max(0.0, -min(v.z_l.min(initial=0.0), v.z_u.min(initial=0.0),
                                v.z_bl.min(initial=0.0), v.z_bu.min(initial=0.0)))
        for name, mask in (("s_l", d.hl_mask), ("s_u", d.hu_mask),
                           ("s_bl", d.xl_mask), ("s_bu", d.xu_mask)):
            setattr(v, name, np.where(mask, getattr(v, name) + delta_s, 0.0))
        for name, mask in (("z_l", d.hl_mask), ("z_u", d.hu_mask),
                           ("z_bl", d.xl_mask), ("z_bu", d.xu_mask)):
            setattr(v, name, np.where(mask, getattr(v, name) + delta_z, 0.0))
        mu = max(calc_mu(v), 1e-10)

        def recenter(zname, sname, mask):
            z = getattr(v, zname)
            c0 = z - delta_z
            z_new = 0.5 * (c0 + np.sqrt(c0 * c0 + 4.0 * mu))
            setattr(v, zname, np.where(mask, z_new, 0.0))
            setattr(v, sname, np.where(mask, z_new - c0, 0.0))

        recenter("z_l", "s_l", d.hl_mask)
        recenter("z_u", "s_u", d.hu_mask)
        recenter("z_bl", "s_bl", d.xl_mask)
        recenter("z_bu", "s_bu", d.xu_mask)
        info.mu = calc_mu(v)

    prox = _Vars(v.x.copy(), v.y.copy(), v.z_l.copy(), v.z_u.copy(),
                 v.z_bl.copy(), v.z_bu.copy())

    # --- residuals ----------------------------------------------------------
    prev_primal_res = prev_dual_res = np.inf
    c_inv = 1.0 / sc.c
    ud_x = sc.d_x * c_inv
    dyi = 1.0 / sc.d_y if p else np.ones(0)
    dzi = 1.0 / sc.d_z if m else np.ones(0)
    dbi = 1.0 / sc.d_b

    def residuals_nr():
        Px = d.P @ v.x
        Ax = d.A @ v.x if p else np.zeros(0)
        ATy = d.AT @ v.y if p else np.zeros(n)
        Gx = d.G @ v.x if m else np.zeros(0)
        dz_ = v.z_u - v.z_l
        GTdz = d.GT @ dz_ if m else np.zeros(n)

        dual_rel = _inf(Px * ud_x)
        xPx = v.x @ Px
        cx = d.c @ v.x
        by = d.b @ v.y if p else 0.0
        hlzl = d.h_l @ v.z_l if m else 0.0
        huzu = d.h_u @ v.z_u if m else 0.0
        xlzbl = d.x_l @ v.z_bl
        xuzbu = d.x_u @ v.z_bu
        primal_obj = 0.5 * xPx + cx
        dual_obj = -0.5 * xPx - by + hlzl - huzu + xlzbl - xuzbu
        gap_rel = c_inv * max(abs(xPx), abs(cx), abs(by), abs(hlzl),
                              abs(huzu), abs(xlzbl), abs(xuzbu))
        info.duality_gap = abs(primal_obj - dual_obj) * c_inv
        info.primal_obj = primal_obj * c_inv
        info.dual_obj = dual_obj * c_inv
        info.duality_gap_rel = info.duality_gap / max(1.0, gap_rel)

        work = ATy + GTdz
        work = work - np.where(d.xl_mask, d.x_b_scaling * v.z_bl, 0.0)
        work = work + np.where(d.xu_mask, d.x_b_scaling * v.z_bu, 0.0)
        dual_rel = max(dual_rel, _inf(d.c * ud_x), _inf(work * ud_x))
        rx = -Px - d.c - work

        primal_rel = max(_inf(Ax * dyi), _inf(d.b * dyi)) if p else 0.0
        ry = d.b - Ax
        rz_l = np.where(d.hl_mask, Gx - d.h_l - v.s_l, 0.0)
        rz_u = np.where(d.hu_mask, -Gx + d.h_u - v.s_u, 0.0)
        if m:
            primal_rel = max(
                primal_rel,
                _msmax(Gx * dzi, d.hl_mask), _msmax(d.h_l * dzi, d.hl_mask),
                _msmax(v.s_l * dzi, d.hl_mask),
                _msmax(-Gx * dzi, d.hu_mask), _msmax(d.h_u * dzi, d.hu_mask),
                _msmax(v.s_u * dzi, d.hu_mask),
            )
        bx = d.x_b_scaling * v.x
        rz_bl = np.where(d.xl_mask, bx - d.x_l - v.s_bl, 0.0)
        rz_bu = np.where(d.xu_mask, -bx + d.x_u - v.s_bu, 0.0)
        primal_rel = max(
            primal_rel,
            _msmax(bx * dbi, d.xl_mask), _msmax(d.x_l * dbi, d.xl_mask),
            _msmax(v.s_bl * dbi, d.xl_mask),
            _msmax(-bx * dbi, d.xu_mask), _msmax(d.x_u * dbi, d.xu_mask),
            _msmax(v.s_bu * dbi, d.xu_mask),
        )
        res_nr = _Vars(rx, ry, rz_l, rz_u, rz_bl, rz_bu)

        primal_res = max(
            _inf(ry * dyi) if p else 0.0,
            _inf(rz_l * dzi) if m else 0.0, _inf(rz_u * dzi) if m else 0.0,
            _msmax(rz_bl * dbi, d.xl_mask), _msmax(rz_bu * dbi, d.xu_mask),
        )
        dual_res = _inf(rx * ud_x)
        info.primal_res = primal_res
        info.primal_res_rel = primal_res / max(1.0, primal_rel)
        info.dual_res = dual_res
        info.dual_res_rel = dual_res / max(1.0, dual_rel)
        return res_nr

    def residuals_reg(res_nr):
        rho, delta = info.rho, info.delta
        res = _Vars(
            res_nr.x - rho * (v.x - prox.x),
            res_nr.y - delta * (prox.y - v.y),
            res_nr.z_l - delta * (prox.z_l - v.z_l),
            res_nr.z_u - delta * (prox.z_u - v.z_u),
            res_nr.z_bl - delta * (prox.z_bl - v.z_bl),
            res_nr.z_bu - delta * (prox.z_bu - v.z_bu),
            np.zeros(m), np.zeros(m), np.zeros(n), np.zeros(n),
        )
        primal_rel_sc = info.primal_res / info.primal_res_rel if info.primal_res_rel > 0 else 1.0
        dual_rel_sc = info.dual_res / info.dual_res_rel if info.dual_res_rel > 0 else 1.0
        primal_reg = max(
            _inf(res.y * dyi) if p else 0.0,
            _inf(res.z_l * dzi) if m else 0.0, _inf(res.z_u * dzi) if m else 0.0,
            _msmax(res.z_bl * dbi, d.xl_mask), _msmax(res.z_bu * dbi, d.xu_mask),
        )
        dual_reg = _inf(res.x * sc.d_x * c_inv)
        ppi = max(
            _inf((prox.y - v.y) * sc.d_y * c_inv) if p else 0.0,
            _inf((prox.z_l - v.z_l) * sc.d_z * c_inv) if m else 0.0,
            _inf((prox.z_u - v.z_u) * sc.d_z * c_inv) if m else 0.0,
            _msmax((prox.z_bl - v.z_bl) * sc.d_b * c_inv, d.xl_mask),
            _msmax((prox.z_bu - v.z_bu) * sc.d_b * c_inv, d.xu_mask),
        )
        dpi = _inf((v.x - prox.x) * sc.d_x)
        out = dict(
            primal_res_reg=primal_reg,
            primal_res_reg_rel=primal_reg / primal_rel_sc,
            dual_res_reg=dual_reg,
            dual_res_reg_rel=dual_reg / dual_rel_sc,
            primal_prox_inf=ppi * info.delta,
            dual_prox_inf=dpi * info.rho,
        )
        for k, val in out.items():
            setattr(info, k, val)
        return res, out

    res_nr = residuals_nr()
    prev_primal_res, prev_dual_res = info.primal_res, info.dual_res
    info.prev_primal_res, info.prev_dual_res = prev_primal_res, prev_dual_res

    eps = float(np.finfo(np.float64).eps)
    st = settings
    status = int(Status.RUNNING)

    while info.iter < st.max_iter:
        # termination (solver.hpp:606-612)
        converged = (
            (info.primal_res < st.eps_abs or info.primal_res_rel < st.eps_rel)
            and (info.dual_res < st.eps_abs or info.dual_res_rel < st.eps_rel)
        )
        if st.check_duality_gap:
            converged = converged and (
                info.duality_gap < st.eps_duality_gap_abs
                or info.duality_gap_rel < st.eps_duality_gap_rel
            )
        res, reg = residuals_reg(res_nr)
        if converged:
            status = int(Status.SOLVED)
            break
        def _reject_certificate(primal: bool):
            # a failed certificate means the stall counters tripped on a
            # numerically-degenerate (not infeasible) trajectory: relax the
            # regularization floor and restart the counters (like the
            # local-minimum escape, solver.hpp:668-681), and tighten the
            # corresponding proximal penalty — the rejected drift says the
            # proximal subproblem converged without the unregularized one,
            # so the outer proximal-method-of-multipliers update applies
            nonlocal reg_limit
            reg_limit = st.reg_finetune_lower_limit
            info.no_primal_update = 0
            info.no_dual_update = 0
            if primal:
                info.delta = max(reg_limit, 0.1 * info.delta)
            else:
                info.rho = max(reg_limit, 0.1 * info.rho)

        if (
            info.no_dual_update > min(5, st.reg_finetune_dual_update_threshold)
            and reg["primal_prox_inf"] > st.infeasibility_threshold
            and (reg["primal_res_reg"] < st.eps_abs
                 or reg["primal_res_reg_rel"] < st.eps_rel)
        ):
            eq, negq, sup = _farkas_primal_quality(data, sc, v, prox)
            if (not st.verify_certificates) or (
                eq <= _CERT_EQ_TOL and negq <= _CERT_NEG_TOL
                and sup <= -_CERT_SUP_TOL
            ):
                status = int(Status.PRIMAL_INFEASIBLE)
                break
            _reject_certificate(primal=True)
        if (
            info.no_primal_update > min(5, st.reg_finetune_primal_update_threshold)
            and reg["dual_prox_inf"] > st.infeasibility_threshold
            and (reg["dual_res_reg"] < st.eps_abs
                 or reg["dual_res_reg_rel"] < st.eps_rel)
        ):
            eq, cone, obj = _farkas_dual_quality(data, sc, v, prox)
            if (not st.verify_certificates) or (
                eq <= _CERT_EQ_TOL and cone <= _CERT_NEG_TOL
                and obj <= -_CERT_SUP_TOL
            ):
                status = int(Status.DUAL_INFEASIBLE)
                break
            _reject_certificate(primal=False)

        info.iter += 1

        # boundary guard (solver.hpp:634-666)
        if has_cone:
            any_shift = False
            for zn, mask in (("z_l", d.hl_mask), ("z_u", d.hu_mask)):
                z = getattr(v, zn)
                sh = mask & (z < eps)
                if sh.any():
                    setattr(v, zn, np.where(sh, z + eps, z))
                    any_shift = True
            for zn, mask in (("z_bl", d.xl_mask), ("z_bu", d.xu_mask)):
                z = getattr(v, zn)
                if (mask & (z < eps)).any():
                    setattr(v, zn, np.where(mask, z + eps, z))
                    any_shift = True
            if any_shift:
                info.mu = calc_mu(v)

        # escalate to statically-regularized factors when refinement
        # stalled on the last KKT solve (see _KKT.solve_xyz)
        if kkt.refine_stalled:
            use_ir = True

        # regularization fine-tuning (solver.hpp:668-681)
        trig = (
            info.no_primal_update > st.reg_finetune_primal_update_threshold
            and info.rho == reg_limit and reg_limit != st.reg_finetune_lower_limit
        ) or (
            info.no_dual_update > st.reg_finetune_dual_update_threshold
            and info.delta == reg_limit and reg_limit != st.reg_finetune_lower_limit
        )
        if trig and reg["dual_prox_inf"] < st.infeasibility_threshold and \
                reg["primal_prox_inf"] < st.infeasibility_threshold:
            reg_limit = st.reg_finetune_lower_limit
            info.no_primal_update = 0
            info.no_dual_update = 0

        if not factor_ladder():
            status = int(Status.NUMERICS)
            break
        res, reg = residuals_reg(res_nr)

        if has_cone:
            # predictor (solver.hpp:722-737)
            res.s_l = -v.s_l * v.z_l
            res.s_u = -v.s_u * v.z_u
            res.s_bl = -v.s_bl * v.z_bl
            res.s_bu = -v.s_bu * v.z_bu
            step, _ = kkt.solve(res)

            def steplens(step):
                def ratio(val, stp, mask):
                    neg = mask & (stp < 0)
                    if not neg.any():
                        return 1.0
                    return min(1.0, (-val[neg] / stp[neg]).min())

                a_s = min(
                    ratio(v.s_l, step.s_l, d.hl_mask), ratio(v.s_u, step.s_u, d.hu_mask),
                    ratio(v.s_bl, step.s_bl, d.xl_mask), ratio(v.s_bu, step.s_bu, d.xu_mask),
                )
                a_z = min(
                    ratio(v.z_l, step.z_l, d.hl_mask), ratio(v.z_u, step.z_u, d.hu_mask),
                    ratio(v.z_bl, step.z_bl, d.xl_mask), ratio(v.z_bu, step.z_bu, d.xu_mask),
                )
                return a_s, a_z

            a_s, a_z = steplens(step)
            a_s *= st.tau
            a_z *= st.tau
            sig = (
                (v.s_l + a_s * step.s_l) @ (v.z_l + a_z * step.z_l)
                + (v.s_u + a_s * step.s_u) @ (v.z_u + a_z * step.z_u)
                + (v.s_bl + a_s * step.s_bl) @ (v.z_bl + a_z * step.z_bl)
                + (v.s_bu + a_s * step.s_bu) @ (v.z_bu + a_z * step.z_bu)
            ) / (info.mu * max(bcount, 1))
            sig = min(max(sig, 0.0), 1.0) ** 3

            # corrector (solver.hpp:755-769)
            sm = sig * info.mu
            res.s_l = res.s_l + np.where(d.hl_mask, -step.s_l * step.z_l + sm, 0.0)
            res.s_u = res.s_u + np.where(d.hu_mask, -step.s_u * step.z_u + sm, 0.0)
            res.s_bl = res.s_bl + np.where(d.xl_mask, -step.s_bl * step.z_bl + sm, 0.0)
            res.s_bu = res.s_bu + np.where(d.xu_mask, -step.s_bu * step.z_bu + sm, 0.0)
            step, _ = kkt.solve(res)
            a_s, a_z = steplens(step)
            primal_step = a_s * st.tau
            dual_step = a_z * st.tau

            v.x = v.x + primal_step * step.x
            v.y = v.y + dual_step * step.y
            for zn in ("z_l", "z_u", "z_bl", "z_bu"):
                setattr(v, zn, getattr(v, zn) + dual_step * getattr(step, zn))
            for sn in ("s_l", "s_u", "s_bl", "s_bu"):
                setattr(v, sn, getattr(v, sn) + primal_step * getattr(step, sn))

            mu_prev = info.mu
            info.mu = calc_mu(v)
            mu_rate = max(0.0, (mu_prev - info.mu) / mu_prev) if mu_prev else 0.0
            info.sigma, info.primal_step, info.dual_step = sig, primal_step, dual_step
        else:
            step, _ = kkt.solve(res)
            v.x = v.x + step.x
            v.y = v.y + step.y
            info.primal_step = info.dual_step = 1.0
            mu_rate = None  # equality-only uses fixed factors below

        prev_primal_res, prev_dual_res = info.primal_res, info.dual_res
        info.prev_primal_res, info.prev_dual_res = prev_primal_res, prev_dual_res
        res_nr = residuals_nr()

        # proximal updates (solver.hpp:794-829 / 831-877)
        dual_prog = (
            info.dual_res < 0.95 * prev_dual_res
            or info.dual_res < st.eps_abs or info.dual_res_rel < st.eps_rel
            or (has_cone and info.rho == st.reg_finetune_lower_limit
                and reg["dual_prox_inf"] < st.infeasibility_threshold)
        )
        if has_cone:
            fast = max(reg_limit, (1.0 - mu_rate) * info.rho)
            slow_ok = info.iter < 5 or reg["dual_prox_inf"] < st.infeasibility_threshold
            slow = max(reg_limit, (1.0 - 0.666 * mu_rate) * info.rho) if slow_ok else info.rho
        else:
            fast = max(reg_limit, 0.1 * info.rho)
            slow_ok = info.iter < 5 or reg["dual_prox_inf"] < st.infeasibility_threshold
            slow = max(reg_limit, 0.5 * info.rho) if slow_ok else info.rho
        if dual_prog:
            prox.x = v.x.copy()
            info.rho = fast
        else:
            info.rho = slow
            info.no_primal_update += 1

        primal_prog = (
            info.primal_res < 0.95 * prev_primal_res
            or info.primal_res < st.eps_abs or info.primal_res_rel < st.eps_rel
            or (has_cone and info.delta == st.reg_finetune_lower_limit
                and reg["primal_prox_inf"] < st.infeasibility_threshold)
        )
        if has_cone:
            dfast = max(reg_limit, (1.0 - mu_rate) * info.delta)
            dslow_ok = info.iter < 5 or reg["primal_prox_inf"] < st.infeasibility_threshold
            dslow = max(reg_limit, (1.0 - 0.666 * mu_rate) * info.delta) if dslow_ok else info.delta
        else:
            dfast = max(reg_limit, 0.1 * info.delta)
            dslow_ok = info.iter < 5 or reg["primal_prox_inf"] < st.infeasibility_threshold
            dslow = max(reg_limit, 0.5 * info.delta) if dslow_ok else info.delta
        if primal_prog:
            if has_cone:
                prox.y, prox.z_l, prox.z_u = v.y.copy(), v.z_l.copy(), v.z_u.copy()
                prox.z_bl, prox.z_bu = v.z_bl.copy(), v.z_bu.copy()
            else:
                prox.y = v.y.copy()
            info.delta = dfast
        else:
            info.delta = dslow
            info.no_dual_update += 1

        if verbose:
            print(
                f"{info.iter:3d}  {info.primal_obj: .5e}  {info.primal_res:.3e}"
                f"  {info.dual_res:.3e}  {info.mu:.3e}"
            )
    else:
        status = int(Status.MAX_ITER_REACHED)

    info.status = status
    result = _finalize_host(d, sc, v, info)

    # Post-hoc certificate search (no reference analog): an infeasible
    # problem can reach max_iter at a frozen proximal equilibrium where the
    # stall counters never trip — e.g. once the regularization floor makes
    # primal_prox_inf collapse.  Try, in order: the proximal drift, the
    # violation residuals of the final iterate, and the phase-1 feasibility
    # QP.  Only a ray that *validates* as a Farkas certificate changes the
    # status; the certificate is returned in (y, z_l, z_u, z_bl, z_bu).
    if status == int(Status.MAX_ITER_REACHED) and settings.verify_certificates:
        def _try(ray, check_sup=True):
            if ray is None:
                return False
            eq, negq, sup = _primal_ray_quality(data, *ray)
            ok = eq <= _CERT_EQ_TOL and negq <= _CERT_NEG_TOL
            if check_sup:
                ok = ok and sup <= -_CERT_SUP_TOL
            if ok:
                nrm = max(_inf(r) for r in ray)
                result.y, result.z_l, result.z_u, result.z_bl, result.z_bu = (
                    r / nrm for r in ray
                )
                result.info.status = int(Status.PRIMAL_INFEASIBLE)
                return True
            return False

        eqd, coned, objd = _farkas_dual_quality(data, sc, v, prox)
        if _try(_drift_primal_ray(data, sc, v, prox)):
            pass
        elif (eqd <= _CERT_EQ_TOL and coned <= _CERT_NEG_TOL
              and objd <= -_CERT_SUP_TOL):
            result.info.status = int(Status.DUAL_INFEASIBLE)
        elif _try(_violation_primal_ray(data, result.x)):
            pass
        else:
            # phase-1: the minimal-violation magnitude replaces the sup
            # check (sup ~ -violation^2/|rhs| is too scale-sensitive when
            # the infeasibility margin is small relative to the data)
            # gate: 1e2*eps_abs sits ~100x above phase-1 solver noise on
            # feasible problems while the genuinely-infeasible corpus
            # instances show viol_rel >= 7.9e-6
            ray, viol_rel = _phase1_certificate(data, settings)
            if viol_rel > 1e2 * settings.eps_abs:
                _try(ray, check_sup=False)

    _fill_times()
    return result


def _finalize_host(d: HostData, sc: HostScaling, v: _Vars, info: HostInfo) -> HostResult:
    """Unscale + restore (solver.hpp:1205-1259)."""
    c_inv = 1.0 / sc.c
    x = v.x * sc.d_x
    y = v.y * sc.d_y * c_inv
    z_l = v.z_l * sc.d_z * c_inv
    z_u = v.z_u * sc.d_z * c_inv
    s_l = np.where(z_l == 0, PIQP_INF, v.s_l / np.where(sc.d_z == 0, 1, sc.d_z))
    s_u = np.where(z_u == 0, PIQP_INF, v.s_u / np.where(sc.d_z == 0, 1, sc.d_z))
    z_bl = np.where(d.xl_mask, v.z_bl * sc.d_b * c_inv, 0.0)
    z_bu = np.where(d.xu_mask, v.z_bu * sc.d_b * c_inv, 0.0)
    s_bl = np.where(d.xl_mask, v.s_bl / sc.d_b, PIQP_INF)
    s_bu = np.where(d.xu_mask, v.s_bu / sc.d_b, PIQP_INF)
    return HostResult(x, y, z_l, z_u, z_bl, z_bu, s_l, s_u, s_bl, s_bu, info)


def solve_sparse_host(
    P, c, A=None, b=None, G=None, h_l=None, h_u=None, x_l=None, x_u=None,
    settings: Settings = Settings(), verbose: bool = False, warm=None,
    kkt_mode: str = "auto",
) -> HostResult:
    """One-shot host sparse solve.  ``kkt_mode`` selects the KKT
    elimination level ("auto" | "full" | "eq" | "ineq" | "cond" — the
    reference's KKTMode, sparse/kkt.hpp); "auto" picks full-vs-cond by
    structural nnz."""
    return solve_host(
        prepare_sparse(P, c, A, b, G, h_l, h_u, x_l, x_u), settings, verbose,
        warm, kkt_mode
    )
