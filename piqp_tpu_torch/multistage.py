"""Multistage (block-tridiagonal + arrow) KKT backend, batched
(``piqp_tpu/multistage.py``; reference sparse::MultistageKKT,
multistage_kkt.hpp).

QPs whose variables split into stages x = (x_0 ... x_{T-1}, g) with
nearest-neighbour coupling plus a global "arrow" block g keep a cost linear
in the horizon T.  Every field of :class:`StageQPData` carries a leading
problem dimension B, and every block operation of the JAX package's
stage-batched einsums carries it too.

The condensed matrix K = P + diag(x_reg) + A'A/delta + G'WG is block
tridiagonal with an arrow; it is factored by one of three schemes
(``_use_cr``, pinned by the tests):

- T < 16: the reference's sequential block Cholesky recursion
  (factor_kkt, multistage_kkt.hpp:1253-1352), a Python loop over stages
  (``lax.scan`` in the JAX package) with the library Cholesky and
  triangular solves;
- 16 <= T <= 256: block cyclic reduction, log2(T) levels, each of which
  factors all odd diagonal blocks of every problem at once;
- T > 256: the two-level chunked scheme, ~sqrt(T) chunk interiors factored
  as one batch (by cyclic reduction when they are 16 stages or longer)
  and a sequential chain over the chunk separators.

``Settings.pallas_kernels`` (``inverse`` below) picks the cyclic-reduction
level's representation: with it, each level is the 5-tuple (Lo, Lo_inv,
X1, X2, XE) from ONE launch of K2 (``ops.chol_inv.cholesky_inverse_apply``,
the hand-written kernel on CUDA) over all odd blocks of the batch, and the
back substitution uses products against Lo_inv; without it, the 4-tuple
(Lo, X1, X2, XE) from the library Cholesky and triangular solves.

The IPM core plugs this in through the dispatched ops (matvecs, Ruiz,
precompute, factor, condensed_solve_x).  Each block function works on
the stages its data holds (``StageQPData.owned``: all of them here) and
joins the holders' pieces through three hooks, which
``parallel.horizon`` registers as collectives for data that holds one
rank's stages.  Construction, from stage blocks or from a general sparse
QP by host-side structure detection, is the dense entry's twin: each raw
field is staged once on the host and copied once, and the masked
representation is made on the device (``_canonical``).
"""

from __future__ import annotations

import dataclasses
from functools import singledispatch
from typing import Optional

import numpy as np
import torch

from . import kkt as kkt_mod
from . import ruiz as ruiz_mod
from .ops import matvec as mv
from .ops.chol_inv import cholesky_inverse_apply
from .ops.ruiz_norms import stage_layout, stage_norms, stage_scale
from .types import QPData, Scaling, canonical_bounds
from .utils.profiling import annotate


@dataclasses.dataclass
class StageQPData:
    """Stage-structured problem data, B problems of one shape.

    Flat layout: x = [x_0, ..., x_{T-1}, g], n = T*D + Da; constraint rows
    are bucketed by stage (bucket j touches stages j, j+1 and the arrow):
    p = T*ra, m = T*rg.  The flat fields follow the QPData conventions so
    the IPM core runs unchanged; the blocks replace P, A and G:

      Pd[b, i]   = P[stage i, stage i]      (B, T, D, D), full symmetric
      Psub[b, i] = P[stage i+1, stage i]    (B, T, D, D), Psub[:, T-1] = 0
      Pa[b, i]   = P[g, stage i]            (B, T, Da, D)
      Pc[b]      = P[g, g]                  (B, Da, Da)
      A1[b, j]   = A[bucket j, stage j]     (B, T, ra, D)
      A2[b, j]   = A[bucket j, stage j+1]   (B, T, ra, D), A2[:, T-1] = 0
      Ag[b, j]   = A[bucket j, g]           (B, T, ra, Da)
      G1, G2, Gg analogous                  (B, T, rg, *)
    """

    c: torch.Tensor
    b: torch.Tensor
    h_l: torch.Tensor
    h_u: torch.Tensor
    x_l: torch.Tensor
    x_u: torch.Tensor
    x_b_scaling: torch.Tensor
    hl_mask: torch.Tensor
    hu_mask: torch.Tensor
    xl_mask: torch.Tensor
    xu_mask: torch.Tensor

    Pd: torch.Tensor
    Psub: torch.Tensor
    Pa: torch.Tensor
    Pc: torch.Tensor
    A1: torch.Tensor
    A2: torch.Tensor
    Ag: torch.Tensor
    G1: torch.Tensor
    G2: torch.Tensor
    Gg: torch.Tensor

    @property
    def B(self) -> int:
        return self.c.shape[0]

    @property
    def T(self) -> int:
        return self.Pd.shape[-3]

    @property
    def D(self) -> int:
        return self.Pd.shape[-1]

    @property
    def Da(self) -> int:
        return self.Pc.shape[-1]

    @property
    def ra(self) -> int:
        return self.A1.shape[-2]

    @property
    def rg(self) -> int:
        return self.G1.shape[-2]

    @property
    def n(self) -> int:
        return self.T * self.D + self.Da

    @property
    def p(self) -> int:
        return self.T * self.ra

    @property
    def m(self) -> int:
        return self.T * self.rg

    @property
    def owned(self) -> slice:
        """The stages whose blocks this object holds: all of them here; a
        ``parallel.ShardedStageQPData`` holds one rank's range."""
        return slice(0, self.T)


_BLOCKS = ("Pd", "Psub", "Pa", "Pc", "A1", "A2", "Ag", "G1", "G2", "Gg")
# the fields indexed by stage; all but Pc
STAGE_BLOCKS = tuple(k for k in _BLOCKS if k != "Pc")


def _split_x(data: StageQPData, x):
    """(B, n) -> stage part (B, T, D) and arrow part (B, Da)."""
    T, D = data.T, data.D
    return x[:, :T * D].reshape(x.shape[0], T, D), x[:, T * D:]


def _join_x(xs, xg):
    return torch.cat([xs.flatten(-2), xg], dim=-1)


def _shift_up(a, dim):
    """out[i] = a[i+1] along ``dim``, out[-1] = 0."""
    k = a.shape[dim]
    return torch.cat([a.narrow(dim, 1, k - 1), torch.zeros_like(a.narrow(dim, 0, 1))], dim)


def _shift_down(a, dim):
    """out[i] = a[i-1] along ``dim``, out[0] = 0."""
    k = a.shape[dim]
    return torch.cat([torch.zeros_like(a.narrow(dim, 0, 1)), a.narrow(dim, 0, k - 1)], dim)


def _finite(a) -> torch.Tensor:
    """(B,) True where every entry of problem b is finite."""
    return torch.isfinite(a).flatten(1).all(dim=1)


# ---------------------------------------------------------------------------
# stage holders: every block function below computes the rows of the stages
# its data holds (``data.owned``) and joins them through these three hooks.
# Data that holds the whole horizon is its only holder, and the hooks pass
# its pieces through unchanged; ``parallel.horizon`` registers collectives
# for data that holds one rank's stages.
# ---------------------------------------------------------------------------

@singledispatch
def gather_pieces(data, pieces: tuple) -> tuple:
    """Every holder's ``pieces`` (problems on the leading dimension), each
    stacked over the holders in stage order: (holders, B, ...)."""
    return tuple(p[None] for p in pieces)


@singledispatch
def prev_pieces(data, pieces: tuple) -> tuple:
    """The ``pieces`` of the holder of the stages before this one's (zeros
    for the first holder)."""
    return tuple(torch.zeros_like(p) for p in pieces)


@singledispatch
def sum_pieces(data, pieces: tuple) -> tuple:
    """Each of ``pieces``, per-stage terms (B, Tl, ...), summed over every
    stage of the horizon in stage order."""
    return tuple(p.sum(dim=1) for p in pieces)


def _joined(parts, spill=None, combine=torch.add):
    """The whole horizon's rows (B, T, k) from every holder's owned rows
    (holders, B, Tl, k) in stage order: each holder's ``spill`` (holders,
    B, k), its last stage's share of the next stage, is combined into the
    next holder's first stage (the last holder's falls off the horizon)."""
    if parts.shape[0] == 1:
        return parts[0]
    Tl = parts.shape[2]
    rows = torch.cat(tuple(parts), dim=1)
    if spill is not None:
        rows[:, Tl::Tl] = combine(rows[:, Tl::Tl], spill[:-1].movedim(0, 1))
    return rows


def _shift_in(a, head):
    """out[i] = a[i-1] along the stage dimension 1, out[0] = ``head`` (the
    previous holder's last ``a``)."""
    return torch.cat([head[:, None], a[:, :-1]], dim=1)


# ---------------------------------------------------------------------------
# structured matvecs (multistage_kkt.hpp:1354-1706 as batched einsums)
# ---------------------------------------------------------------------------

def _owned_x(data: StageQPData, x):
    """x's owned stages (B, Tl, D), the stages after them (zero past the
    horizon) and the arrow part, a copy a stage (B, Tl, Da): every product
    is then one a stage."""
    xs, xg = _split_x(data, x)
    own = data.owned
    xo = xs[:, own]
    return xo, _shift_up(xs, 1)[:, own], xg[:, None].expand(-1, xo.shape[1], -1)


@mv.P_x.register
def _(data: StageQPData, x):
    xo, x_next, xg = _owned_x(data, x)
    t = _mv(data.Psub, xo)  # P[i+1, i] x_i, a row of stage i+1
    u = _mv(data.Pd, xo)
    u = u + _mv(data.Psub.mT, x_next)
    u = u + _mv(data.Pa.mT, xg)
    u = u + _shift_down(t, 1)  # last: the first owned stage's share comes in the join
    u, t, yg = gather_pieces(data, (u, t[:, -1], _mv(data.Pa, xo)))
    return _join_x(_joined(u, t), _joined(yg).sum(dim=1) + _mv(data.Pc, xg[:, 0]))


@mv.P_diag.register
def _(data: StageQPData):
    d, = gather_pieces(data, (torch.diagonal(data.Pd, dim1=-2, dim2=-1),))
    return torch.cat([_joined(d).flatten(1), torch.diagonal(data.Pc, dim1=-2, dim2=-1)], dim=-1)


def _stage_rows_x(M1, M2, Mg, data, x):
    xo, x_next, xg = _owned_x(data, x)
    ys, = gather_pieces(data, (_mv(M1, xo) + _mv(M2, x_next) + _mv(Mg, xg),))
    return _joined(ys).flatten(1)


def _stage_rows_T(M1, M2, Mg, data, y):
    ys = y.reshape(y.shape[0], data.T, M1.shape[2])[:, data.owned]
    t = _mv(M2.mT, ys)  # a row of stage j+1
    us = _mv(M1.mT, ys)
    us = us + _shift_down(t, 1)
    us, t, ug = gather_pieces(data, (us, t[:, -1], _mv(Mg.mT, ys)))
    return _join_x(_joined(us, t), _joined(ug).sum(dim=1))


@mv.A_x.register
def _(data: StageQPData, x):
    return _stage_rows_x(data.A1, data.A2, data.Ag, data, x)


@mv.AT_y.register
def _(data: StageQPData, y):
    return _stage_rows_T(data.A1, data.A2, data.Ag, data, y)


@mv.G_x.register
def _(data: StageQPData, x):
    return _stage_rows_x(data.G1, data.G2, data.Gg, data, x)


@mv.GT_z.register
def _(data: StageQPData, z):
    return _stage_rows_T(data.G1, data.G2, data.Gg, data, z)


@mv.abs_data.register
def _(data: StageQPData):
    return dataclasses.replace(data, **{k: getattr(data, k).abs() for k in _BLOCKS})


@kkt_mod.precompute.register
def _(data: StageQPData, mixed: bool = False):
    """Mixed precision: float32 copies of the stage blocks (``data32``),
    made once outside the IPM loop, for the float32 phase's matvecs and
    block assembly."""
    if not mixed:
        return None
    return {"data32": dataclasses.replace(data, **{
        k: getattr(data, k).to(torch.float32) for k in _BLOCKS
    })}


# ---------------------------------------------------------------------------
# block assembly (block_syrk, multistage_kkt.hpp:820-994)
# ---------------------------------------------------------------------------

def _assemble_owned(data: StageQPData, ks):
    """Blockwise K = P + diag(x_reg) + (1/delta_reg) A'A + G' W G over the
    owned stages: (Kd, Ksub, Ka, Kc, E_first) of shapes (B, Tl, D, D),
    (B, Tl, D, D), (B, Tl, Da, D), (B, Da, Da) and (B, D, D).  The terms
    that the stage before the owned range contributes to its first stage,
    and E_first = K[first owned stage, the stage before it], come from the
    previous holder (``prev_pieces``); Kc's stage sums are summed over the
    holders."""
    B, T, rg = data.B, data.T, data.rg
    own = data.owned
    dr_inv = (1.0 / ks.delta_reg)[:, None, None, None]
    W = (1.0 / ks.z_reg_fact).reshape(B, T, rg)[:, own, :, None]
    xreg_s, xreg_g = _split_x(data, ks.x_reg)
    A1, A2, Ag, G1, G2, Gg = data.A1, data.A2, data.Ag, data.G1, data.G2, data.Gg
    GW1, GW2, GWg = G1 * W, G2 * W, Gg * W
    ein = torch.einsum

    # the terms that fall on the next stage, and the sub-diagonal blocks
    AA2 = dr_inv * ein("btri,btrj->btij", A2, A2)
    GG2 = ein("btri,btrj->btij", GW2, G2)
    AgA2 = dr_inv * ein("btra,btrd->btad", Ag, A2)
    GgG2 = ein("btra,btrd->btad", GWg, G2)
    Ksub = data.Psub + dr_inv * ein("btri,btrj->btij", A2, A1)
    Ksub = Ksub + ein("btri,btrj->btij", GW2, G1)
    hAA2, hGG2, hAgA2, hGgG2, E_first = prev_pieces(
        data, (AA2[:, -1], GG2[:, -1], AgA2[:, -1], GgG2[:, -1], Ksub[:, -1]))

    Kd = data.Pd + torch.diag_embed(xreg_s[:, own])
    Kd = Kd + dr_inv * ein("btri,btrj->btij", A1, A1)
    Kd = Kd + _shift_in(AA2, hAA2)
    Kd = Kd + ein("btri,btrj->btij", GW1, G1)
    Kd = Kd + _shift_in(GG2, hGG2)

    Ka = data.Pa + dr_inv * ein("btra,btrd->btad", Ag, A1)
    Ka = Ka + _shift_in(AgA2, hAgA2)
    Ka = Ka + ein("btra,btrd->btad", GWg, G1)
    Ka = Ka + _shift_in(GgG2, hGgG2)

    AgAg, GgGg = sum_pieces(data, (ein("btra,btrc->btac", Ag, Ag), ein("btra,btrc->btac", GWg, Gg)))
    Kc = data.Pc + torch.diag_embed(xreg_g)
    Kc = Kc + dr_inv[:, 0] * AgAg
    Kc = Kc + GgGg
    return Kd, Ksub, Ka, Kc, E_first


def _assemble_blocks(data: StageQPData, ks):
    """Blockwise K = P + diag(x_reg) + (1/delta_reg) A'A + G' W G:
    (Kd, Ksub, Ka, Kc) of shapes (B, T, D, D), (B, T, D, D), (B, T, Da, D),
    (B, Da, Da)."""
    return _assemble_owned(data, ks)[:4]


# ---------------------------------------------------------------------------
# sequential chain (factor_kkt and solve_llt_in_place,
# multistage_kkt.hpp:1253-1352 and 1709-1816)
# ---------------------------------------------------------------------------
#
# The chain functions take any leading batch dimensions (problems, and
# chunks in the chunked scheme): matrices are (..., T, r, c), vectors
# (..., T, r), and dimension -3 (-2 for vectors) is the stage axis.

def _chol(M):
    """Library Cholesky with the kernels' failure contract: NaN factors
    where M is not positive definite."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _tsolve(L, b, transpose=False):
    """Solve L x = b (or L' x = b) for vectors b (..., D)."""
    A = L.mT if transpose else L
    return torch.linalg.solve_triangular(A, b.unsqueeze(-1), upper=transpose).squeeze(-1)


def _mv(M, v):
    """M v for (..., m, k) M and (..., k) v, as a product and a sum over
    k.  The library's batched matrix-vector kernels change their summation
    with the batch count (on the card, and in float32 on the CPU); this
    form's bits do not, so a horizon split over holders computes the bits
    of one that is whole.  On an H100 it costs no round time the host
    clock can see against the library's products (``scripts/ms_rounds.py``)."""
    return (M * v.unsqueeze(-2)).sum(-1)


def chain_factor(Kd, Ksub, Ka):
    """Block Cholesky sweep of a block-tridiagonal chain with width-W
    coupling rows:

        L_i = chol(Kd_i - C_{i-1} C_{i-1}'),  C_i = Ksub_i L_i^{-T},
        F_i = (Ka_i - F_{i-1} C_{i-1}') L_i^{-T},  acc = sum_i F_i F_i'

    Kd, Ksub (..., T, D, D) with Ksub[..., i] = K[i+1, i] (the last one
    zero); Ka (..., T, W, D).  Returns (Ls, Cs, Fs, acc), acc (..., W, W)."""
    T, D = Kd.shape[-3], Kd.shape[-1]
    W = Ka.shape[-2]
    lead = Kd.shape[:-3]
    C_prev = Kd.new_zeros(lead + (D, D))
    F_prev = Kd.new_zeros(lead + (W, D))
    acc = Kd.new_zeros(lead + (W, W))
    Ls, Cs, Fs = [], [], []
    for i in range(T):
        L = _chol(Kd[..., i, :, :] - C_prev @ C_prev.mT)
        C = torch.linalg.solve_triangular(L, Ksub[..., i, :, :].mT, upper=False).mT
        F = torch.linalg.solve_triangular(
            L, (Ka[..., i, :, :] - F_prev @ C_prev.mT).mT, upper=False).mT
        acc = acc + F @ F.mT
        Ls.append(L)
        Cs.append(C)
        Fs.append(F)
        C_prev, F_prev = C, F
    return torch.stack(Ls, -3), torch.stack(Cs, -3), torch.stack(Fs, -3), acc


def chain_fwd(Ls, Cs, Fs, vs):
    """Forward sweep w = L^-1 v over the chain; returns (ws, gacc) with
    gacc = sum_i F_i w_i, the coupling rows' share of the right-hand side."""
    T, D = Ls.shape[-3], Ls.shape[-1]
    C_prevs = _shift_down(Cs, -3)
    v_prev = vs.new_zeros(vs.shape[:-2] + (D,))
    gacc = vs.new_zeros(vs.shape[:-2] + (Fs.shape[-2],))
    ws = []
    for i in range(T):
        u = vs[..., i, :] - _mv(C_prevs[..., i, :, :], v_prev)
        w = _tsolve(Ls[..., i, :, :], u)
        gacc = gacc + _mv(Fs[..., i, :, :], w)
        ws.append(w)
        v_prev = w
    return torch.stack(ws, -2), gacc


def chain_bwd(Ls, Cs, Fs, ws, xa):
    """Backward sweep x_i = L_i^{-T} (w_i - C_i' x_{i+1} - F_i' xa) given
    the solved coupling variables xa (..., W)."""
    T, D = Ls.shape[-3], Ls.shape[-1]
    x_next = ws.new_zeros(ws.shape[:-2] + (D,))
    xs = [None] * T
    for i in reversed(range(T)):
        u = (ws[..., i, :] - _mv(Cs[..., i, :, :].mT, x_next)
             - _mv(Fs[..., i, :, :].mT, xa))
        x_next = _tsolve(Ls[..., i, :, :], u, transpose=True)
        xs[i] = x_next
    return torch.stack(xs, -2)


# ---------------------------------------------------------------------------
# block cyclic reduction
# ---------------------------------------------------------------------------
#
# Even-odd elimination: each level factors all odd diagonal blocks at once,
# substitutes them out (the reduced system is again block tridiagonal +
# arrow over the evens) and recurses, so the sequential depth is log2(T).
# Scheme selection: T < 16 chain, 16 <= T <= 256 cyclic reduction, T > 256
# chunked (the JAX package bounds T because its compile time grows with
# the number of distinct levels; the limits are kept for parity).

_CR_MIN_T = 16
_CR_MAX_T = 256
_CHUNK_MIN_T = 16


def _use_cr(T: int) -> bool:
    return _CR_MIN_T <= T <= _CR_MAX_T


def _bsolve(L, B):
    """Batched cho_solve with lower factors L (..., D, D) on B (..., D, r)."""
    X = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, X, upper=True)


def _chol_inv_apply_flat(Do, RHS):
    """K2 over every odd block of the level at once: the leading
    dimensions (problems, chunks, blocks) are flattened into one (N, D, D)
    launch."""
    lead, D, R = Do.shape[:-2], Do.shape[-1], RHS.shape[-1]
    Lo, Lo_inv, Y = cholesky_inverse_apply(
        Do.reshape(-1, D, D).contiguous(), RHS.reshape(-1, D, R).contiguous()
    )
    return Lo.reshape(lead + (D, D)), Lo_inv.reshape(lead + (D, D)), Y.reshape(lead + (D, R))


def cr_chain_factor(Kd, Ksub, Ka, inverse: bool = False):
    """Cyclic-reduction factorization of a block-tridiagonal chain with
    width-W coupling rows, the log-depth analog of ``chain_factor``.

    Returns ((levels, base), Sacc, ok): levels[l] holds the odd-block
    factors and the substitution operators X1 = Do^-1 S_in,
    X2 = Do^-1 S_out', XE = Do^-1 Eo' of level l, as (Lo, X1, X2, XE) or,
    with ``inverse``, (Lo, Lo_inv, X1, X2, XE) from one K2 launch; base is
    the 1-stage chain (Ls, Cs, Fs); Sacc (..., W, W) is the chain's Schur
    contribution onto the coupling rows; ok (B,) per problem."""
    T, D = Kd.shape[-3], Kd.shape[-1]
    W = Ka.shape[-2]
    Sacc = Kd.new_zeros(Kd.shape[:-3] + (W, W))
    ok = torch.ones(Kd.shape[0], dtype=torch.bool, device=Kd.device)
    levels = []
    ein = torch.einsum
    while T > 1:
        # one level: K2's launch (or the library factor) and the Schur updates
        with annotate("piqp.ms.cr_level"):
            H_o = T // 2
            Do, De = Kd[..., 1::2, :, :], Kd[..., 0::2, :, :]
            S_in = Ksub[..., 0::2, :, :][..., :H_o, :, :]  # K[j, j-1] for odd j
            S_out = Ksub[..., 1::2, :, :]  # K[j+1, j]
            Eo, Ee = Ka[..., 1::2, :, :], Ka[..., 0::2, :, :]

            if inverse:
                RHS = torch.cat([S_in, S_out.mT, Eo.mT], dim=-1)  # (..., H_o, D, 2D + W)
                Lo, Lo_inv, Y = _chol_inv_apply_flat(Do, RHS)
                ok = ok & _finite(Lo) & _finite(Lo_inv)
                X1, X2, XE = Y[..., :D], Y[..., D:2 * D], Y[..., 2 * D:]
                levels.append((Lo, Lo_inv, X1, X2, XE))
            else:
                Lo = _chol(Do)
                ok = ok & _finite(Lo)
                X1 = _bsolve(Lo, S_in)
                X2 = _bsolve(Lo, S_out.mT)
                XE = _bsolve(Lo, Eo.mT)
                levels.append((Lo, X1, X2, XE))

            left = ein("...kji,...kjl->...kil", S_in, X1)
            right = ein("...kij,...kjl->...kil", S_out, X2)
            leftE = ein("...kaj,...kjl->...kal", Eo, X1)
            rightE = ein("...kaj,...kjl->...kal", Eo, X2)
            sub = -ein("...kij,...kjl->...kil", S_out, X1)
            if T % 2 == 0:
                # the last odd stage's right coupling is zero (S_out = 0)
                Kd = De - left
                Kd[..., 1:, :, :] -= right[..., :-1, :, :]
                Ksub = sub
                Ka = Ee - leftE
                Ka[..., 1:, :, :] -= rightE[..., :-1, :, :]
            else:
                Kd = De.clone()
                Kd[..., :H_o, :, :] -= left
                Kd[..., 1:, :, :] -= right
                Ksub = torch.cat([sub, torch.zeros_like(sub[..., :1, :, :])], dim=-3)
                Ka = Ee.clone()
                Ka[..., :H_o, :, :] -= leftE
                Ka[..., 1:, :, :] -= rightE
            Sacc = Sacc + ein("...kaj,...kjb->...ab", Eo, XE)
            T = T - H_o

    Ls, Cs, Fs, acc = chain_factor(Kd, Ksub, Ka)
    ok = ok & _finite(Ls)
    return (tuple(levels), (Ls, Cs, Fs)), Sacc + acc, ok


def cr_chain_fwd(factors, vs):
    """Forward cyclic-reduction sweep: the levels condense the right-hand
    side onto the evens, then the 1-stage base sweep.  Returns (state,
    gacc); ``state`` (per-level odd right-hand sides, base ws) feeds
    ``cr_chain_bwd``."""
    with annotate("piqp.ms.cr_sweep"):
        levels, (Ls, Cs, Fs) = factors
        gacc = vs.new_zeros(vs.shape[:-2] + (Fs.shape[-2],))
        v_odds = []
        for lev in levels:
            X1, X2, XE = lev[-3], lev[-2], lev[-1]
            T = vs.shape[-2]
            H_o = T // 2
            v_o, v_e = vs[..., 1::2, :], vs[..., 0::2, :]
            v_odds.append(v_o)
            lv = _mv(X1.mT, v_o)
            rv = _mv(X2.mT, v_o)
            if T % 2 == 0:
                vs = v_e - lv
                vs[..., 1:, :] -= rv[..., :-1, :]
            else:
                vs = v_e.clone()
                vs[..., :H_o, :] -= lv
                vs[..., 1:, :] -= rv
            gacc = gacc + _mv(XE.flatten(-3, -2).mT, v_o.flatten(-2))  # sum over the odd blocks
        ws, gb = chain_fwd(Ls, Cs, Fs, vs)
        return (tuple(v_odds), ws), gacc + gb


def cr_chain_bwd(factors, state, xa):
    """Backward cyclic-reduction sweep given the coupling variables xa
    (..., W): the base sweep, then the levels back-substitute the odd
    stages."""
    with annotate("piqp.ms.cr_sweep"):
        levels, (Ls, Cs, Fs) = factors
        v_odds, ws = state
        x = chain_bwd(Ls, Cs, Fs, ws, xa)
        for lev, v_o in zip(reversed(levels), reversed(v_odds)):
            X1, X2, XE = lev[-3], lev[-2], lev[-1]
            x_e = x
            H_o = v_o.shape[-2]
            T = H_o + x_e.shape[-2]
            if T % 2 == 0:
                x_next = torch.cat([x_e[..., 1:, :], torch.zeros_like(x_e[..., :1, :])], dim=-2)
            else:
                x_next = x_e[..., 1:, :]
            if len(lev) == 5:  # explicit inverse: products against Lo_inv
                x_o = _mv(lev[1].mT, _mv(lev[1], v_o))
            else:
                x_o = _bsolve(lev[0], v_o.unsqueeze(-1)).squeeze(-1)
            x_o = x_o - _mv(X1, x_e[..., :H_o, :])
            x_o = x_o - _mv(X2, x_next)
            x_o = x_o - _mv(XE, xa[..., None, :].expand(XE.shape[:-2] + xa.shape[-1:]))
            x = x_e.new_zeros(x_e.shape[:-2] + (T, x_e.shape[-1]))
            x[..., 0::2, :] = x_e
            x[..., 1::2, :] = x_o
        return x


def cr_factor(Kd, Ksub, Ka, Kc, inverse: bool = False):
    """Cyclic reduction of the whole tridiagonal + arrow system, then the
    Cholesky factor of the arrow's Schur complement."""
    (levels, (Ls, Cs, Fs)), Sacc, ok = cr_chain_factor(Kd, Ksub, Ka, inverse)
    Lc = _chol(Kc - Sacc)
    return (levels, (Ls, Cs, Fs, Lc)), ok & _finite(Lc)


def cr_solve(factors, vs, vg):
    """Levels down, arrow solve, the same levels up."""
    levels, (Ls, Cs, Fs, Lc) = factors
    chain = (levels, (Ls, Cs, Fs))
    state, gacc = cr_chain_fwd(chain, vs)
    xg = _tsolve(Lc, _tsolve(Lc, vg - gacc), transpose=True)
    return cr_chain_bwd(chain, state, xg), xg


# ---------------------------------------------------------------------------
# two-level chunked factorization (long horizons)
# ---------------------------------------------------------------------------

def _chunk_count(T: int):
    """Largest divisor C of T with C*C <= T and T/C >= 2; None when
    chunking is not worthwhile."""
    if T < _CHUNK_MIN_T:
        return None
    best = None
    c = 1
    while c * c <= T:
        if T % c == 0 and T // c >= 2:
            best = c
        c += 1
    return best if best and best > 1 else None


def _next_chunkable(T: int) -> int:
    """Smallest T' >= T whose chunk split exists (T itself when short)."""
    if T < _CHUNK_MIN_T:
        return T
    Tp = T
    while _chunk_count(Tp) is None:
        Tp += 1
    return Tp


def _all_chunks(t):
    """The gather of a process that holds every chunk: nothing to join."""
    return t


def _chunked_factor(Kd, Ksub, Ka, Kc, C: int, inverse: bool = False,
                    own: Optional[slice] = None, gather=_all_chunks, E_first=None):
    """C chunk interiors of Q - 1 stages, each coupled to its two boundary
    separators and the arrow (coupling width W = 2D + Da), factored as one
    (B, C) batch; then the C-stage chain of separators and the arrow.

    ``own`` is the contiguous range of chunks whose interiors this process
    factors (all C by default), and Kd, Ksub, Ka hold those chunks' stages
    (B, own chunks x Q, ...); E_first is K[their first stage, the stage
    before it] (None: zero, as for chunk 0).  ``gather`` joins per-chunk
    pieces across the chunks: here the tuple (Schur blocks (B, own chunks,
    W, W), the separators' Kd and Ka blocks, the owned interiors' flags
    (B,)) into the pieces of every chunk, in ``_chunked_solve`` a tensor
    (B, own chunks, ...) along dimension 1.  The single-device scheme owns
    every chunk and gathers nothing; the horizon-sharded one
    (``parallel.horizon``) owns its rank's chunks and gathers with
    ``torch.distributed``.  The separator chain is factored whole on every
    process from the gathered pieces."""
    B, D = Kd.shape[0], Kd.shape[-1]
    Da = Kc.shape[-1]
    own = slice(0, C) if own is None else own
    Cl = own.stop - own.start
    Q = Kd.shape[1] // Cl
    Qi = Q - 1
    W = 2 * D + Da

    KdC = Kd.reshape(B, Cl, Q, D, D)
    KsubC = Ksub.reshape(B, Cl, Q, D, D)
    KaC = Ka.reshape(B, Cl, Q, Da, D)

    # chunk k's coupling to the previous separator: the previous chunk's
    # last sub-diagonal block (zero for chunk 0)
    E_prev = _shift_down(KsubC[:, :, Q - 1], 1)
    if E_first is not None:
        E_prev[:, 0] = E_first
    Ea = Kd.new_zeros((B, Cl, Qi, W, D))
    Ea[:, :, :, 2 * D:, :] = KaC[:, :, :Qi]
    Ea[:, :, 0, :D, :] = E_prev.mT
    Ea[:, :, Qi - 1, D:2 * D, :] = KsubC[:, :, Qi - 1]

    Ksub_int = KsubC[:, :, :Qi].clone()
    Ksub_int[:, :, Qi - 1] = 0.0
    if _use_cr(Qi):
        local, Sacc, ok = cr_chain_factor(KdC[:, :, :Qi], Ksub_int, Ea, inverse)
    else:
        Ls, Cs, Fs, Sacc = chain_factor(KdC[:, :, :Qi], Ksub_int, Ea)
        local = (Ls, Cs, Fs)
        ok = _finite(Ls)

    Sacc, sKd, sKa, ok = gather((Sacc, KdC[:, :, Q - 1], KaC[:, :, Q - 1], ok))

    S_pp = Sacc[..., :D, :D]
    S_oo = Sacc[..., D:2 * D, D:2 * D]
    S_op = Sacc[..., D:2 * D, :D]
    S_ap = Sacc[..., 2 * D:, :D]
    S_ao = Sacc[..., 2 * D:, D:2 * D]
    S_aa = Sacc[..., 2 * D:, 2 * D:]

    cKd = sKd - S_oo - _shift_up(S_pp, 1)
    cKsub = -_shift_up(S_op, 1)
    cKa = sKa - S_ao - _shift_up(S_ap, 1)
    cKc = Kc - S_aa.sum(dim=1)

    cLs, cCs, cFs, cacc = chain_factor(cKd, cKsub, cKa)
    cLc = _chol(cKc - cacc)
    ok = ok & _finite(cLs) & _finite(cLc)
    return (local, cLs, cCs, cFs, cLc), ok


def _chunked_solve(factors, vs, vg, T, D, Da, own: Optional[slice] = None,
                   gather=_all_chunks):
    """Two-level sweeps with the factors of ``_chunked_factor`` (the same
    ``own`` and ``gather``): the owned interiors' forward sweeps, the
    separator chain's solve on the gathered reduced right-hand sides, the owned interiors' backward
    sweeps, and the interior x gathered whole."""
    local, cLs, cCs, cFs, cLc = factors
    cr = isinstance(local[0], tuple)  # (levels, base) vs (Ls, Cs, Fs)
    B = vs.shape[0]
    C = cLs.shape[-3]
    Q = T // C
    Qi = Q - 1
    own = slice(0, C) if own is None else own
    vsC = vs.reshape(B, C, Q, D)

    if cr:
        state, gacc = cr_chain_fwd(local, vsC[:, own, :Qi])
    else:
        Ls, Cs, Fs = local
        ws, gacc = chain_fwd(Ls, Cs, Fs, vsC[:, own, :Qi])
    gacc = gather(gacc)  # (B, C, W)

    c_rhs = vsC[:, :, Q - 1] - gacc[..., D:2 * D] - _shift_up(gacc[..., :D], 1)
    c_rhs_g = vg - gacc[..., 2 * D:].sum(dim=1)

    cws, cgacc = chain_fwd(cLs, cCs, cFs, c_rhs)
    xg = _tsolve(cLc, _tsolve(cLc, c_rhs_g - cgacc), transpose=True)
    x_sep = chain_bwd(cLs, cCs, cFs, cws, xg)  # (B, C, D)

    xa = torch.cat(
        [_shift_down(x_sep, 1), x_sep, xg[:, None, :].expand(B, C, Da)], dim=-1
    )[:, own]  # (B, own chunks, W)
    if cr:
        x_int = cr_chain_bwd(local, state, xa)
    else:
        x_int = chain_bwd(Ls, Cs, Fs, ws, xa)  # (B, own chunks, Qi, D)
    x_int = gather(x_int)
    xs = torch.cat([x_int, x_sep[:, :, None, :]], dim=2).reshape(B, T, D)
    return xs, xg


# ---------------------------------------------------------------------------
# factor / solve registrations
# ---------------------------------------------------------------------------

def _factor_blocks(data: StageQPData, ks, mixed: bool = False, pre=None):
    """The condensed blocks (Kd, Ksub, Ka, Kc, E_first) of
    ``_assemble_owned`` a factor starts from: ``mixed`` assembles them in
    float32 (from ``data32`` when precomputed)."""
    if not mixed:
        return _assemble_owned(data, ks)
    f32 = torch.float32
    src = pre.get("data32") if isinstance(pre, dict) else None
    if src is None:
        return tuple(k.to(f32) for k in _assemble_owned(data, ks))
    ks_f = dataclasses.replace(
        ks, x_reg=ks.x_reg.to(f32), z_reg_fact=ks.z_reg_fact.to(f32),
        delta_reg=ks.delta_reg.to(f32),
    )
    return _assemble_owned(src, ks_f)


@kkt_mod.factor.register
def _(data: StageQPData, ks, mixed: bool = False, pre=None, inverse: bool = True):
    """Block Cholesky of the tridiagonal + arrow condensed matrix by the
    scheme ``_use_cr``/``_chunk_count`` select for T.  ``mixed`` assembles
    and factors in float32 (from ``data32`` when precomputed);
    ``inverse`` routes every cyclic-reduction level through K2."""
    Kd, Ksub, Ka, Kc, _ = _factor_blocks(data, ks, mixed, pre)
    T = data.T
    C = _chunk_count(T)
    if _use_cr(T):
        factors, ok = cr_factor(Kd, Ksub, Ka, Kc, inverse)
    elif C is not None:
        factors, ok = _chunked_factor(Kd, Ksub, Ka, Kc, C, inverse)
    else:
        Ls, Cs, Fs, acc = chain_factor(Kd, Ksub, Ka)
        Lc = _chol(Kc - acc)
        factors, ok = (Ls, Cs, Fs, Lc), _finite(Ls) & _finite(Lc)
    return dataclasses.replace(ks, factor=factors), ok


def _last_leaf(tree):
    while isinstance(tree, tuple):
        tree = tree[-1]
    return tree


@kkt_mod.condensed_solve_x.register
def _(data: StageQPData, ks, v):
    """Forward/backward block sweeps (solve_llt_in_place,
    multistage_kkt.hpp:1709-1816) in the factor's precision."""
    F = ks.factor
    dt = _last_leaf(F).dtype
    vs, vg = _split_x(data, v.to(dt))
    T = data.T
    if _use_cr(T):
        xs, xg = cr_solve(F, vs, vg)
    elif _chunk_count(T) is not None:
        xs, xg = _chunked_solve(F, vs, vg, T, data.D, data.Da)
    else:
        Ls, Cs, Fs, Lc = F
        ws, gacc = chain_fwd(Ls, Cs, Fs, vs)
        xg = _tsolve(Lc, _tsolve(Lc, vg - gacc), transpose=True)
        xs = chain_bwd(Ls, Cs, Fs, ws, xg)
    return _join_x(xs, xg).to(v.dtype)


# ---------------------------------------------------------------------------
# stage Ruiz equilibration
# ---------------------------------------------------------------------------

def _stage_scalings(data: StageQPData, d):
    """The whole horizon's dx (B, T, D), dg (B, Da), dy (B, T, ra) and
    dz (B, T, rg), views of flat scalings d = [d_x | d_y | d_z | ...]."""
    B, T, D, n, p = data.B, data.T, data.D, data.n, data.p
    return (d[:, :T * D].view(B, T, D), d[:, T * D:n], d[:, n:n + p].view(B, T, data.ra),
            d[:, n + p:n + p + data.m].view(B, T, data.rg))


def _stage_col_norms(data: StageQPData, active, cost_only: bool = False):
    """Infinity norms (B, n + p + m) of the stage-structured KKT matrix, per
    problem, without x_b_scaling's column and P[g, g]'s, 0 where a problem
    is not ``active``: the owned stages' blocks read by
    ``ops.ruiz_norms.stage_norms`` (one kernel launch on CUDA), joined over
    the holders (the norms of P[i, i+1], A2[i] and G2[i] fall on stage
    i + 1).  ``cost_only``: P's column norms (B, n) alone."""
    blocks = tuple(getattr(data, k) for k in STAGE_BLOCKS)
    if cost_only:  # A's and G's blocks with no rows
        blocks = blocks[:3] + tuple(M[:, :, :0] for M in blocks[3:])
    own = data.owned
    out = stage_norms(blocks, active, own.start, data.T)
    if own.stop - own.start == data.T:
        return out  # the whole horizon: joined already
    B, Tl, D = data.B, own.stop - own.start, data.D
    wx, Da, wy, wz = stage_layout(Tl, D, data.Da, blocks[3].shape[2], blocks[6].shape[2],
                                  own.stop < data.T)
    x, g, y, z = torch.split(out, [wx, Da, wy, wz], dim=1)
    spill = x[:, Tl * D:] if wx > Tl * D else torch.zeros_like(x[:, :D])
    x, spill, g, y, z = gather_pieces(data, (x[:, :Tl * D].view(B, Tl, D), spill, g,
                                             y.view(B, Tl, -1), z.view(B, Tl, -1)))
    return torch.cat([_joined(x, spill, torch.maximum).flatten(1), g.amax(dim=0),
                      _joined(y).flatten(1), _joined(z).flatten(1)], dim=1)


@ruiz_mod.equilibrate.register
def _equilibrate_stage(
    data: StageQPData, max_iter: int = 10, scale_cost: bool = False,
    epsilon: float = 1e-3,
):
    """Ruiz equilibration over the stage blocks: the dense algorithm
    (preconditioner.hpp:64-222) with blockwise norms, ``ruiz._equilibrate``'s
    pass loop.  Every norm and the early exit are per problem.  Each
    holder reads and scales its own stages' blocks; the norms are joined
    over the holders, so every holder computes the same scalings."""
    work = dataclasses.replace(data, **{k: ruiz_mod._copy(getattr(data, k)) for k in _BLOCKS})

    def scale(w, s, active):
        dx, dg, dy, dz = _stage_scalings(w, s)
        stage_scale(tuple(getattr(w, k) for k in STAGE_BLOCKS), dx, dg, dy, dz, active,
                    w.owned.start)
        on = active[:, None, None]
        w.Pc.copy_(torch.where(on, w.Pc * dg[:, :, None] * dg[:, None, :], w.Pc))

    def scale_p(w, gamma, active):
        for M in (w.Pd, w.Psub, w.Pa, w.Pc):
            ruiz_mod._scaled_by_cost(M, gamma, active)

    return ruiz_mod._equilibrate(work, _stage_col_norms, scale, scale_p, max_iter, scale_cost,
                                 epsilon)


@ruiz_mod.apply_scaling.register
def _apply_scaling_stage(data: StageQPData, s: Scaling):
    dx, dg, dy, dz = _stage_scalings(data, torch.cat([s.d_x, s.d_y, s.d_z], dim=1))
    blocks = {k: ruiz_mod._copy(getattr(data, k)) for k in STAGE_BLOCKS}
    stage_scale(tuple(blocks.values()), dx, dg, dy, dz, torch.ones_like(s.c, dtype=torch.bool),
                data.owned.start)
    c4, c3 = s.c[:, None, None, None], s.c[:, None, None]
    for k in ("Pd", "Psub", "Pa"):
        blocks[k] = c4 * blocks[k]
    return dataclasses.replace(
        data, **blocks, Pc=c3 * (data.Pc * dg[:, :, None] * dg[:, None, :]),
        x_b_scaling=data.x_b_scaling * s.d_b * s.d_x,
        c=s.c[:, None] * data.c * s.d_x,
        b=data.b * s.d_y, h_l=data.h_l * s.d_z, h_u=data.h_u * s.d_z,
        x_l=data.x_l * s.d_b, x_u=data.x_u * s.d_b,
    )


# ---------------------------------------------------------------------------
# construction and conversion
# ---------------------------------------------------------------------------

def _stage_arrays(Pd, Psub, Pa, Pc, c, A1=None, A2=None, Ag=None, b=None,
                  G1=None, G2=None, Gg=None, h_l=None, h_u=None, x_l=None,
                  x_u=None, np_dtype=np.float64) -> dict:
    """One problem's raw stage fields as numpy arrays of ``np_dtype`` (the
    keyword arguments of ``from_stage_blocks``): each omitted one filled,
    the vectors flat.  The masking is ``_canonical``'s, on the device."""
    Pd = np.asarray(Pd, np_dtype)
    T, D, _ = Pd.shape
    Pc = np.asarray(Pc, np_dtype) if Pc is not None else np.zeros((0, 0), np_dtype)
    Da = Pc.shape[0]
    ra = 0 if A1 is None else np.shape(A1)[1]
    rg = 0 if G1 is None else np.shape(G1)[1]
    n, p, m = T * D + Da, T * ra, T * rg

    def arr(M, shape, fill=0.0):
        if M is None:
            return np.full(shape, fill, np_dtype)
        M = np.asarray(M, np_dtype)
        return M.reshape(shape) if len(shape) == 1 else M

    return dict(
        Pd=Pd, Psub=arr(Psub, (T, D, D)), Pa=arr(Pa, (T, Da, D)), Pc=Pc,
        A1=arr(A1, (T, ra, D)), A2=arr(A2, (T, ra, D)), Ag=arr(Ag, (T, ra, Da)),
        G1=arr(G1, (T, rg, D)), G2=arr(G2, (T, rg, D)), Gg=arr(Gg, (T, rg, Da)),
        c=arr(c, (n,)), b=arr(b, (p,)), h_l=arr(h_l, (m,), -np.inf),
        h_u=arr(h_u, (m,), np.inf), x_l=arr(x_l, (n,), -np.inf), x_u=arr(x_u, (n,), np.inf),
    )


def _canonical(Pd, Psub, Pa, Pc, A1, A2, Ag, G1, G2, Gg, c, b, h_l, h_u, x_l,
               x_u) -> StageQPData:
    """The masked representation of staged (B, ...) stage fields on their
    device: the bounds by ``types.canonical_bounds``, the dead rows zeroed
    in G1, G2 and Gg, and the last stage's couplings Psub, A2 and G2
    zeroed (the staged tensors are the entry's own)."""
    h_l, h_u, x_l, x_u, hl_mask, hu_mask, xl_mask, xu_mask, dead = canonical_bounds(
        h_l, h_u, x_l, x_u)
    for M in (Psub, A2, G2):
        M[:, -1] = 0.0
    dead = dead.reshape(*G1.shape[:-1], 1)
    return StageQPData(
        c=c, b=b, h_l=h_l, h_u=h_u, x_l=x_l, x_u=x_u, x_b_scaling=torch.ones_like(c),
        hl_mask=hl_mask, hu_mask=hu_mask, xl_mask=xl_mask, xu_mask=xu_mask,
        Pd=Pd, Psub=Psub, Pa=Pa, Pc=Pc, A1=A1, A2=A2, Ag=Ag, G1=G1.masked_fill(dead, 0.0),
        G2=G2.masked_fill(dead, 0.0), Gg=Gg.masked_fill(dead, 0.0),
    )


def stage_data_from_arrays(arrays: list, dtype=torch.float64, device=None) -> StageQPData:
    """Per-problem raw arrays (``_stage_arrays``, one shape for all) as one
    batched StageQPData on ``device``: as in ``batch.prepare_batch``, each
    field stacked once into host staging and copied once (``batch._enter``),
    then ``_canonical`` on the device."""
    from .batch import _enter

    if not arrays:
        raise ValueError("no problems to stack")
    return _enter({k: [a[k] for a in arrays] for k in arrays[0]},
                  {k: v.shape for k, v in arrays[0].items()}, dtype, device, _canonical)


def from_stage_blocks(
    Pd, Psub, Pa, Pc, c, A1=None, A2=None, Ag=None, b=None,
    G1=None, G2=None, Gg=None, h_l=None, h_u=None, x_l=None, x_u=None,
    dtype=torch.float64, device=None,
) -> StageQPData:
    """One problem's StageQPData (B = 1) on ``device`` from numpy stage
    blocks."""
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    arrays = _stage_arrays(Pd, Psub, Pa, Pc, c, A1, A2, Ag, b, G1, G2, Gg,
                           h_l, h_u, x_l, x_u, np_dtype)
    return stage_data_from_arrays([arrays], dtype, device)


def _pad_t(a, extra: int, fill=0.0):
    """(B, T, ...) -> (B, T + extra, ...), the new stages all ``fill``."""
    return torch.cat([a, a.new_full((a.shape[0], extra) + a.shape[2:], fill)], dim=1)


def _pad_flat(v: dict, T: int, D: int, ra: int, rg: int, T_pad: int) -> dict:
    """The flat (B, ...) fields of ``v`` padded from T to T_pad stages, as
    ``pad_stages`` pads them: zero cost, unit x_b_scaling, no bounds on
    padded variables, padded inequality rows with the [-1, 1] bounds of a
    dead row."""
    extra = T_pad - T

    def pad_x(u, fill):  # flat x layout: [T*D stage coords, Da arrow coords]
        stage = _pad_t(u[:, :T * D].reshape(-1, T, D), extra, fill)
        return torch.cat([stage.flatten(1), u[:, T * D:]], dim=1)

    def pad_rows(u, r, fill):
        return _pad_t(u.reshape(-1, T, r), extra, fill).flatten(1) if r else u

    fills = dict(c=0.0, x_b_scaling=1.0, x_l=0.0, x_u=0.0, xl_mask=False, xu_mask=False)
    rows = dict(b=(ra, 0.0), h_l=(rg, -1.0), h_u=(rg, 1.0), hl_mask=(rg, True),
                hu_mask=(rg, True))
    return {k: pad_x(u, fills[k]) if k in fills else pad_rows(u, *rows[k])
            for k, u in v.items()}


def pad_stages(data: StageQPData, T_pad: int) -> StageQPData:
    """Append decoupled identity stages up to T_pad (``horizon.py:104-155``
    of the JAX package), on the data's device: P = I, no couplings, padded
    inequality rows with the benign [-1, 1] bounds of a dead row, so each
    padded stage is an isolated, already optimal x = 0."""
    T, D, B = data.T, data.D, data.B
    if T_pad < T:
        raise ValueError(f"T_pad={T_pad} < T={T}")
    if T_pad == T:
        return data
    extra = T_pad - T
    eye = torch.eye(D, dtype=data.Pd.dtype, device=data.Pd.device)
    flat = {f.name: getattr(data, f.name) for f in dataclasses.fields(StageQPData)
            if f.name not in _BLOCKS}
    return dataclasses.replace(
        data,
        Pd=torch.cat([data.Pd, eye.expand(B, extra, D, D)], dim=1),
        **{k: _pad_t(getattr(data, k), extra) for k in STAGE_BLOCKS if k != "Pd"},
        **_pad_flat(flat, T, D, data.ra, data.rg, T_pad),
    )


def to_dense(data: StageQPData) -> QPData:
    """The equivalent batched dense QPData (the tests' oracle), on the
    data's device."""
    T, D, ra, rg = data.T, data.D, data.ra, data.rg
    n = data.n
    host = {k: getattr(data, k).cpu().numpy() for k in _BLOCKS}
    Ps, As, Gs = [], [], []
    for bi in range(data.B):
        Pd, Psub, Pa, Pc = (host[k][bi] for k in ("Pd", "Psub", "Pa", "Pc"))
        P = np.zeros((n, n))
        for i in range(T):
            s = slice(i * D, (i + 1) * D)
            P[s, s] = Pd[i]
            if i + 1 < T:
                s2 = slice((i + 1) * D, (i + 2) * D)
                P[s2, s] = Psub[i]
                P[s, s2] = Psub[i].T
            P[T * D:, s] = Pa[i]
            P[s, T * D:] = Pa[i].T
        P[T * D:, T * D:] = Pc

        def expand(M1, M2, Mg, r):
            M = np.zeros((T * r, n))
            for j in range(T):
                rs = slice(j * r, (j + 1) * r)
                M[rs, j * D:(j + 1) * D] = M1[j]
                if j + 1 < T:
                    M[rs, (j + 1) * D:(j + 2) * D] = M2[j]
                M[rs, T * D:] = Mg[j]
            return M

        Ps.append(P)
        As.append(expand(*(host[k][bi] for k in ("A1", "A2", "Ag")), ra))
        Gs.append(expand(*(host[k][bi] for k in ("G1", "G2", "Gg")), rg))
    dev, dt = data.c.device, data.c.dtype

    def t(v):
        return torch.as_tensor(np.stack(v), device=dev).to(dt)

    return QPData(
        P=t(Ps), c=data.c, A=t(As), b=data.b, G=t(Gs), h_l=data.h_l, h_u=data.h_u,
        x_l=data.x_l, x_u=data.x_u, x_b_scaling=data.x_b_scaling,
        hl_mask=data.hl_mask, hu_mask=data.hu_mask,
        xl_mask=data.xl_mask, xu_mask=data.xu_mask,
    )


def random_multistage_arrays(T: int, D: int, Da: int = 0, ra: int = 0, rg: int = 0,
                             seed: int = 42) -> dict:
    """The numpy stage blocks of ``random_multistage_qp`` (keyword
    arguments of ``from_stage_blocks``); the same seed gives byte-identical
    arrays to the JAX package's generator."""
    rng = np.random.default_rng(seed)
    n = T * D + Da

    Pd = rng.uniform(-1, 1, (T, D, D))
    Pd = 0.5 * (Pd + Pd.transpose(0, 2, 1))
    Psub = rng.uniform(-0.3, 0.3, (T, D, D))
    Psub[T - 1] = 0.0
    Pa = rng.uniform(-0.3, 0.3, (T, Da, D))
    Pc = rng.uniform(-1, 1, (Da, Da))
    Pc = 0.5 * (Pc + Pc.T)
    # block diagonal dominance => positive definite
    ridge = 2.0 * (D + Da) + 1.0
    Pd += ridge * np.eye(D)[None]
    Pc += ridge * np.eye(Da) if Da else 0.0

    c = rng.uniform(-1, 1, n)
    x_sol = rng.uniform(-1, 1, n)
    xs = x_sol[: T * D].reshape(T, D)
    xg = x_sol[T * D:]
    xs_next = np.concatenate([xs[1:], np.zeros((1, D))], axis=0)

    kw = dict(Pd=Pd, Psub=Psub, Pa=Pa, Pc=Pc, c=c)
    if ra:
        A1 = rng.uniform(-1, 1, (T, ra, D))
        A2 = rng.uniform(-1, 1, (T, ra, D))
        A2[T - 1] = 0.0
        Ag = rng.uniform(-1, 1, (T, ra, Da))
        b = (
            np.einsum("trd,td->tr", A1, xs)
            + np.einsum("trd,td->tr", A2, xs_next)
            + np.einsum("tra,a->tr", Ag, xg)
        ).reshape(-1)
        kw.update(A1=A1, A2=A2, Ag=Ag, b=b)
    if rg:
        G1 = rng.uniform(-1, 1, (T, rg, D))
        G2 = rng.uniform(-1, 1, (T, rg, D))
        G2[T - 1] = 0.0
        Gg = rng.uniform(-1, 1, (T, rg, Da))
        Gx = (
            np.einsum("trd,td->tr", G1, xs)
            + np.einsum("trd,td->tr", G2, xs_next)
            + np.einsum("tra,a->tr", Gg, xg)
        ).reshape(-1)
        m = T * rg
        h_l = Gx - rng.uniform(0, 1, m)
        h_u = Gx + rng.uniform(0, 1, m)
        r = rng.uniform(0, 1, m)
        h_l = np.where(r < 0.3, -np.inf, h_l)
        h_u = np.where((r >= 0.3) & (r < 0.6), np.inf, h_u)
        kw.update(G1=G1, G2=G2, Gg=Gg, h_l=h_l, h_u=h_u)
    return kw


def random_multistage_qp(T: int, D: int, Da: int = 0, ra: int = 0, rg: int = 0,
                         seed: int = 42, dtype=torch.float64, device=None) -> StageQPData:
    """Random strongly convex multistage QP (block diagonally dominant P,
    equalities consistent with a planted trajectory, inequalities around
    it), one problem (B = 1) on ``device``."""
    return from_stage_blocks(**random_multistage_arrays(T, D, Da, ra, rg, seed),
                             dtype=dtype, device=device)


def random_multistage_batch(seeds, T: int, D: int, Da: int = 0, ra: int = 0,
                            rg: int = 0, dtype=torch.float64, device=None) -> StageQPData:
    """``random_multistage_qp`` for every seed, stacked into one batch by
    the stage entry ``batch.prepare_stage_batch``."""
    from .batch import prepare_stage_batch

    return prepare_stage_batch([random_multistage_arrays(T, D, Da, ra, rg, s) for s in seeds],
                               dtype, device)


# ---------------------------------------------------------------------------
# sparse input: structure detection, scatter, updates
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ScatterCache:
    """What the value scatter needs, kept at setup so that an update
    re-scatters values without structure detection (the reference's
    nnz-map update, multistage_kkt.hpp:140-178)."""

    n: int
    p: int
    m: int
    T: int
    D: int
    Da: int
    T_pad: int
    var_stage: np.ndarray
    var_off: np.ndarray
    var_map: np.ndarray  # before horizon padding
    used: np.ndarray  # (T, D) bool: real (non-pad) diagonal slots
    a_bucket: np.ndarray
    a_slot: np.ndarray
    a_row_map: np.ndarray
    ra: int
    g_bucket: np.ndarray
    g_slot: np.ndarray
    g_row_map: np.ndarray
    rg: int


@dataclasses.dataclass
class StageLayout:
    """Map between the user's variable/row order and the padded stage
    layout (the reference's BlockMat row permutation plus variable
    blocking)."""

    var_map: np.ndarray  # user variable -> flat stage-layout position
    a_row_map: np.ndarray  # user A row -> flat position
    g_row_map: np.ndarray  # user G row -> flat position
    n: int
    p: int
    m: int
    # padded chain width T*D over the real (non-arrow) variable count
    waste: float = 1.0
    cache: Optional[_ScatterCache] = None
    # dead-row pattern (both bounds infinite) of the unpadded stage rows
    dead: Optional[torch.Tensor] = None


def _reblock_uniform(S, is_arrow, starts, sizes):
    """Equalize the detected block sizes to one width D_t for batching:
    blocks wider than D_t spill their highest-degree variables into the
    arrow, and runs of adjacent blocks with combined size <= D_t merge.
    D_t minimizes the factorization flop model
    T'(7/3 D^3 + 2 D^2 Da' + D Da'^2) + Da'^3/3 over the detected widths
    (the cost terms of the reference's extract_arrow_structure)."""
    sizes = np.asarray(sizes, np.int64)
    Da0 = int(is_arrow.sum())
    if len(sizes) == 0:
        return is_arrow, starts, sizes

    def simulate(Dt):
        spilled = np.maximum(sizes - Dt, 0)
        kept = sizes - spilled
        Tm = 0
        acc = 0
        for s in kept:
            if acc and acc + s <= Dt:
                acc += s
            else:
                Tm += 1
                acc = s
        Da = Da0 + int(spilled.sum())
        cost = Tm * ((7.0 / 3.0) * Dt**3 + 2.0 * Dt**2 * Da + Dt * Da**2)
        cost += Da**3 / 3.0
        return cost, Tm

    cands = sorted(set(int(s) for s in sizes if s > 0))
    best_Dt, best_cost = int(sizes.max()), simulate(int(sizes.max()))[0]
    for Dt in cands:
        c, Tm = simulate(Dt)
        if Tm >= 3 and c < best_cost:
            best_cost, best_Dt = c, Dt
    Dt = best_Dt

    degree = np.diff(S.indptr)
    orig_idx = np.nonzero(~is_arrow)[0]
    new_arrow = is_arrow.copy()
    kept_sizes = []
    for t in range(len(starts)):
        blk = orig_idx[starts[t]:starts[t] + sizes[t]]
        if sizes[t] > Dt:
            order = np.argsort(-degree[blk], kind="stable")
            new_arrow[blk[order[: sizes[t] - Dt]]] = True
            kept_sizes.append(Dt)
        else:
            kept_sizes.append(int(sizes[t]))

    new_starts, new_sizes = [], []
    pos = 0
    acc = 0
    for s in kept_sizes:
        if acc and acc + s <= Dt:
            acc += s
        else:
            if acc:
                new_starts.append(pos)
                new_sizes.append(acc)
                pos += acc
            acc = s
    if acc:
        new_starts.append(pos)
        new_sizes.append(acc)
    return new_arrow, np.asarray(new_starts, np.int64), np.asarray(new_sizes, np.int64)


def from_sparse(
    P, c, A=None, b=None, G=None, h_l=None, h_u=None, x_l=None, x_u=None,
    band_cap: int = 0, min_blocks: int = 3, dtype=torch.float64, device=None,
):
    """Detect multistage structure in a general sparse QP and convert it to
    StageQPData (B = 1) on ``device`` (the reference's
    extract_arrow_structure + utri_to_kkt + transpose_to_block_mat,
    multistage_kkt.hpp:420-818).  Structure detection and the scatter run
    in the port's C++ library (``_native``).

    Returns (StageQPData, StageLayout); raises ValueError when the problem
    has no usable block structure."""
    import scipy.sparse as sp

    from . import _native

    # only the upper triangle of P is used (solver.hpp:182)
    P = sp.csc_matrix(P)
    P = (sp.triu(P) + sp.triu(P, 1).T).tocsc()
    n = P.shape[0]
    A = sp.csc_matrix(A) if A is not None else sp.csc_matrix((0, n))
    G = sp.csc_matrix(G) if G is not None else sp.csc_matrix((0, n))
    p, m = A.shape[0], G.shape[0]

    # symmetric coupling pattern of P + A'A + G'G (multistage_kkt.hpp:425-431)
    S = (abs(P) + abs(P).T).astype(bool)
    if p:
        aT = abs(A).T.astype(bool).tocsc()
        S = (S + (aT @ aT.T).astype(bool)).astype(bool)
    if m:
        gT = abs(G).T.astype(bool).tocsc()
        S = (S + (gT @ gT.T).astype(bool)).astype(bool)
    S = sp.csc_matrix(S + sp.eye(n, dtype=bool, format="csc"))

    is_arrow, starts, sizes = _native.detect_structure(S.indptr, S.indices, n, band_cap)
    if len(starts) < min_blocks:
        raise ValueError(f"no multistage structure (only {len(starts)} blocks)")
    is_arrow, starts, sizes = _reblock_uniform(S, is_arrow, starts, sizes)
    T = len(starts)
    if T < min_blocks:
        raise ValueError(f"no multistage structure (only {T} blocks)")
    Da = int(is_arrow.sum())
    D = int(sizes.max())

    # stage and offset of every user variable
    var_stage = np.full(n, -1, np.int64)
    var_off = np.zeros(n, np.int64)
    keep = ~is_arrow
    compact = np.cumsum(keep) - 1
    blk_of = np.zeros(int(keep.sum()), np.int64)
    for t, (s0, sz) in enumerate(zip(starts, sizes)):
        blk_of[s0:s0 + sz] = t
    var_stage[keep] = blk_of[compact[keep]]
    var_off[keep] = compact[keep] - starts[blk_of[compact[keep]]]
    var_off[is_arrow] = np.cumsum(is_arrow)[is_arrow] - 1
    var_map = np.where(keep, var_stage * D + var_off, T * D + var_off).astype(np.int64)

    used = np.zeros((T, D), bool)
    for t, sz in enumerate(sizes):
        used[t, :sz] = True

    # bucket constraint rows (a row may touch stages {j} or {j, j+1} + arrow)
    def bucket_rows(M):
        Mr = M.tocsr()
        bucket = np.zeros(Mr.shape[0], np.int64)
        for r in range(Mr.shape[0]):
            stg = var_stage[Mr.indices[Mr.indptr[r]:Mr.indptr[r + 1]]]
            stg = stg[stg >= 0]
            if stg.size == 0:
                bucket[r] = T - 1
                continue
            lo, hi = int(stg.min()), int(stg.max())
            if hi - lo > 1:
                raise ValueError("constraint row spans non-adjacent stages")
            bucket[r] = lo
        return bucket

    def layout_rows(bucket, rows):
        counts = np.bincount(bucket, minlength=T)
        rmax = int(counts.max()) if rows else 0
        slot = np.zeros(rows, np.int64)
        seen = np.zeros(T, np.int64)
        for r in range(rows):
            slot[r] = seen[bucket[r]]
            seen[bucket[r]] += 1
        return rmax, slot, bucket * rmax + slot

    a_bucket = bucket_rows(A)
    ra, a_slot, a_row_map = layout_rows(a_bucket, p)
    g_bucket = bucket_rows(G)
    rg, g_slot, g_row_map = layout_rows(g_bucket, m)

    # pad the horizon to a chunkable length only where the chunked scheme
    # is selected (cyclic reduction takes any T)
    T_pad = T if _use_cr(T) else _next_chunkable(T)
    cache = _ScatterCache(
        n=n, p=p, m=m, T=T, D=D, Da=Da, T_pad=T_pad,
        var_stage=var_stage, var_off=var_off, var_map=var_map, used=used,
        a_bucket=a_bucket, a_slot=a_slot, a_row_map=a_row_map, ra=ra,
        g_bucket=g_bucket, g_slot=g_slot, g_row_map=g_row_map, rg=rg,
    )
    return _assemble(P, c, A, b, G, h_l, h_u, x_l, x_u, cache, dtype, device)


def _flat_vectors(cache: _ScatterCache, c, b, h_l, h_u, x_l, x_u) -> dict:
    """User vectors scattered into the (unpadded) stage layout, float64;
    padded inequality rows get the benign [-1, 1] bounds."""
    T, D, Da = cache.T, cache.D, cache.Da
    inf = np.inf
    c_f = np.zeros(T * D + Da)
    c_f[cache.var_map] = np.asarray(c, np.float64).ravel()
    b_f = np.zeros(T * cache.ra)
    if cache.p:
        b_f[cache.a_row_map] = np.asarray(b, np.float64).ravel()
    hl_f = np.full(T * cache.rg, -1.0)
    hu_f = np.full(T * cache.rg, 1.0)
    if cache.m:
        hl_f[cache.g_row_map] = np.asarray(h_l, np.float64).ravel() if h_l is not None else -inf
        hu_f[cache.g_row_map] = np.asarray(h_u, np.float64).ravel() if h_u is not None else inf
    xl_f = np.full(T * D + Da, -inf)
    xu_f = np.full(T * D + Da, inf)
    if x_l is not None:
        xl_f[cache.var_map] = np.asarray(x_l, np.float64).ravel()
    if x_u is not None:
        xu_f[cache.var_map] = np.asarray(x_u, np.float64).ravel()
    return dict(c=c_f, b=b_f, h_l=hl_f, h_u=hu_f, x_l=xl_f, x_u=xu_f)


def _canonical_vectors(v: dict) -> tuple:
    """The vectors of ``_flat_vectors`` canonical on the host in float64,
    as (1, ...) tensors, and their dead-row mask (the JAX package decides
    ``update_vectors``' dead pattern in float64)."""
    *bounds, dead = canonical_bounds(*(torch.from_numpy(v[k])[None]
                                       for k in ("h_l", "h_u", "x_l", "x_u")))
    names = ("h_l", "h_u", "x_l", "x_u", "hl_mask", "hu_mask", "xl_mask", "xu_mask")
    return dict(c=torch.from_numpy(v["c"])[None], b=torch.from_numpy(v["b"])[None],
                **dict(zip(names, bounds))), dead


def _assemble(P, c, A, b, G, h_l, h_u, x_l, x_u, cache, dtype, device):
    """Scatter values into stage blocks through the cached maps and build
    the StageQPData and StageLayout."""
    import scipy.sparse as sp

    from . import _native

    T, D, Da, n = cache.T, cache.D, cache.Da, cache.n
    var_stage, var_off = cache.var_stage, cache.var_off

    P = sp.csc_matrix(P)
    Pd, Psub, Pa, Pc = _native.scatter_P(P.indptr, P.indices, P.data, var_stage, var_off,
                                         T, D, Da)
    idx_t, idx_d = np.nonzero(~cache.used)
    Pd[idx_t, idx_d, idx_d] = 1.0

    def constr(M, bucket, slot, r):
        if r == 0:
            return np.zeros((T, 0, D)), np.zeros((T, 0, D)), np.zeros((T, 0, Da))
        Mr = (sp.csc_matrix(M) if M is not None else sp.csc_matrix((0, n))).tocsr()
        return _native.scatter_constr(Mr.indptr, Mr.indices, Mr.data, var_stage, var_off,
                                      bucket, slot, T, r, D, Da)

    A1, A2, Ag = constr(A, cache.a_bucket, cache.a_slot, cache.ra if cache.p else 0)
    G1, G2, Gg = constr(G, cache.g_bucket, cache.g_slot, cache.rg if cache.m else 0)
    v = _flat_vectors(cache, c, b, h_l, h_u, x_l, x_u)

    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    arrays = _stage_arrays(Pd, Psub, Pa, Pc, A1=A1, A2=A2, Ag=Ag, G1=G1, G2=G2, Gg=Gg,
                           np_dtype=np_dtype, **v)
    sdata = pad_stages(stage_data_from_arrays([arrays], dtype, device), cache.T_pad)

    var_map = cache.var_map
    if cache.T_pad != T:
        var_map = np.where(var_map >= T * D, var_map + (cache.T_pad - T) * D, var_map)
    layout = StageLayout(
        var_map=var_map, a_row_map=cache.a_row_map, g_row_map=cache.g_row_map,
        n=n, p=cache.p, m=cache.m,
        waste=float(sdata.T * sdata.D) / max(1, n - Da),
        cache=cache,
        dead=_canonical_vectors(v)[1],
    )
    return sdata, layout


def update_values(layout: StageLayout, P, c, A=None, b=None, G=None, h_l=None,
                  h_u=None, x_l=None, x_u=None, dtype=torch.float64, device=None):
    """Re-scatter new values through the cached maps of a ``from_sparse``
    call, without structure detection (the sparsity patterns must stay
    inside the detected stage structure, else ValueError as at setup)."""
    if layout.cache is None:
        raise ValueError("layout has no scatter cache (not from from_sparse)")
    import scipy.sparse as sp

    P = sp.csc_matrix(P)
    P = (sp.triu(P) + sp.triu(P, 1).T).tocsc()
    return _assemble(P, c, A, b, G, h_l, h_u, x_l, x_u, layout.cache, dtype, device)


def update_vectors(layout: StageLayout, sdata: StageQPData, c, b=None, h_l=None,
                   h_u=None, x_l=None, x_u=None):
    """Rebuild only the flat vectors (c, b, bounds, masks) of a B = 1
    StageQPData through the cached maps; every stage block stays the same
    device tensor (the multistage selective-transfer update).

    Returns the new StageQPData, or None when the inequality dead-row
    pattern changed: that needs rows of the resident G blocks re-zeroed,
    i.e. ``update_values``."""
    cache = layout.cache
    if cache is None or layout.dead is None:
        raise ValueError("layout has no scatter cache (not from from_sparse)")
    vecs, dead = _canonical_vectors(_flat_vectors(cache, c, b, h_l, h_u, x_l, x_u))
    if not torch.equal(dead, layout.dead):
        return None
    vecs = _pad_flat(vecs, cache.T, cache.D, cache.ra, cache.rg, cache.T_pad)
    dt, dev = sdata.c.dtype, sdata.c.device
    return dataclasses.replace(sdata, **{
        k: v.to(dev, dt) if v.is_floating_point() else v.to(dev) for k, v in vecs.items()})
