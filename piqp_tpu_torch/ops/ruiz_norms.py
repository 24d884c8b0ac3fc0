"""The kernels of a Ruiz pass: the norms, the step, the scaling.

Ruiz equilibration (``ruiz.py``, the stage registration in
``multistage.py``) scales a working copy of the matrices pass by pass.  A
pass reads the copy once for its norms, steps the scalings, and reads and
writes the copy once to scale it, with no read of the device from the
host; every product is rounded as the reference rounds it.

Norms, one launch a pass (``launches_by_shape``):

- ``dense_norms``: plain ``QPData``, P (B, n, n), A (B, p, n), G (B, m, n).
  Returns (B, n + p + m): the column norms of [P; A; G] and the row norms
  of A and G.
- ``stage_norms``: the owned stages [start, start + Tl) of
  ``multistage.StageQPData``'s nine stage-indexed blocks, of a horizon of
  T stages.  Returns (B, W) in ``stage_layout``'s layout: the column norms
  of the owned stages' columns, each stage's own blocks and the next
  stage's share (Psub's rows, A2's and G2's columns) joined, a last row
  for the share of the stage after the owned ones when there is one (the
  spill), the arrow columns' norms (Pa's rows, Ag's and Gg's columns)
  joined over the owned stages, and the row norms of A (A1, A2, Ag) and G
  (G1, G2, Gg).  For data that holds the whole horizon, W is n + p + m and
  the layout is ``dense_norms``'s.

The step and the scaling, in place on the loop's state, per problem
(``pass_launches_by_kind``):

- ``ruiz_step``, one launch a pass: from the norms (B, n + p + m), with
  x_b_scaling's column and P[g, g]'s (``Pc``, the arrow, for stage data)
  joined in: the pass's scalings 1 / sqrt(limit(norm)), the accumulated
  ones, the scaled x_b_scaling and c, and the pass's measure;
- ``dense_scale`` / ``stage_scale``, one launch a pass: the matrices
  scaled by the pass's scalings, (M_rc d_r) d_c;
- ``ruiz_cost_step``, under ``scale_cost``: the cost factor gamma from the
  norms of P's stage columns after the scaling (a second norms launch,
  with p = m = 0) and P[g, g]'s, and c and cost scaled by it; small
  tensor ops on any device, no kernel of its own.

A problem whose ``active`` flag is false reads none of its blocks, has
norms 0 and keeps its state.  On a CUDA tensor each function launches its
instance of the hand-written kernels of ``csrc/ruiz_norms.cu`` (built at
first use by ``ops/_build.py``) and raises if the launch fails; on a CPU
tensor it runs the plain PyTorch version beside it, bit for bit the
kernel's.  Any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..types import max0

_DTYPES = (torch.float32, torch.float64)
MIN_SCALING = 1e-4
MAX_SCALING = 1e4
STAGE_BLOCKS = ("Pd", "Psub", "Pa", "A1", "A2", "Ag", "G1", "G2", "Gg")

# Norm kernel launches (never the plain version's calls), keyed
# "dense:<dtype>:n<n>xp<p>xm<m>" or "stage:<dtype>:T<Tl>xD<D>xra<ra>xrg<rg>xDa<Da>"
# (Tl: the owned stages); a key appears at its first launch.  A Ruiz pass
# makes one launch, two under ``scale_cost`` (the second reads P's blocks
# alone, with p = m = 0 or ra = rg = 0).  ``pass_launches_by_kind``: the
# step kernel's and the scale kernel's launches, one each a pass.
launches_by_shape: dict = {}
pass_launches_by_kind = {"step": 0, "scale": 0}


def limit_scaling(d: torch.Tensor) -> torch.Tensor:
    """Mirror of limit_scaling (preconditioner.hpp:420-437): values below
    MIN_SCALING are reset to 1 (not clamped!), values above MAX_SCALING are
    clamped."""
    d = torch.where(d < MIN_SCALING, 1.0, d)
    return torch.where(d > MAX_SCALING, MAX_SCALING, d)


def stage_layout(Tl: int, D: int, Da: int, ra: int, rg: int, spill: bool) -> tuple:
    """Widths of ``stage_norms``'s parts, in order: the owned stages'
    columns (with the spill row), the arrow columns, A's rows, G's rows."""
    return ((Tl + spill) * D, Da, Tl * ra, Tl * rg)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _colmax(M: torch.Tensor) -> torch.Tensor:
    """max_r |M_rc| over the matrices of M (..., R, C) -> (..., C)."""
    return max0(M.abs(), dim=-2)


def _rowmax(M: torch.Tensor) -> torch.Tensor:
    """max_c |M_rc| over the matrices of M (..., R, C) -> (..., R)."""
    return max0(M.abs(), dim=-1)


def _masked(active: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return torch.where(active.reshape((-1,) + (1,) * (out.ndim - 1)), out, 0.0)


def dense_norms_reference(P, A, G, active) -> torch.Tensor:
    """Plain PyTorch version of the dense norm kernel."""
    col = torch.maximum(torch.maximum(_colmax(P), _colmax(A)), _colmax(G))
    return _masked(active, torch.cat([col, _rowmax(A), _rowmax(G)], dim=1))


def stage_norms_reference(blocks, active, start: int, horizon: int) -> torch.Tensor:
    """Plain PyTorch version of the stage norm kernel.  ``blocks``: the
    owned stages [start, start + Tl) of (Pd, Psub, Pa, A1, A2, Ag, G1, G2,
    Gg), of a horizon of ``horizon`` stages."""
    Pd, Psub, Pa, A1, A2, Ag, G1, G2, Gg = blocks
    col = _colmax(Pd)
    for M in (Psub, Pa, A1, G1):
        col = torch.maximum(col, _colmax(M))
    nxt = torch.maximum(torch.maximum(_colmax(A2), _colmax(G2)), _rowmax(Psub))
    arrow = torch.maximum(torch.maximum(_colmax(Ag), _colmax(Gg)), _rowmax(Pa))
    y = torch.maximum(torch.maximum(_rowmax(A1), _rowmax(A2)), _rowmax(Ag))
    z = torch.maximum(torch.maximum(_rowmax(G1), _rowmax(G2)), _rowmax(Gg))
    rows = torch.cat([col, torch.zeros_like(col[:, :1])], dim=1)
    rows[:, 1:] = torch.maximum(rows[:, 1:], nxt)  # the next stage's share
    if start + Pd.shape[1] == horizon:
        rows = rows[:, :-1]  # the last stage's falls off the horizon
    out = torch.cat([rows.flatten(1), max0(arrow, dim=1), y.flatten(1), z.flatten(1)], dim=1)
    return _masked(active, out)


def _pc_col_norms(Pc):
    """Column norms of P[g, g] (B, Da)."""
    return max0(Pc.abs(), dim=-2)


def ruiz_step_reference(norms, Pc, d, s, xb, cvec, measure, active) -> None:
    """Plain PyTorch version of the step kernel (in place)."""
    n = xb.shape[1]
    Da = 0 if Pc is None else Pc.shape[-1]
    nx = norms[:, :n]
    if Da:
        nx = torch.cat([nx[:, :n - Da], torch.maximum(nx[:, n - Da:], _pc_col_norms(Pc))], dim=1)
    flat = torch.cat([torch.maximum(nx, xb), norms[:, n:], xb], dim=1)
    step = 1.0 / torch.sqrt(limit_scaling(flat))
    on = active[:, None]
    s.copy_(torch.where(on, step, s))
    measure.copy_(torch.where(active, max0((1.0 - step).abs()), measure))
    cvec.copy_(torch.where(on, cvec * step[:, :n], cvec))
    xb.copy_(torch.where(on, xb * step[:, -n:] * step[:, :n], xb))
    d.copy_(torch.where(on, d * step, d))


def dense_scale_reference(P, A, G, dx, dy, dz, active) -> None:
    """Plain PyTorch version of the dense scale kernel (in place)."""
    on = active[:, None, None]
    for M, rows in ((P, dx), (A, dy), (G, dz)):
        M.copy_(torch.where(on, rows[:, :, None] * M * dx[:, None, :], M))


def stage_scale_reference(blocks, dx, dg, dy, dz, active, start: int = 0) -> None:
    """Plain PyTorch version of the stage scale kernel (in place): the
    owned stages' ``blocks``, by the whole horizon's scalings."""
    Pd, Psub, Pa, A1, A2, Ag, G1, G2, Gg = blocks
    own = slice(start, start + Pd.shape[1])
    nxt = torch.cat([dx[:, 1:], torch.zeros_like(dx[:, :1])], dim=1)[:, own]
    x, y, z = dx[:, own], dy[:, own], dz[:, own]
    col_x, col_n, col_g = x[:, :, None, :], nxt[:, :, None, :], dg[:, None, None, :]
    on = active[:, None, None, None]
    for M, rows, cols in ((Pd, x, col_x), (Psub, nxt, col_x), (Pa, dg[:, None].expand_as(Pa[..., 0]), col_x),
                          (A1, y, col_x), (A2, y, col_n), (Ag, y, col_g),
                          (G1, z, col_x), (G2, z, col_n), (Gg, z, col_g)):
        M.copy_(torch.where(on, M * rows[..., None] * cols, M))


def _check(name: str, tensors: list, active: torch.Tensor) -> str:
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or float64, got {dtype}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: a {t.dtype} tensor on {t.device} beside {dtype} on {dev}")
    if active.dtype != torch.bool or active.device != dev:
        raise TypeError(f"{name}: active must be a bool tensor on {dev}")
    return dev.type


def _rows(M: torch.Tensor) -> torch.Tensor:
    """M with each matrix's rows packed, R x C consecutive values (any
    batch stride), as the kernels read it; a copy only where they are not."""
    R, C = M.shape[-2:]
    packed = [R * C] * (M.ndim - 3) + [C, 1]
    if any(s != w for s, w, k in zip(M.stride()[1:], packed, M.shape[1:]) if k > 1):
        M = M.contiguous()
    return M


def _vector(v: torch.Tensor) -> torch.Tensor:
    """A scaling vector (B, k) or (B, T, k) with packed rows, any batch
    stride; a copy only where it is not."""
    packed = [1] if v.ndim == 2 else [v.shape[-1], 1]
    if any(s != w for s, w, k in zip(v.stride()[1:], packed, v.shape[1:]) if k > 1):
        v = v.contiguous()
    return v


def _state(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name} updates contiguous state tensors in place")


def _launch(entry: str, dtype: torch.dtype, device, ptrs: list, dims: list) -> None:
    from ._build import library

    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(library(), f"piqp_ruiz_{entry}_{suffix}")
    p = (ctypes.c_void_p * len(ptrs))(*ptrs)
    d = (ctypes.c_longlong * len(dims))(*dims)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(ctypes.cast(p, ctypes.c_void_p), ctypes.cast(d, ctypes.c_void_p), stream)
    if rc != 0:
        raise RuntimeError(f"ruiz {entry} kernel launch failed with cudaError_t {rc}")


def _count(key: str) -> None:
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1


def dense_norms(P, A, G, active) -> torch.Tensor:
    """(B, n + p + m): the column norms of [P; A; G] and the row norms of A
    and G, 0 for an inactive problem."""
    kind = _check("dense_norms", [P, A, G], active)
    B, n, _ = P.shape
    p, m = A.shape[1], G.shape[1]
    if P.shape != (B, n, n) or A.shape != (B, p, n) or G.shape != (B, m, n) or \
            active.shape != (B,):
        raise ValueError(f"dense_norms: P {tuple(P.shape)}, A {tuple(A.shape)}, "
                         f"G {tuple(G.shape)}, active {tuple(active.shape)}")
    if kind == "cpu":
        return dense_norms_reference(P, A, G, active)
    P, A, G, active = _rows(P), _rows(A), _rows(G), active.contiguous()
    out = torch.empty((B, n + p + m), dtype=P.dtype, device=P.device)
    ptrs = [t.data_ptr() for t in (P, A, G, active, out)]
    _launch("norms_dense", P.dtype, P.device, ptrs,
            [B, n, p, m, P.stride(0), A.stride(0), G.stride(0)])
    _count(f"dense:{_dtype_name(P)}:n{n}xp{p}xm{m}")
    return out


def stage_norms(blocks, active, start: int, horizon: int) -> torch.Tensor:
    """(B, W), ``stage_layout``'s parts: see the module docstring; 0 for
    an inactive problem."""
    Pd, Psub, Pa, A1, A2, Ag, G1, G2, Gg = blocks
    kind = _check("stage_norms", list(blocks), active)
    B, Tl, D, _ = Pd.shape
    Da, ra, rg = Pa.shape[2], A1.shape[2], G1.shape[2]
    want = dict(Pd=(D, D), Psub=(D, D), Pa=(Da, D), A1=(ra, D), A2=(ra, D), Ag=(ra, Da),
                G1=(rg, D), G2=(rg, D), Gg=(rg, Da))
    if any(tuple(M.shape) != (B, Tl) + want[k] for k, M in zip(STAGE_BLOCKS, blocks)) or \
            active.shape != (B,) or not 0 <= start <= horizon - Tl:
        raise ValueError(
            "stage_norms: " + ", ".join(f"{k} {tuple(M.shape)}" for k, M in
                                        zip(STAGE_BLOCKS, blocks))
            + f"; active {tuple(active.shape)}, start {start}, horizon {horizon}")
    if kind == "cpu":
        return stage_norms_reference(blocks, active, start, horizon)
    blocks = tuple(_rows(M) for M in blocks)
    active = active.contiguous()
    width = sum(stage_layout(Tl, D, Da, ra, rg, start + Tl < horizon))
    out = torch.zeros((B, width), dtype=Pd.dtype, device=Pd.device)
    ptrs = [t.data_ptr() for t in (*blocks, active, out)]
    dims = [B, Tl, horizon, start, D, Da, ra, rg] + [M.stride(0) for M in blocks]
    _launch("norms_stage", Pd.dtype, Pd.device, ptrs, dims)
    _count(f"stage:{_dtype_name(Pd)}:T{Tl}xD{D}xra{ra}xrg{rg}xDa{Da}")
    return out


def ruiz_step(norms, Pc, d, s, xb, cvec, measure, active) -> None:
    """One Ruiz pass's step, in place, for the problems ``active`` marks:
    norms (B, n + p + m) of the scaled KKT matrix without x_b_scaling's
    column and P[g, g]'s (the scaled Pc (B, Da, Da), None for plain data:
    both joined here); the pass's scalings 1 / sqrt(limit(norm)) into s
    and into the accumulated d (both (B, 2n + p + m) = [x | y | z | b]),
    the scaled x_b_scaling xb and c ``cvec`` (B, n), the measure (B,)."""
    state = [d, s, xb, cvec, measure]
    kind = _check("ruiz_step", [norms, *state] + ([Pc] if Pc is not None else []), active)
    B, n = xb.shape
    Da = 0 if Pc is None else Pc.shape[-1]
    w = norms.shape[1]
    if norms.shape != (B, w) or d.shape != (B, n + w) or s.shape != d.shape or \
            cvec.shape != (B, n) or measure.shape != (B,) or active.shape != (B,) or w < n or \
            (Pc is not None and Pc.shape != (B, Da, Da)) or Da > n:
        raise ValueError(f"ruiz_step: norms {tuple(norms.shape)}, d {tuple(d.shape)}, "
                         f"s {tuple(s.shape)}, xb {tuple(xb.shape)}, cvec {tuple(cvec.shape)}, "
                         f"measure {tuple(measure.shape)}")
    if kind == "cpu":
        return ruiz_step_reference(norms, Pc, d, s, xb, cvec, measure, active)
    _state("ruiz_step", *state)
    norms, active = norms.contiguous(), active.contiguous()
    Pc = _rows(Pc) if Pc is not None else None
    ptrs = [t.data_ptr() if t is not None else 0
            for t in (norms, Pc, d, s, xb, cvec, measure, active)]
    _launch("step", d.dtype, d.device, ptrs, [B, n, w - n, Da, Pc.stride(0) if Da else 0])
    pass_launches_by_kind["step"] += 1


def ruiz_cost_step(norms, Pc, cvec, cost, gamma, active) -> None:
    """The cost factor of ``scale_cost`` (preconditioner.hpp:148-169), in
    place for the problems ``active`` marks: gamma (B,) from norms (B, n),
    the column norms of the scaled P (only the stage columns, the first
    n - Da, are summed, with those of the scaled P[g, g] ``Pc``: the JAX
    package's rule), then c and cost scaled by it.  Small tensor ops on
    any device."""
    n = cvec.shape[1]
    Da = 0 if Pc is None else Pc.shape[-1]
    total = norms[:, :n - Da].sum(-1)
    if Da:
        total = total + _pc_col_norms(Pc).sum(-1)
    g = limit_scaling(total / n)
    g = 1.0 / limit_scaling(torch.maximum(g, max0(cvec.abs())))
    gamma.copy_(torch.where(active, g, gamma))
    cvec.copy_(torch.where(active[:, None], cvec * g[:, None], cvec))
    cost.copy_(torch.where(active, cost * g, cost))


def _packed(name: str, M: torch.Tensor) -> None:
    """A batch of matrices the scale kernels write in place: each one's
    rows packed (an empty one is never touched)."""
    if M.numel() == 0:
        return
    R, C = M.shape[-2:]
    packed = [R * C] * (M.ndim - 3) + [C, 1]
    if any(st != w for st, w, k in zip(M.stride()[1:], packed, M.shape[1:]) if k > 1):
        raise ValueError(f"{name} scales matrices with packed rows in place")


def dense_scale(P, A, G, dx, dy, dz, active) -> None:
    """P <- Dx P Dx, A <- Dy A Dx, G <- Dz G Dx in place, each product
    (M_rc d_r) d_c rounded as the reference rounds it, for the problems
    ``active`` marks; the others keep their matrices."""
    kind = _check("dense_scale", [P, A, G, dx, dy, dz], active)
    B, n, _ = P.shape
    p, m = A.shape[1], G.shape[1]
    if P.shape != (B, n, n) or A.shape != (B, p, n) or G.shape != (B, m, n) or \
            dx.shape != (B, n) or dy.shape != (B, p) or dz.shape != (B, m) or \
            active.shape != (B,):
        raise ValueError(f"dense_scale: P {tuple(P.shape)}, A {tuple(A.shape)}, "
                         f"G {tuple(G.shape)}, dx {tuple(dx.shape)}, dy {tuple(dy.shape)}, "
                         f"dz {tuple(dz.shape)}, active {tuple(active.shape)}")
    for M in (P, A, G):
        _packed("dense_scale", M)
    if kind == "cpu":
        return dense_scale_reference(P, A, G, dx, dy, dz, active)
    dx, dy, dz, active = _vector(dx), _vector(dy), _vector(dz), active.contiguous()
    ptrs = [t.data_ptr() for t in (P, A, G, dx, dy, dz, active)]
    dims = [B, n, p, m, dx.stride(0), dy.stride(0), dz.stride(0),
            P.stride(0), A.stride(0), G.stride(0)]
    _launch("scale_dense", P.dtype, P.device, ptrs, dims)
    pass_launches_by_kind["scale"] += 1


def stage_scale(blocks, dx, dg, dy, dz, active, start: int = 0) -> None:
    """The owned stages [start, start + Tl) of the nine stage-indexed
    blocks scaled in place by the whole horizon's scalings, (M_rc d_r) d_c
    (P[t+1, t]'s rows and A2's and G2's columns by the next stage's dx, 0
    past the horizon), for the problems ``active`` marks."""
    Pd, Psub, Pa, A1, A2, Ag, G1, G2, Gg = blocks
    kind = _check("stage_scale", [*blocks, dx, dg, dy, dz], active)
    B, Tl, D, _ = Pd.shape
    T, Da, ra, rg = dx.shape[1], Pa.shape[2], A1.shape[2], G1.shape[2]
    want = dict(Pd=(D, D), Psub=(D, D), Pa=(Da, D), A1=(ra, D), A2=(ra, D), Ag=(ra, Da),
                G1=(rg, D), G2=(rg, D), Gg=(rg, Da))
    if any(tuple(M.shape) != (B, Tl) + want[k] for k, M in zip(STAGE_BLOCKS, blocks)) or \
            dx.shape != (B, T, D) or dg.shape != (B, Da) or dy.shape != (B, T, ra) or \
            dz.shape != (B, T, rg) or active.shape != (B,) or not 0 <= start <= T - Tl:
        raise ValueError(
            "stage_scale: " + ", ".join(f"{k} {tuple(M.shape)}" for k, M in
                                        zip(STAGE_BLOCKS, blocks))
            + f"; dx {tuple(dx.shape)}, dg {tuple(dg.shape)}, dy {tuple(dy.shape)}, "
            f"dz {tuple(dz.shape)}, active {tuple(active.shape)}, start {start}")
    for M in blocks:
        _packed("stage_scale", M)
    if kind == "cpu":
        return stage_scale_reference(blocks, dx, dg, dy, dz, active, start)
    dx, dg, dy, dz, active = _vector(dx), _vector(dg), _vector(dy), _vector(dz), \
        active.contiguous()
    ptrs = [t.data_ptr() for t in (*blocks, dx, dg, dy, dz, active)]
    dims = [B, Tl, T, start, D, Da, ra, rg, dx.stride(0), dg.stride(0), dy.stride(0),
            dz.stride(0)] + [M.stride(0) for M in blocks]
    _launch("scale_stage", Pd.dtype, Pd.device, ptrs, dims)
    pass_launches_by_kind["scale"] += 1
