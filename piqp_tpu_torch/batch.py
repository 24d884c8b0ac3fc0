"""Batched QP solving (``piqp_tpu/batch.py``).

Every module of the port is batch-first, so a batch solve is the plain
solve on data with a leading batch dimension; ``solve_batch`` adds only
the optional chunking and the split of the batch over the ranks of a
``torch.distributed`` process group.  All problems in a batch share (n, p, m); masks may
differ per problem, and the cone dispatch is one flag for the batch.

``solve_batch_sqp`` runs rounds of warm re-solves with moved costs (the
SQP/MPC loop), and ``solve_batch_compact`` re-solves the problems a short
first pass leaves unconverged as a smaller batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import multistage, ruiz, solver
from .api import _route_backend, _solve_fresh, _warm_vars
from .parallel.comm import all_gather_tree, require_group
from .types import (
    BasicVars,
    QPData,
    Result,
    Settings,
    Status,
    canonical_bounds,
    concat,
    index,
    index_put,
    resolve_device,
)
from .utils.profiling import annotate


# entry calls (``prepare_batch`` and the stage entry) by where the raw
# fields were staged: page-locked memory (a CUDA target, copied without
# blocking) or pageable memory
entry_batches_by_staging = {"pinned": 0, "pageable": 0}

# the raw fields of a problem dict, in their order of validation, and what
# an omitted one holds where that is not 0
_FIELDS = ("P", "c", "A", "b", "G", "h_l", "h_u", "x_l", "x_u")
_FILL = dict(h_l=-np.inf, h_u=np.inf, x_l=-np.inf, x_u=np.inf)


def _fields(P, c, A=None, b=None, G=None, h_l=None, h_u=None, x_l=None, x_u=None):
    return dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l, h_u=h_u, x_l=x_l, x_u=x_u)


def _shapes(prob: dict) -> dict:
    """Each field's shape, checked by shape alone: P square, every given
    field of its expected shape, a bound when G is given."""
    P = np.shape(prob["P"])
    if len(P) != 2 or P[0] != P[1]:
        raise ValueError("P must be square")
    n = P[0]
    p = 0 if prob["A"] is None else np.shape(prob["A"])[0]
    m = 0 if prob["G"] is None else np.shape(prob["G"])[0]
    want = dict(P=(n, n), c=(n,), A=(p, n), b=(p,), G=(m, n), h_l=(m,), h_u=(m,),
                x_l=(n,), x_u=(n,))
    for k in _FIELDS[1:]:
        if k == "h_l" and m > 0 and prob["h_l"] is None and prob["h_u"] is None:
            raise ValueError("h_l or h_u should be provided when G is given")
        if prob[k] is not None and np.shape(prob[k]) != want[k]:
            raise ValueError(f"expected shape {want[k]}, got {np.shape(prob[k])}")
    return want


def _stage(column: list, shape: tuple, fill: float, dtype, device, pinned: bool):
    """One field of the batch on ``device``: the given values stacked once,
    cast to ``dtype``, into host staging (page-locked when ``pinned``) and
    copied without blocking; a field no problem gives is filled there."""
    if all(v is None for v in column):
        return torch.full((len(column), *shape), fill, dtype=dtype, device=device)
    staging = torch.empty((len(column), *shape), dtype=dtype, pin_memory=pinned)
    if any(v is None for v in column):
        filler = np.full(shape, fill, staging.numpy().dtype)
        column = [filler if v is None else v for v in column]
    np.stack(column, out=staging.numpy(), casting="unsafe")
    return staging.to(device, non_blocking=True)


def _enter(columns: dict, shapes: dict, dtype, device, canonical):
    """An entry's work after its shape check: each field's column staged
    once (``_stage``, page-locked for a CUDA device), then ``canonical`` on
    the staged (B, ...) tensors on the device."""
    device = resolve_device(device)
    pinned = device.type == "cuda"
    entry_batches_by_staging["pinned" if pinned else "pageable"] += 1
    with annotate("piqp.entry.copy"):
        staged = {k: _stage(col, shapes[k], _FILL.get(k, 0.0), dtype, device, pinned)
                  for k, col in columns.items()}
    with annotate("piqp.entry.canonical"):
        return canonical(**staged)


def _symmetric(P):
    """P from its upper triangle (solver.hpp:182)."""
    return torch.triu(P) + torch.triu(P, 1).mT


def _canonical(P, c, A, b, G, h_l, h_u, x_l, x_u) -> QPData:
    """The masked representation of staged (B, ...) fields, elementwise on
    their device: the bounds by ``types.canonical_bounds``, the dead rows
    of G zeroed, the upper triangle of P symmetrized."""
    h_l, h_u, x_l, x_u, hl_mask, hu_mask, xl_mask, xu_mask, dead = canonical_bounds(
        h_l, h_u, x_l, x_u)
    return QPData(
        P=_symmetric(P), c=c, A=A, b=b, G=G.masked_fill(dead[..., None], 0.0),
        h_l=h_l, h_u=h_u, x_l=x_l, x_u=x_u, x_b_scaling=torch.ones_like(c),
        hl_mask=hl_mask, hu_mask=hu_mask, xl_mask=xl_mask, xu_mask=xu_mask,
    )


def prepare_batch(
    problems: Sequence[dict], dtype=torch.float64, device=None
) -> QPData:
    """Stack problem dicts (keys P, c, A, b, G, h_l, h_u, x_l, x_u; one
    (n, p, m) for all) into one batched QPData on ``device`` (CUDA unless
    the caller passes another).  The host checks shapes only; each field is
    stacked once into host staging, page-locked for a CUDA device, and
    copied once; the canonicalization runs on the (B, ...) tensors there."""
    probs = [_fields(**prob) for prob in problems]
    if not probs:
        raise ValueError("no problems to stack")
    shapes = _shapes(probs[0])
    for i, prob in enumerate(probs[1:], 1):
        if _shapes(prob) != shapes:
            raise ValueError(f"problem {i} differs in shape from problem 0")
    return _enter({k: [prob[k] for prob in probs] for k in _FIELDS}, shapes, dtype, device,
                  _canonical)


def prepare_stage_batch(
    problems: Sequence[dict], dtype=torch.float64, device=None
) -> multistage.StageQPData:
    """The stage twin of ``prepare_batch``: stack problem dicts (the
    keyword arguments of ``multistage.from_stage_blocks``: Pd, Psub, Pa, Pc,
    c and optionally A1, A2, Ag, b, G1, G2, Gg, h_l, h_u, x_l, x_u; one
    shape for all) into one batched ``StageQPData`` on ``device`` (CUDA
    unless the caller passes another).  The host fills omitted fields;
    each field is stacked once into host staging and copied once, and the
    canonicalization runs on the (B, ...) tensors there."""
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    return multistage.stage_data_from_arrays(
        [multistage._stage_arrays(**prob, np_dtype=np_dtype) for prob in problems], dtype, device)


def warm_from_result(res: Result) -> BasicVars:
    """The warm-start iterates (x, y, z_*) of a previous ``Result``."""
    return BasicVars(
        x=res.x, y=res.y, z_l=res.z_l, z_u=res.z_u, z_bl=res.z_bl, z_bu=res.z_bu,
    )


def solve_batch(
    data,
    settings: Settings = Settings(),
    cone: bool = True,
    sharding=None,
    chunk: int = 0,
    warm: Optional[object] = None,
) -> Result:
    """Solve a batch of QPs (leading dimension on every field of ``data``,
    a ``QPData`` or a stacked ``multistage.StageQPData``).  The backend
    follows ``settings.kkt_solver`` as in ``api._route_backend``.

    ``sharding``: a ``torch.distributed`` process group
    (``torch.distributed.group.WORLD`` for the default one) to split the
    batch over its ranks (``piqp_tpu/batch.py:89-125`` puts the batch on a
    ``NamedSharding``).  Every rank passes the whole batch (and ``warm``),
    solves its B/world consecutive problems and gets the whole result back
    (one all-gather of the result); B must divide by the group's size.

    ``chunk``: when nonzero and smaller than the batch, solve sub-batches
    of ``chunk`` problems one after the other, which bounds the working
    set.  ``warm``: a previous batched ``Result`` or ``BasicVars`` to
    warm-start from."""
    data = _route_backend(data, settings)
    warm = _warm_vars(warm)
    if sharding is not None:
        world = require_group(sharding)
        if data.B % world:
            raise ValueError(f"a batch of {data.B} does not split over {world} ranks")
        per = data.B // world
        rank = dist.get_rank(sharding)
        mine = slice(rank * per, (rank + 1) * per)
        part = solve_batch(index(data, mine), settings, cone, chunk=chunk,
                           warm=None if warm is None else index(warm, mine))
        return all_gather_tree(part, sharding)
    B = data.B
    if chunk and B > chunk:
        parts = []
        for s in range(0, B, chunk):
            sl = slice(s, s + chunk)
            wpart = None if warm is None else index(warm, sl)
            parts.append(_solve_fresh(index(data, sl), settings, cone, wpart)[0])
        return concat(parts)
    return _solve_fresh(data, settings, cone, warm)[0]


def solve_batch_sqp(
    data,
    settings: Settings = Settings(),
    cone: bool = True,
    rounds: int = 8,
    warm: Optional[object] = None,
    c_rounds: Optional[torch.Tensor] = None,
) -> tuple:
    """``rounds`` warm re-solves of the batch, each from the previous
    round's iterates with a moved linear cost: the SQP/MPC loop
    (``piqp_tpu/batch.py:127-213``, which fuses the rounds into one
    executable; here they are a Python loop over the batched state).

    ``c_rounds``: the cost of each round, (rounds, n) for every problem or
    (B, rounds, n); by default ``c_r = c (1 + 0.01 (r + 1))``.  ``warm``: a
    previous batched ``Result`` or ``BasicVars``; with None a cold
    ``solve_batch`` gives the first iterates.  With
    ``preconditioner_reuse_on_update`` the base data is equilibrated once
    and each round reuses its scaling.  Returns (final_warm: BasicVars,
    statuses (B, rounds) int32, iters (B, rounds) int32)."""
    data = _route_backend(data, settings)
    warm = _warm_vars(warm)
    if warm is None:
        warm = warm_from_result(_solve_fresh(data, settings, cone)[0])
    sc0 = None
    if settings.preconditioner_reuse_on_update:
        _, sc0 = ruiz.equilibrate(
            data, max_iter=settings.preconditioner_iter,
            scale_cost=settings.preconditioner_scale_cost,
        )
    statuses, iters = [], []
    for r in range(rounds):
        if c_rounds is None:
            c_r = data.c * (1.0 + 0.01 * (r + 1.0))
        else:
            c_r = c_rounds[r] if c_rounds.ndim == 2 else c_rounds[:, r]
            c_r = c_r.to(data.c).expand_as(data.c)
        dr = dataclasses.replace(data, c=c_r)
        if sc0 is not None:
            res = solver.solve_scaled(ruiz.apply_scaling(dr, sc0), sc0, settings, cone, warm)
        else:
            res = _solve_fresh(dr, settings, cone, warm)[0]
        warm = warm_from_result(res)
        statuses.append(res.info.status)
        iters.append(res.info.iter)
    return warm, torch.stack(statuses, dim=1), torch.stack(iters, dim=1)


def solve_batch_compact(
    data,
    settings: Settings = Settings(),
    cone: bool = True,
    chunk: int = 0,
    warm: Optional[object] = None,
    phase1_iters: Optional[int] = None,
) -> Result:
    """Two-pass batched solve with straggler compaction
    (``piqp_tpu/batch.py:220-290``).  The batch's loops run until its
    slowest problem stops, so a few hard problems hold the rest: the first
    pass runs with ``max_iter=phase1_iters`` (default 4 when warm-started,
    12 cold; ``chunk`` as in ``solve_batch``), then the problems it left at
    MAX_ITER_REACHED are gathered into one smaller batch and solved warm
    from their first-pass iterates with the full budget.  Their results
    are scattered back, with the first pass's iterations added to
    ``info.iter``.

    Every problem meets the same tolerances as in one pass; the second
    pass is a warm restart, so its iterates differ from a one-pass solve."""
    if phase1_iters is None:
        phase1_iters = 4 if warm is not None else 12
    warm = _warm_vars(warm)
    s1 = dataclasses.replace(settings, max_iter=phase1_iters)
    res1 = solve_batch(data, s1, cone, chunk=chunk, warm=warm)
    stalled = res1.info.status == int(Status.MAX_ITER_REACHED)
    if phase1_iters >= settings.max_iter or not bool(stalled.any()):
        return res1
    idx = torch.nonzero(stalled).squeeze(-1)
    gdata = index(_route_backend(data, settings), idx)
    res2 = _solve_fresh(gdata, settings, cone, index(warm_from_result(res1), idx))[0]
    res2 = dataclasses.replace(res2, info=dataclasses.replace(
        res2.info, iter=res2.info.iter + phase1_iters))
    return index_put(res1, idx, res2)
