"""Batched QP solving (``piqp_tpu/batch.py``).

Every module of the port is batch-first, so a batch solve is the plain
solve on data with a leading batch dimension; ``solve_batch`` adds only
the optional chunking.  All problems in a batch share (n, p, m); masks may
differ per problem, and the cone dispatch is one flag for the batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .api import (
    _route_backend,
    _solve_fresh,
    _warm_vars,
    canonical_arrays,
    qpdata_from_arrays,
)
from .types import BasicVars, QPData, Result, Settings, concat, index, resolve_device


def prepare_batch(
    problems: Sequence[dict], dtype=torch.float64, device=None
) -> QPData:
    """Stack problem dicts (keys P, c, A, b, G, h_l, h_u, x_l, x_u) into one
    batched QPData on ``device`` (CUDA unless the caller passes another).
    The canonicalization runs in numpy and each field moves to the device
    once."""
    device = resolve_device(device)
    arrays = [canonical_arrays(**prob, dtype=dtype) for prob in problems]
    return qpdata_from_arrays(
        {k: np.stack([a[k] for a in arrays]) for k in arrays[0]}, device
    )


def warm_from_result(res: Result) -> BasicVars:
    """The warm-start iterates (x, y, z_*) of a previous ``Result``."""
    return BasicVars(
        x=res.x, y=res.y, z_l=res.z_l, z_u=res.z_u, z_bl=res.z_bl, z_bu=res.z_bu,
    )


def solve_batch(
    data,
    settings: Settings = Settings(),
    cone: bool = True,
    chunk: int = 0,
    warm: Optional[object] = None,
) -> Result:
    """Solve a batch of QPs (leading dimension on every field of ``data``,
    a ``QPData`` or a stacked ``multistage.StageQPData``).  The backend
    follows ``settings.kkt_solver`` as in ``api._route_backend``.

    ``chunk``: when nonzero and smaller than the batch, solve sub-batches
    of ``chunk`` problems one after the other, which bounds the working
    set.  ``warm``: a previous batched ``Result`` or ``BasicVars`` to
    warm-start from."""
    data = _route_backend(data, settings)
    warm = _warm_vars(warm)
    B = data.B
    if chunk and B > chunk:
        parts = []
        for s in range(0, B, chunk):
            sl = slice(s, s + chunk)
            wpart = None if warm is None else index(warm, sl)
            parts.append(_solve_fresh(index(data, sl), settings, cone, wpart)[0])
        return concat(parts)
    return _solve_fresh(data, settings, cone, warm)[0]
