"""Carry state over from the JAX package.

The JAX package's pytrees, with their leaves turned into numpy arrays
(``jax.tree.map(np.asarray, x)`` on the JAX side), become the port's
dataclasses of tensors, so both packages can start a kernel, a KKT solve
or a whole IPM from identical state.  A JAX ``Settings`` comes in as
``dataclasses.asdict``.  For a QP solver this state plays the part that
weights play for a model.

``batched=False`` (the default) reads one problem's state and adds the
leading batch dimension of size 1; ``batched=True`` reads state that
already carries it (the output of ``vmap``, or a stacked ``StageQPData``).
Nothing here imports the JAX package: a source is read by attribute name,
and its class by its name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .kkt import KKTState
from .multistage import StageQPData
from .types import (
    BasicVars,
    FullKKTQPData,
    Info,
    KKTBackend,
    LDLTKKTQPData,
    QPData,
    Result,
    Scaling,
    Settings,
    Vars,
)

# the port's class for each JAX data class, by name
_DATA_CLASSES = {
    cls.__name__: cls
    for cls in (QPData, FullKKTQPData, LDLTKKTQPData, StageQPData)
}


def _tensor(value, device, batched: bool) -> torch.Tensor:
    t = torch.as_tensor(np.array(value), device=device)
    return t if batched else t[None]


def _convert(cls, src, device, batched: bool, **override):
    fields = {}
    for f in dataclasses.fields(cls):
        if f.name in override:
            fields[f.name] = override[f.name]
        else:
            fields[f.name] = _tensor(getattr(src, f.name), device, batched)
    return cls(**fields)


def qpdata(src, device="cpu", batched: bool = False):
    """A JAX ``QPData``, ``FullKKTQPData``, ``LDLTKKTQPData`` or
    ``StageQPData`` as the port's class of the same name."""
    return _convert(_DATA_CLASSES[type(src).__name__], src, device, batched)


def scaling(src, device="cpu", batched: bool = False) -> Scaling:
    return _convert(Scaling, src, device, batched)


def basic_vars(src, device="cpu", batched: bool = False) -> BasicVars:
    return _convert(BasicVars, src, device, batched)


def vars_(src, device="cpu", batched: bool = False) -> Vars:
    return _convert(Vars, src, device, batched)


def info(src, device="cpu", batched: bool = False) -> Info:
    return _convert(Info, src, device, batched)


def result(src, device="cpu", batched: bool = False) -> Result:
    return _convert(
        Result, src, device, batched, info=info(src.info, device, batched)
    )


def _factor_tree(value, device, batched: bool):
    """A nested tuple of arrays as the same nested tuple of tensors.  The
    one integer leaf any backend keeps, dense_lu's pivots, is 0-based in
    JAX and 1-based (LAPACK's) in ``torch.linalg.lu_solve``."""
    if isinstance(value, tuple):
        return tuple(_factor_tree(v, device, batched) for v in value)
    t = _tensor(value, device, batched)
    return t + 1 if not t.is_floating_point() else t


def kkt_state(src, device="cpu", batched: bool = False, condensed: bool = True) -> KKTState:
    """A JAX ``KKTState``.  ``condensed=True`` (the dense condensed
    backend): its factor ``L`` is either one array (the Cholesky
    representation) or an (L, Linv) pair (the inverse representation),
    and an all-zero placeholder factor becomes None.  ``condensed=False``
    (dense_lu, dense_ldlt, multistage): ``L`` is a tuple or nested tuple
    and becomes ``KKTState.factor`` with the same structure."""
    if not condensed:
        return _convert(KKTState, src, device, batched, L=None, Linv=None,
                        factor=_factor_tree(src.L, device, batched))
    factor = src.L if isinstance(src.L, tuple) else (src.L, None)
    L, Linv = (
        None if a is None or not np.any(np.asarray(a)) else _tensor(a, device, batched)
        for a in factor
    )
    return _convert(KKTState, src, device, batched, L=L, Linv=Linv, factor=None)


def settings(src: dict) -> Settings:
    """A JAX ``Settings`` given as ``dataclasses.asdict(settings)``."""
    fields = dict(src)
    backend = fields["kkt_solver"]
    fields["kkt_solver"] = KKTBackend(getattr(backend, "value", backend))
    return Settings(**fields)
