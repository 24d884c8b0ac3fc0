"""Carry state over from the JAX package.

The JAX package's pytrees, with their leaves turned into numpy arrays
(``jax.tree.map(np.asarray, x)`` on the JAX side), become the port's
dataclasses of tensors, so both packages can start a kernel, a KKT solve
or a whole IPM from identical state.  A JAX ``Settings`` comes in as
``dataclasses.asdict``.  For a QP solver this state plays the part that
weights play for a model.

``batched=False`` (the default) reads one problem's state and adds the
leading batch dimension of size 1; ``batched=True`` reads state that
already carries it (the output of ``vmap``).  Nothing here imports the JAX
package: a source is read by attribute name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .kkt import KKTState
from .types import (
    BasicVars,
    Info,
    KKTBackend,
    QPData,
    Result,
    Scaling,
    Settings,
    Vars,
)


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


def qpdata(src, device="cpu", batched: bool = False) -> QPData:
    return _convert(QPData, src, device, batched)


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


def kkt_state(src, device="cpu", batched: bool = False) -> KKTState:
    """A JAX ``KKTState``.  Its factor ``L`` is either one array (the
    Cholesky representation) or an (L, Linv) pair (the inverse
    representation); an all-zero placeholder factor becomes None."""
    factor = src.L if isinstance(src.L, tuple) else (src.L, None)
    L, Linv = (
        None if a is None or not np.any(np.asarray(a)) else _tensor(a, device, batched)
        for a in factor
    )
    return _convert(KKTState, src, device, batched, L=L, Linv=Linv)


def settings(src: dict) -> Settings:
    """A JAX ``Settings`` given as ``dataclasses.asdict(settings)``."""
    fields = dict(src)
    backend = fields["kkt_solver"]
    fields["kkt_solver"] = KKTBackend(getattr(backend, "value", backend))
    return Settings(**fields)
