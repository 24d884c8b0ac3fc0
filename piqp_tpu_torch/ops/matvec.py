"""Batched problem-structure matvecs (dense registrations of
``piqp_tpu/ops/matvec.py``; the backend's eval_* surface,
kkt_solver_base.hpp:21-44).

Every function takes batched data (leading dimension B) and batched
vectors (B, k) and returns (B, k') vectors: one batched matrix-vector
product per block, never a reduction across problems.  Each op dispatches
on the data's type (``functools.singledispatch``, as in the JAX package):
the registrations here are the dense ``QPData`` ones, and
``multistage.py`` registers the stage-block ones.  The JAX package
stacks [P; A; G] into one product because XLA hoists the concatenation out
of its loop; eager PyTorch would copy the matrices on every call, so here
each block is its own product.
"""

from __future__ import annotations

import dataclasses
from functools import singledispatch

import torch

from ..types import QPData


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M @ x per problem: (B, r, k) x (B, k) -> (B, r)."""
    return torch.matmul(M, x.unsqueeze(-1)).squeeze(-1)


def _mtv(M: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """M.T @ y per problem: (B, r, k) x (B, r) -> (B, k)."""
    return torch.matmul(y.unsqueeze(-2), M).squeeze(-2)


@singledispatch
def P_x(data, x):
    """P @ x."""
    raise NotImplementedError(type(data))


@P_x.register
def _(data: QPData, x):
    return _mv(data.P, x)


@singledispatch
def P_diag(data):
    """Diagonal of P (static-regularization sizing, kkt_system.hpp:195-207)."""
    raise NotImplementedError(type(data))


@P_diag.register
def _(data: QPData):
    return torch.diagonal(data.P, dim1=-2, dim2=-1)


@singledispatch
def A_x(data, x):
    """A @ x -> (B, p)."""
    raise NotImplementedError(type(data))


@A_x.register
def _(data: QPData, x):
    return _mv(data.A, x)


@singledispatch
def AT_y(data, y):
    """A.T @ y -> (B, n)."""
    raise NotImplementedError(type(data))


@AT_y.register
def _(data: QPData, y):
    return _mtv(data.A, y)


@singledispatch
def G_x(data, x):
    """G @ x -> (B, m)."""
    raise NotImplementedError(type(data))


@G_x.register
def _(data: QPData, x):
    return _mv(data.G, x)


@singledispatch
def GT_z(data, z):
    """G.T @ z -> (B, n)."""
    raise NotImplementedError(type(data))


@GT_z.register
def _(data: QPData, z):
    return _mtv(data.G, z)


def _empty(x, k: int = 0):
    return x.new_zeros(x.shape[:-1] + (k,))


@singledispatch
def PAG_x(data, x):
    """(P@x, A@x, G@x); an empty block gives a (B, 0) vector."""
    Ax = A_x(data, x) if data.p else _empty(x)
    Gx = G_x(data, x) if data.m else _empty(x)
    return P_x(data, x), Ax, Gx


@singledispatch
def AG_x(data, x):
    """(A@x, G@x)."""
    Ax = A_x(data, x) if data.p else _empty(x)
    Gx = G_x(data, x) if data.m else _empty(x)
    return Ax, Gx


@singledispatch
def add_AtGt(data, rx, y, z):
    """rx + A.T@y + G.T@z."""
    if data.p:
        rx = rx + AT_y(data, y)
    if data.m:
        rx = rx + GT_z(data, z)
    return rx


@singledispatch
def abs_data(data):
    """The same data with the matrix blocks replaced by their absolute
    values: the matvecs on it with |v| give the cancellation denominators
    of the Farkas-certificate checks (solver._certificate_qualities)."""
    raise NotImplementedError(type(data))


@abs_data.register
def _(data: QPData) -> QPData:
    return dataclasses.replace(
        data, P=data.P.abs(), A=data.A.abs(), G=data.G.abs()
    )
