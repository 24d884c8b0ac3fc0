"""Batched problem-structure matvecs (dense registrations of
``piqp_tpu/ops/matvec.py``; the backend's eval_* surface,
kkt_solver_base.hpp:21-44).

Every function takes batched data (leading dimension B) and batched
vectors (B, k) and returns (B, k') vectors: one batched matrix-vector
product per block, never a reduction across problems.  The JAX package
stacks [P; A; G] into one product because XLA hoists the concatenation out
of its loop; eager PyTorch would copy the matrices on every call, so here
each block is its own product.
"""

from __future__ import annotations

import dataclasses

import torch

from ..types import QPData


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M @ x per problem: (B, r, k) x (B, k) -> (B, r)."""
    return torch.matmul(M, x.unsqueeze(-1)).squeeze(-1)


def _mtv(M: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """M.T @ y per problem: (B, r, k) x (B, r) -> (B, k)."""
    return torch.matmul(y.unsqueeze(-2), M).squeeze(-2)


def P_x(data: QPData, x):
    """P @ x."""
    return _mv(data.P, x)


def P_diag(data: QPData):
    """Diagonal of P (static-regularization sizing, kkt_system.hpp:195-207)."""
    return torch.diagonal(data.P, dim1=-2, dim2=-1)


def A_x(data: QPData, x):
    """A @ x -> (B, p)."""
    return _mv(data.A, x)


def AT_y(data: QPData, y):
    """A.T @ y -> (B, n)."""
    return _mtv(data.A, y)


def G_x(data: QPData, x):
    """G @ x -> (B, m)."""
    return _mv(data.G, x)


def GT_z(data: QPData, z):
    """G.T @ z -> (B, n)."""
    return _mtv(data.G, z)


def _empty(x, k: int = 0):
    return x.new_zeros(x.shape[:-1] + (k,))


def PAG_x(data: QPData, x):
    """(P@x, A@x, G@x); an empty block gives a (B, 0) vector."""
    Ax = A_x(data, x) if data.p else _empty(x)
    Gx = G_x(data, x) if data.m else _empty(x)
    return P_x(data, x), Ax, Gx


def AG_x(data: QPData, x):
    """(A@x, G@x)."""
    Ax = A_x(data, x) if data.p else _empty(x)
    Gx = G_x(data, x) if data.m else _empty(x)
    return Ax, Gx


def add_AtGt(data: QPData, rx, y, z):
    """rx + A.T@y + G.T@z."""
    if data.p:
        rx = rx + AT_y(data, y)
    if data.m:
        rx = rx + GT_z(data, z)
    return rx


def abs_data(data: QPData) -> QPData:
    """The same data with the matrix blocks replaced by their absolute
    values: the matvecs on it with |v| give the cancellation denominators
    of the Farkas-certificate checks (solver._certificate_qualities)."""
    return dataclasses.replace(
        data, P=data.P.abs(), A=data.A.abs(), G=data.G.abs()
    )
