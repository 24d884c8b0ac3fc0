"""Blocked signed Cholesky (LDL^T without pivoting) for quasi-definite KKT
matrices, batched over a leading problem dimension (``piqp_tpu/ops/
ldlt.py``; reference dense::LDLTNoPivot, dense/ldlt_no_pivot.hpp:279-354).

The full 3-block KKT matrix

    [ P + diag(x_reg)   A'                G'                ]
    [ A                 -delta I                            ]
    [ G                                   -diag(z_reg_fact) ]

is quasi-definite, so K = L S L^T exists without pivoting with the signs
known in advance: S = +1 on the n primal rows and -1 on the p+m dual rows
(Vanderbei 1995).  That makes LDL^T a *signed Cholesky* built from
rank-updates and matrix products.

This is the library-free representation of the ``dense_ldlt`` backend
(``Settings.pallas_kernels=False``) and the route above the K3 kernel's
size limit.  A right-looking sweep over column blocks: each diagonal block
is factored with its inverse fused in (``_small_signed_ldl``), the panel
below it is one product against that inverse, the trailing block one
product-downdate, and both solve sweeps are products against the stored
block inverses.  The JAX package's ``lax.fori_loop`` over blocks is a
Python loop here.  A pivot of the wrong sign gives NaN through ``sqrt``
for that problem only.
"""

from __future__ import annotations

import torch

# Default column-block width (the JAX package's).
DEFAULT_BLOCK = 64


def _small_signed_ldl(Skk: torch.Tensor, s: torch.Tensor):
    """Factor (B, bs, bs) diagonal blocks K = L S L^T, S = diag(s) shared by
    the batch; returns (L, Linv) with L lower triangular (diag(L) =
    sqrt|d|) and Linv = L^-1, row j of Linv by substitution at step j."""
    B, bs, _ = Skk.shape
    W = Skk.clone()
    L = torch.zeros_like(Skk)
    Linv = torch.zeros_like(Skk)
    for j in range(bs):
        sj = s[j]
        d = torch.sqrt(W[:, j, j] * sj)  # NaN on a wrong-sign pivot
        lcol = W[:, j:, j] / (sj * d)[:, None]
        L[:, j:, j] = lcol
        if j + 1 < bs:
            tail = lcol[:, 1:]
            W[:, j + 1:, j + 1:] -= (sj * tail)[:, :, None] * tail[:, None, :]
        acc = torch.matmul(L[:, j:j + 1, :j], Linv[:, :j, :]).squeeze(-2)
        row = -acc
        row[:, j] += 1.0
        Linv[:, j, :] = row / d[:, None]
    return L, Linv


def signed_cholesky(K: torch.Tensor, signs: torch.Tensor, block: int = DEFAULT_BLOCK):
    """Blocked K = L S L^T for a (B, N, N) batch, S = diag(signs), signs
    (N,) in {+1, -1}; N must be a multiple of ``block`` (``pad_quasidef``).
    Returns (L (B, N, N), Linvs (B, N/block, block, block)) with the
    inverse of each diagonal block, the solves' currency."""
    B, N, _ = K.shape
    bs = block
    nb = N // bs
    if nb * bs != N:
        raise ValueError(f"signed_cholesky: N = {N} is not a multiple of {bs}")
    W = K.clone()
    Linvs = K.new_zeros((B, nb, bs, bs))
    for k in range(nb):
        off, end = k * bs, (k + 1) * bs
        sk = signs[off:end]
        Lkk, Linvk = _small_signed_ldl(W[:, off:end, off:end], sk)
        # panel: L_ik = K_ik Lkk^-T S_k for rows below the block
        panel = torch.matmul(W[:, end:, off:end], Linvk.mT) * sk
        W[:, off:end, off:end] = Lkk
        W[:, end:, off:end] = panel
        # trailing downdate: W -= panel S_k panel^T
        if end < N:
            W[:, end:, end:] -= torch.matmul(panel * sk, panel.mT)
        Linvs[:, k] = Linvk
    return torch.tril(W), Linvs


def signed_solve(L, Linvs, signs, b):
    """Solve (L S L^T) x = b for b (B, N) with the stored block inverses:
    both sweeps are products against (block, N) strips."""
    _, nb, bs, _ = Linvs.shape
    y = torch.zeros_like(b)
    for k in range(nb):
        off, end = k * bs, (k + 1) * bs
        r = b[:, off:end] - torch.matmul(L[:, off:end, :], y[:, :, None])[..., 0]
        y[:, off:end] = torch.matmul(Linvs[:, k], r[:, :, None])[..., 0]
    z = signs * y
    x = torch.zeros_like(b)
    for k in reversed(range(nb)):
        off, end = k * bs, (k + 1) * bs
        r = z[:, off:end] - torch.matmul(L[:, :, off:end].mT, x[:, :, None])[..., 0]
        x[:, off:end] = torch.matmul(Linvs[:, k].mT, r[:, :, None])[..., 0]
    return x


def blocked_inverse(K: torch.Tensor, signs: torch.Tensor, block: int = DEFAULT_BLOCK):
    """(L, Linv) with the full L^-1 from the blocked factorization, by block
    forward substitution against the identity (``_signed_inv_xla``'s
    counterpart): the route of ``signed_cholesky_with_inverse`` above the
    kernel's size limit."""
    L, Linvs = signed_cholesky(K, signs, block)
    B, N, _ = K.shape
    nb, bs = Linvs.shape[1], Linvs.shape[2]
    eye = torch.eye(N, dtype=K.dtype, device=K.device)
    X = torch.zeros_like(L)
    for k in range(nb):
        off, end = k * bs, (k + 1) * bs
        R = eye[off:end] - torch.matmul(L[:, off:end, :], X)
        X[:, off:end] = torch.matmul(Linvs[:, k], R)
    return L, X


def padded_dim(N: int, block: int = DEFAULT_BLOCK) -> int:
    """Factorization dimension: N rounded up to a multiple of the block
    (at least one block)."""
    return max(block, ((N + block - 1) // block) * block)


def pad_quasidef(K: torch.Tensor, Np: int) -> torch.Tensor:
    """Embed each (N, N) matrix of K into (Np, Np) with identity (sign +1)
    padding."""
    B, N, _ = K.shape
    if N == Np:
        return K
    out = torch.eye(Np, dtype=K.dtype, device=K.device).repeat(B, 1, 1)
    out[:, :N, :N] = K
    return out


def kkt_signs(n: int, p: int, m: int, Np: int, dtype, device) -> torch.Tensor:
    """Sign vector of the 3-block KKT matrix embedded in Np rows: +1 for
    the n primal rows, -1 for the p+m dual rows, +1 padding."""
    s = torch.ones((Np,), dtype=dtype, device=device)
    s[n:n + p + m] = -1.0
    return s
