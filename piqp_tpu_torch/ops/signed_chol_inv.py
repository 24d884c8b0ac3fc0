"""Batched signed Cholesky with fused triangular inverse (K3).

Counterpart of ``piqp_tpu/ops/pallas_chol.py``'s third kernel,
``_signed_chol_inv_kernel``.  For a (B, n, n) batch of quasi-definite
matrices and one sign vector S = diag(signs), signs (n,) in {+1, -1}
shared by the batch, ``signed_cholesky_with_inverse`` returns L with
K = L S L^T (lower, diag(L) = sqrt|pivot|) and Linv = L^-1; a solve is
then two matrix products and a sign flip (``signed_inv_solve``).  It is
the explicit-inverse factorization of the ``dense_ldlt`` backend.

- On a CUDA tensor, ``kernel_route(n, dtype)`` picks the route by shape:
  - ``"resident"`` for every n <= ``MAX_KERNEL_N`` (256): the hand-written
    kernel ``csrc/signed_chol_inv_resident.cu`` (built at first use by
    ``ops/_build.py``), with the matrix resident in the shared memory of a
    cluster of ``cluster_size(n, dtype)`` thread blocks: 1 up to n = 239
    in float32 and n = 168 in float64, then 2, and 3 in float64 from
    n = 225;
  - ``"blocked"`` above n = 256: ``ops/ldlt.blocked_inverse``, library
    products in a loop over column blocks with a block forward
    substitution for the full inverse, as the JAX package does outside its
    kernel (``_signed_inv_xla``).
  A launch that fails raises; no route stands in for another.
- On a CPU tensor it runs ``signed_chol_inv_reference``, the kernel's
  plain PyTorch version: the same column recurrence, batched over B.

A pivot whose sign disagrees with S gives non-finite output for its
problem only; nothing clamps it.
"""

from __future__ import annotations

import torch

from . import ldlt
# the cluster kernel's layout, shared with K1's cluster route
from .chol_inv import (
    MAX_CLUSTER, MAX_KERNEL_N, PANEL_ROWS, SMEM_PER_BLOCK, cluster_resident_smem_bytes,
)

_DTYPES = (torch.float32, torch.float64)


def resident_smem_bytes(n: int, itemsize: int, cluster: int) -> int:
    """Shared memory of one block of the resident kernel with ``cluster``
    blocks per matrix: K1's cluster layout (``cluster_resident_smem_bytes``:
    its rows of the work square, the strip, L's diagonal) and the signs."""
    return cluster_resident_smem_bytes(n, itemsize, cluster) + n * itemsize


def cluster_size(n: int, dtype: torch.dtype) -> int:
    """Blocks per matrix of the resident kernel: the smallest cluster whose
    blocks each hold their share of the matrix."""
    c = 1
    while c < MAX_CLUSTER and resident_smem_bytes(n, dtype.itemsize, c) > SMEM_PER_BLOCK:
        c += 1
    return c


# Kernel launches made by ``signed_cholesky_with_inverse`` (never by the
# plain version or the blocked route), per dtype, per route and per cluster
# size.
launches_by_dtype = {"float32": 0, "float64": 0}
launches_by_route = {"resident": 0}
launches_by_cluster = {c: 0 for c in range(1, MAX_CLUSTER + 1)}


def kernel_route(n: int, dtype: torch.dtype) -> str:
    """Where a CUDA batch of n x n matrices of ``dtype`` goes: "resident"
    (with ``cluster_size(n, dtype)`` blocks per matrix) or "blocked"."""
    return "resident" if n <= MAX_KERNEL_N else "blocked"


def _check(K: torch.Tensor, signs: torch.Tensor) -> None:
    if K.dtype not in _DTYPES:
        raise TypeError(
            f"signed_cholesky_with_inverse takes float32 or float64, got {K.dtype}"
        )
    if K.ndim != 3 or K.shape[-1] != K.shape[-2]:
        raise ValueError(
            f"signed_cholesky_with_inverse takes a (B, n, n) batch, got {tuple(K.shape)}"
        )
    if signs.shape != (K.shape[-1],):
        raise ValueError(
            f"signed_cholesky_with_inverse takes one (n,) sign vector, got "
            f"{tuple(signs.shape)} for n = {K.shape[-1]}"
        )


def signed_chol_inv_reference(K: torch.Tensor, signs: torch.Tensor):
    """Plain PyTorch version of the kernel: the recurrence of
    ``_signed_chol_inv_kernel``, vectorized over the batch.  Step j scales
    column j by s_j / sqrt(s_j W[j, j]), subtracts its signed rank-1
    product from the trailing block and forms row j of Linv."""
    B, n, _ = K.shape
    W = K.clone()
    Linv = torch.zeros_like(K)
    s = signs.to(K.dtype)
    for j in range(n):
        sj = s[j]
        dinv = torch.rsqrt(W[:, j, j] * sj)  # (B,)
        colT = W[:, j:, j] * dinv[:, None]  # = L[:, j] * s_j
        W[:, j:, j] = colT * sj
        if j + 1 < n:
            W[:, j + 1:, j + 1:] -= (colT[:, 1:] * sj)[:, :, None] * colT[:, None, 1:]
        acc = torch.matmul(W[:, j:j + 1, :j], Linv[:, :j, :]).squeeze(-2)
        row = -acc
        row[:, j] += 1.0
        Linv[:, j, :] = row * dinv[:, None]
    return torch.tril(W), Linv


def _launch(K: torch.Tensor, signs: torch.Tensor):
    """Launch the resident kernel on a CUDA batch, with ``cluster_size(n,
    dtype)`` blocks per matrix."""
    from ._build import library

    if not K.is_contiguous():
        raise ValueError("signed_cholesky_with_inverse needs a contiguous (B, n, n) tensor")
    B, n, _ = K.shape
    s = signs.to(K.dtype).contiguous()
    L = torch.empty_like(K)
    Linv = torch.empty_like(K)
    suffix = "f32" if K.dtype == torch.float32 else "f64"
    fn = getattr(library(), f"piqp_signed_chol_inv_resident_{suffix}")
    cluster = cluster_size(n, K.dtype)
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        rc = fn(K.data_ptr(), s.data_ptr(), L.data_ptr(), Linv.data_ptr(), B, n, cluster, stream)
    if rc != 0:
        raise RuntimeError(f"signed_chol_inv resident kernel launch failed with cudaError_t {rc}")
    launches_by_dtype[str(K.dtype).removeprefix("torch.")] += 1
    launches_by_route["resident"] += 1
    launches_by_cluster[cluster] += 1
    return L, Linv


def signed_cholesky_with_inverse(K: torch.Tensor, signs: torch.Tensor):
    """(L, Linv) with K = L diag(signs) L^T for a (B, n, n) batch and one
    (n,) sign vector, float32 or float64.

    CUDA tensor: the resident kernel (n <= 256) or the blocked route (n >
    256, n a multiple of ``ldlt.DEFAULT_BLOCK``), as ``kernel_route`` says.
    CPU tensor: the plain version.  Any other device raises."""
    _check(K, signs)
    if K.device.type == "cpu":
        return signed_chol_inv_reference(K, signs)
    if K.device.type != "cuda" or signs.device != K.device:
        raise ValueError(f"signed_cholesky_with_inverse runs on cuda or cpu, not {K.device}")
    if kernel_route(K.shape[-1], K.dtype) == "blocked":
        return ldlt.blocked_inverse(K, signs.to(K.dtype))
    return _launch(K, signs)


def signed_inv_solve(Linv: torch.Tensor, signs: torch.Tensor, v: torch.Tensor):
    """(L S L^T)^-1 v = Linv^T (S (Linv v)): two products and a sign flip.
    Shapes: Linv (B, n, n), signs (n,), v (B, n)."""
    y = torch.matmul(Linv, v.unsqueeze(-1)).squeeze(-1)
    return torch.matmul((signs * y).unsqueeze(-2), Linv).squeeze(-2)
