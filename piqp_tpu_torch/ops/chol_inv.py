"""Batched Cholesky factorization with fused triangular inverse (K1).

Counterpart of ``piqp_tpu/ops/pallas_chol.py`` for its first kernel,
``_chol_inv_kernel``.  For a (B, n, n) batch of SPD matrices,
``cholesky_with_inverse`` returns L = chol(K) (strict upper triangle zero)
and Linv = L^-1; every later KKT solve is then two matrix products against
Linv (``inv_solve``).

- On a CUDA tensor, ``kernel_route(n, dtype)`` picks one of two
  hand-written kernels (built at first use by ``ops/_build.py``) or the
  library, by shape alone:
  - ``"resident"``, ``csrc/chol_inv_resident.cu``: the matrix stays in one
    block's shared memory, for n <= ``RESIDENT_MAX_N[dtype]`` (240 in
    float32, 169 in float64);
  - ``"cluster"``, the unsigned instance of
    ``csrc/signed_chol_inv_resident.cu`` (K3's kernel with every sign +1):
    the matrix stays in the shared memory of a thread-block cluster of
    ``cluster_size(n, dtype)`` blocks, above that up to n =
    ``MAX_KERNEL_N`` (256): 2 blocks in float32, 2 in float64 up to
    n = 225 and 3 above;
  - ``"library"`` above n = 256, as the JAX package does outside its
    kernel (``_chol_inv_xla``).
  A launch that fails raises; no route stands in for another.
- On a CPU tensor it runs ``chol_inv_reference``, the kernel's plain
  PyTorch version: the same column recurrence, batched over B.

A pivot <= 0 gives non-finite output for its problem only; nothing clamps
it, because the KKT layer turns non-finite factors into a failed
factorization and the IPM then raises the regularization.

The batch is a leading dimension, so the JAX package's single-vs-vmapped
dispatch (``custom_vmap``) has no counterpart here.

K2, ``cholesky_inverse_apply`` (``_chol_inv_apply_kernel``'s counterpart),
adds the two substitution products Y = Linv^T (Linv RHS) = K^-1 RHS to the
same pass.  The multistage backend's cyclic reduction calls it once per
level for all odd blocks.  On a CUDA tensor ``apply_kernel_route(n, dtype,
r)`` picks:
  - ``"small"``, ``csrc/chol_inv_apply_small.cu``, for n <= ``SMALL_MAX_N``
    (32): many matrices per block, each factored in registers by a group of
    ``group_lanes(n)`` lanes, placed by ``small_threads`` and
    ``small_smem_bytes`` (the kernel's own formulas), while one warp's
    matrices fit in shared memory;
  - ``"resident"``, ``csrc/chol_inv_apply_resident.cu``, one block of
    ``resident_apply_threads(n)`` threads per matrix, the n x (n + r) work
    square [K | RHS] in shared memory (``resident_apply_smem_bytes``), for
    every n <= 256 whose square fits one block: with r = 2n + 4, n <= 138
    in float32 and n <= 97 in float64;
  - ``"split"`` for the rest up to n = 256: two launches, K1's kernel on
    the route ``kernel_route(n, dtype)`` names (resident, or cluster with
    ``cluster_size(n, dtype)`` blocks), which writes L and Linv, then the
    product kernel ``csrc/chol_inv_apply_product.cu``, which reads Linv and
    RHS and writes Y (one block per matrix and tile of
    ``product_tile_cols`` right-hand columns, ``product_smem_bytes``); the
    split call counts once in K2's counters and leaves K1's alone, its
    factor's route and cluster size in ``apply_factor_launches_by_route``
    and ``apply_factor_launches_by_cluster``;
  - ``"library"`` above.
On a CPU tensor it runs ``chol_inv_apply_reference``; ``inv_apply_reference``
is the product kernel's plain version.
"""

from __future__ import annotations

import torch

MAX_KERNEL_N = 256
_DTYPES = (torch.float32, torch.float64)
# dynamic shared memory one H100 thread block may opt into (227 KB)
SMEM_PER_BLOCK = 232_448


def resident_smem_bytes(n: int, itemsize: int) -> int:
    """Shared memory of the resident kernel: one n x n work square with an
    odd row pitch (n | 1) and the n-vector of L's diagonal."""
    return (n * (n | 1) + n) * itemsize


# the largest n whose resident working set fits in one block
RESIDENT_MAX_N = {
    str(dt).removeprefix("torch."): max(
        n for n in range(1, MAX_KERNEL_N + 1)
        if resident_smem_bytes(n, dt.itemsize) <= SMEM_PER_BLOCK
    )
    for dt in _DTYPES
}

# The cluster kernel (K1's cluster route and K3): rows of a panel, the unit
# of rows dealt to a cluster's blocks; the largest cluster it takes (float64
# from n = 226 here, 225 in K3); 4-block clusters were twice as slow as 3
# at n = 256 (PERF.md)
PANEL_ROWS = 8
MAX_CLUSTER = 3


def cluster_resident_smem_bytes(n: int, itemsize: int, cluster: int) -> int:
    """Shared memory of one block of the cluster kernel's unsigned
    instance with ``cluster`` blocks per matrix: its rows of the n x (n | 1)
    work square (panels of 8 rows dealt round-robin), an 8-row strip when
    the cluster has more than one block, and L's diagonal."""
    panels = ((n + PANEL_ROWS - 1) // PANEL_ROWS + cluster - 1) // cluster + (cluster > 1)
    return (panels * PANEL_ROWS * (n | 1) + n) * itemsize


def cluster_size(n: int, dtype: torch.dtype) -> int:
    """Blocks per matrix of the cluster route: the smallest cluster whose
    blocks each hold their share of the matrix."""
    c = 1
    while c < MAX_CLUSTER and cluster_resident_smem_bytes(n, dtype.itemsize, c) > SMEM_PER_BLOCK:
        c += 1
    return c

# K2's small kernel: lanes of a block, the largest n it takes
SMALL_THREADS = 64
SMALL_MAX_N = 32


def group_lanes(n: int) -> int:
    """Lanes of the small K2 kernel that factor one matrix: the power of
    two >= n, at least 4."""
    return 4 if n <= 4 else 8 if n <= 8 else 16 if n <= 16 else 32


def step_cols(r: int, itemsize: int) -> int:
    """Right-hand columns a lane of the small K2 kernel takes per step: a
    16-byte vector's worth when r allows, else an 8-byte one, else one."""
    for nbytes in (16, 8):
        if r % (nbytes // itemsize) == 0:
            return nbytes // itemsize
    return 1


def small_smem_bytes(n: int, r: int, itemsize: int, m: int) -> int:
    """Shared memory of a small K2 block of m matrices: K and RHS (then Y),
    each region rounded up to 16 bytes, and two broadcast rows of
    ``step_cols(r) * group_lanes(n)`` values per matrix."""
    return (((m * n * n * itemsize + 15) // 16 + (m * n * r * itemsize + 15) // 16) * 16
            + 2 * m * group_lanes(n) * step_cols(r, itemsize) * itemsize)


def small_threads(n: int, r: int, itemsize: int) -> int:
    """Threads of a small K2 block: 256, halved while its matrices' shared
    memory exceeds a block's; 0 when one warp's does."""
    t = SMALL_THREADS
    while t > 32 and small_smem_bytes(n, r, itemsize, t // group_lanes(n)) > SMEM_PER_BLOCK:
        t //= 2
    return 0 if small_smem_bytes(n, r, itemsize, t // group_lanes(n)) > SMEM_PER_BLOCK else t


# K2's product kernel (the split route's second launch): right-hand columns
# of a block's tile, Linv columns or rows of a streamed panel, and the
# tile's rows in shared memory (n rounded up to 32 in float32, 16 in
# float64), as csrc/chol_inv_apply_product.cu computes them
def product_tile_cols(itemsize: int) -> int:
    return 256 // itemsize


def product_panel_depth(itemsize: int) -> int:
    return 64 // itemsize


def product_tile_rows(n: int, itemsize: int) -> int:
    grain = 128 // itemsize
    return (n + grain - 1) // grain * grain


def product_smem_bytes(n: int, itemsize: int) -> int:
    """Shared memory of a product block: the tile of RHS, then Z (pitch
    ``product_tile_cols + 4``), and two panel slots of Linv (pitch
    ``product_panel_depth + 4``)."""
    rows = product_tile_rows(n, itemsize)
    return (rows * (product_tile_cols(itemsize) + 4)
            + 2 * rows * (product_panel_depth(itemsize) + 4)) * itemsize


def inv_apply_reference(Linv: torch.Tensor, RHS: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the product kernel: Z = Linv RHS and
    Y = Linv^T Z, from Linv's lower triangle only."""
    Lo = torch.tril(Linv)
    return torch.matmul(Lo.mT, torch.matmul(Lo, RHS))


# K2's resident kernel: threads of a block up to n = RESIDENT_APPLY_SMALL_N
# and above it
RESIDENT_APPLY_SMALL_N = 64


def resident_apply_smem_bytes(n: int, r: int, itemsize: int) -> int:
    """Shared memory of the resident K2 kernel: the n x (n + r) work square
    [K | RHS] with an odd row pitch ((n + r) | 1) and L's diagonal."""
    return (n * ((n + r) | 1) + n) * itemsize


def resident_apply_threads(n: int) -> int:
    """Threads of a resident K2 block: 128 up to n = 64, 256 above."""
    return 128 if n <= RESIDENT_APPLY_SMALL_N else 256


# Kernel launches made by ``cholesky_with_inverse`` (never by the plain
# version or the library route), per dtype, per route and, on the cluster
# route, per cluster size (n > RESIDENT_MAX_N needs 2 or 3 blocks);
# ``apply_launches_by_dtype`` and ``apply_launches_by_route`` the same for
# ``cholesky_inverse_apply`` (a split call counts once), and
# ``apply_factor_launches_by_route`` / ``_by_cluster`` the K1 kernel each
# split call launched; ``apply_launches_by_shape`` counts K2's launches of
# every route by ``"<dtype>:<N>x<n>x<r>"`` (a cyclic-reduction level
# launches N = B x its odd blocks), a key appearing at its first launch.
launches_by_dtype = {"float32": 0, "float64": 0}
launches_by_route = {"resident": 0, "cluster": 0}
launches_by_cluster = {c: 0 for c in range(2, MAX_CLUSTER + 1)}
apply_launches_by_dtype = {"float32": 0, "float64": 0}
apply_launches_by_route = {"small": 0, "resident": 0, "split": 0}
apply_factor_launches_by_route = {"resident": 0, "cluster": 0}
apply_factor_launches_by_cluster = {c: 0 for c in range(2, MAX_CLUSTER + 1)}
apply_launches_by_shape: dict = {}
# every counter above, for code that counts launches the launchers do not
# run (a CUDA graph's replay, ``graphs.py``)
COUNTERS = (launches_by_dtype, launches_by_route, launches_by_cluster,
            apply_launches_by_dtype, apply_launches_by_route,
            apply_factor_launches_by_route, apply_factor_launches_by_cluster,
            apply_launches_by_shape)


def kernel_route(n: int, dtype: torch.dtype) -> str:
    """Where a CUDA batch of n x n matrices of ``dtype`` goes: "resident",
    "cluster" (with ``cluster_size(n, dtype)`` blocks per matrix) or
    "library"."""
    if n <= RESIDENT_MAX_N[str(dtype).removeprefix("torch.")]:
        return "resident"
    return "cluster" if n <= MAX_KERNEL_N else "library"


def _check(K: torch.Tensor) -> None:
    if K.dtype not in _DTYPES:
        raise TypeError(f"cholesky_with_inverse takes float32 or float64, got {K.dtype}")
    if K.ndim != 3 or K.shape[-1] != K.shape[-2]:
        raise ValueError(
            f"cholesky_with_inverse takes a (B, n, n) batch, got {tuple(K.shape)}"
        )


def chol_inv_reference(K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the per-column recurrence of
    ``_chol_inv_kernel``, vectorized over the batch.  Step j scales column
    j by 1/sqrt(W[j, j]), subtracts its rank-1 product from the trailing
    block and forms row j of Linv by forward substitution."""
    B, n, _ = K.shape
    W = K.clone()
    Linv = torch.zeros_like(K)
    for j in range(n):
        dinv = torch.rsqrt(W[:, j, j])  # (B,)
        col = W[:, j:, j] * dinv[:, None]
        W[:, j:, j] = col
        if j + 1 < n:
            W[:, j + 1:, j + 1:] -= col[:, 1:, None] * col[:, None, 1:]
        acc = torch.matmul(W[:, j:j + 1, :j], Linv[:, :j, :]).squeeze(-2)
        row = -acc
        row[:, j] += 1.0
        Linv[:, j, :] = row * dinv[:, None]
    return torch.tril(W), Linv


def _chol_inv_library(K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Above the kernel's size limit: library Cholesky and a triangular
    solve against the identity (``_chol_inv_xla``'s counterpart).  Non-PD
    problems get NaN factors, as the kernel gives non-finite ones."""
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where((info == 0)[:, None, None], L, torch.nan)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device).expand_as(K)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def _suffix(dtype: torch.dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def _launch_factor(K: torch.Tensor, route: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the K1 kernel of ``route`` ("resident", or "cluster" with
    ``cluster_size(n, dtype)`` blocks per matrix) on a contiguous CUDA
    batch; counts nothing."""
    from ._build import library

    B, n, _ = K.shape
    L = torch.empty_like(K)
    Linv = torch.empty_like(K)
    fn = getattr(library(), f"piqp_chol_inv_{route}_{_suffix(K.dtype)}")
    cluster = (cluster_size(n, K.dtype),) if route == "cluster" else ()
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        rc = fn(K.data_ptr(), L.data_ptr(), Linv.data_ptr(), B, n, *cluster, stream)
    if rc != 0:
        raise RuntimeError(f"chol_inv {route} kernel launch failed with cudaError_t {rc}")
    return L, Linv


def _launch(K: torch.Tensor, route: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``_launch_factor``, counted in K1's launches."""
    if not K.is_contiguous():
        raise ValueError("cholesky_with_inverse needs a contiguous (B, n, n) tensor")
    L, Linv = _launch_factor(K, route)
    launches_by_dtype[str(K.dtype).removeprefix("torch.")] += 1
    launches_by_route[route] += 1
    if route == "cluster":
        launches_by_cluster[cluster_size(K.shape[-1], K.dtype)] += 1
    return L, Linv


def cholesky_with_inverse(K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, Linv) for a (B, n, n) batch of SPD matrices, float32 or float64.

    CUDA tensor: the resident or the cluster kernel, or the library route,
    as ``kernel_route`` says.  CPU tensor: the plain version.  Any other
    device raises."""
    _check(K)
    if K.device.type == "cpu":
        return chol_inv_reference(K)
    if K.device.type != "cuda":
        raise ValueError(f"cholesky_with_inverse runs on cuda or cpu, not {K.device}")
    route = kernel_route(K.shape[-1], K.dtype)
    if route == "library":
        return _chol_inv_library(K)
    return _launch(K, route)


def inv_solve(Linv: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K^-1 v = Linv^T (Linv v) via the precomputed triangular inverse.
    Shapes: Linv (B, n, n), v (B, n)."""
    y = torch.matmul(Linv, v.unsqueeze(-1))
    return torch.matmul(Linv.mT, y).squeeze(-1)


# ---------------------------------------------------------------------------
# K2: factor + inverse + apply
# ---------------------------------------------------------------------------

def chol_inv_apply_reference(K: torch.Tensor, RHS: torch.Tensor):
    """Plain PyTorch version of K2: ``chol_inv_reference``'s (L, Linv),
    then ``inv_apply_reference``'s Y = Linv^T (Linv RHS)."""
    L, Linv = chol_inv_reference(K)
    return L, Linv, inv_apply_reference(Linv, RHS)


def apply_kernel_route(n: int, dtype: torch.dtype, r: int) -> str:
    """Where a CUDA batch of n x n blocks of ``dtype`` with r right-hand
    columns goes: "small", "resident", "split" or "library"."""
    if n <= SMALL_MAX_N and small_threads(n, r, dtype.itemsize):
        return "small"
    if n > MAX_KERNEL_N:
        return "library"
    if resident_apply_smem_bytes(n, r, dtype.itemsize) <= SMEM_PER_BLOCK:
        return "resident"
    return "split"


def _launch_product(Linv: torch.Tensor, RHS: torch.Tensor) -> torch.Tensor:
    """Launch the product kernel, Y = Linv^T (Linv RHS), on contiguous CUDA
    batches; counts nothing."""
    from ._build import library

    N, n, _ = Linv.shape
    Y = torch.empty_like(RHS)
    fn = getattr(library(), f"piqp_chol_inv_apply_product_{_suffix(Linv.dtype)}")
    with torch.cuda.device(Linv.device):
        stream = torch.cuda.current_stream(Linv.device).cuda_stream
        rc = fn(Linv.data_ptr(), RHS.data_ptr(), Y.data_ptr(), N, n, RHS.shape[-1], stream)
    if rc != 0:
        raise RuntimeError(f"chol_inv_apply product kernel launch failed with cudaError_t {rc}")
    return Y


def _launch_apply(K: torch.Tensor, RHS: torch.Tensor, route: str):
    """Launch the K2 kernel of ``route`` ("small" or "resident"), or the
    split route's two kernels, on a CUDA batch."""
    from ._build import library

    if not (K.is_contiguous() and RHS.is_contiguous()):
        raise ValueError("cholesky_inverse_apply needs contiguous tensors")
    N, n, _ = K.shape
    r = RHS.shape[-1]
    if route == "split":
        factor = kernel_route(n, K.dtype)
        L, Linv = _launch_factor(K, factor)
        Y = _launch_product(Linv, RHS)
        apply_factor_launches_by_route[factor] += 1
        if factor == "cluster":
            apply_factor_launches_by_cluster[cluster_size(n, K.dtype)] += 1
    else:
        L = torch.empty_like(K)
        Linv = torch.empty_like(K)
        Y = torch.empty_like(RHS)
        fn = getattr(library(), f"piqp_chol_inv_apply_{route}_{_suffix(K.dtype)}")
        with torch.cuda.device(K.device):
            stream = torch.cuda.current_stream(K.device).cuda_stream
            rc = fn(K.data_ptr(), RHS.data_ptr(), L.data_ptr(), Linv.data_ptr(),
                    Y.data_ptr(), N, n, r, stream)
        if rc != 0:
            raise RuntimeError(f"chol_inv_apply {route} kernel launch failed with "
                               f"cudaError_t {rc}")
    dtype = str(K.dtype).removeprefix("torch.")
    apply_launches_by_dtype[dtype] += 1
    apply_launches_by_route[route] += 1
    shape = f"{dtype}:{N}x{n}x{r}"
    apply_launches_by_shape[shape] = apply_launches_by_shape.get(shape, 0) + 1
    return L, Linv, Y


def cholesky_inverse_apply(K: torch.Tensor, RHS: torch.Tensor):
    """(L, Linv, Y = K^-1 RHS) for an (N, n, n) batch of SPD blocks and an
    (N, n, r) batch of right-hand blocks, float32 or float64.

    CUDA tensor: the small or resident kernel, the split route's two
    kernels, or the library route with the two products, as
    ``apply_kernel_route`` says.  CPU
    tensor: the plain version.  Any other device raises."""
    _check(K)
    if RHS.dtype != K.dtype or RHS.ndim != 3 or RHS.shape[:2] != K.shape[:2]:
        raise ValueError(
            f"cholesky_inverse_apply takes RHS (N, n, r) of K's dtype, got "
            f"{tuple(RHS.shape)} {RHS.dtype} for K {tuple(K.shape)}"
        )
    if K.device.type == "cpu":
        return chol_inv_apply_reference(K, RHS)
    if K.device.type != "cuda" or RHS.device != K.device:
        raise ValueError(f"cholesky_inverse_apply runs on cuda or cpu, not {K.device}")
    route = apply_kernel_route(K.shape[-1], K.dtype, RHS.shape[-1])
    if route == "library":
        L, Linv = _chol_inv_library(K)
        return L, Linv, torch.matmul(Linv.mT, torch.matmul(Linv, RHS))
    return _launch_apply(K, RHS, route)
