"""Roofline arithmetic of the factor kernels: the least time an NVIDIA H100
could take for the work, from shapes alone (frozen copies of
``chip_smoke.py``'s ``_factor_elements`` and ``_bound``, and of its K2
bound).

Peaks are NVIDIA's H100 SXM data sheet figures at the full 700 W limit:
3.35 TB/s of HBM, 67 TFLOP/s of float32 on the CUDA cores (FFMA) and
34 TFLOP/s of float64 on the CUDA cores (DFMA).  ``chip_smoke.py`` takes
67 TFLOP/s for float64, the tensor cores' DMMA rate; the factor kernels
these shares read (K1's resident and cluster routes) run DFMA, so the CUDA-core rate is the one they could
reach.  Bytes bind every shape the benchmark runs either way.

The work is counted whatever implements it: each input byte read once,
each output byte written once, and about n^3/3 flops for a Cholesky
factor and as many for the inverse of the triangle.

K2 (Cholesky with inverse and apply, ``apply_s``) counts its float64
flops at the DMMA rate, 67 TFLOP/s.  Of its routes (``chol_inv.
apply_kernel_route``), ``small`` (n <= 32) and ``resident`` run on the
CUDA cores, FFMA / DFMA; ``split`` runs K1's factor there and its product
Y = Linv'(Linv RHS), 86% of the flops at n = 144, r = 292, on FFMA in
float32 and on DMMA in float64.  At the DFMA rate the float64 split
shape below would read as bound by operations at 0.5308 ms, more than
its route's units need; at the DMMA rate no bound of the small and
resident shapes moves, since bytes bind them even at the DFMA rate.
What binds at ``chip_smoke.py``'s timed K2 shapes (N, n, r):

- (12800, 8, 20), the multistage fleet's first level: bytes, both types;
- (5376, 23, 50), (2560, 48, 100), (2560, 64, 132): bytes, both types;
- (1280, 144, 292), the split route's: operations in float32 (0.2694 ms
  against 0.2079 ms of bytes), bytes in float64 (0.4157 ms).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# float64 on the tensor cores, where K2's split route runs its product
DMMA_FLOPS = 67e12
ITEMSIZE = {"float32": 4, "float64": 8}


def factor_elements(B: int, n: int) -> int:
    """Elements a factor-with-inverse of B symmetric n x n matrices must
    move: each matrix's lower triangle read, its L and Linv written whole
    (zeros included)."""
    return B * (n * (n + 1) // 2 + 2 * n * n)


def bound_s(dtype: str, nbytes: float, flops: float) -> float:
    """The least time on the card's peaks: the larger of bytes over
    bandwidth and flops over the dtype's rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def factor_s(B: int, n: int, dtype: str) -> float:
    """K1: L and Linv of B SPD n x n matrices."""
    return bound_s(dtype, factor_elements(B, n) * ITEMSIZE[dtype], B * 2 * n ** 3 / 3)


def apply_elements(N: int, n: int, r: int) -> int:
    """Elements K2 on N SPD n x n blocks K with n x r right-hand sides must
    move: K's lower triangle and RHS read, L, Linv and Y = K^-1 RHS
    written whole."""
    return factor_elements(N, n) + 2 * N * n * r


def apply_s(N: int, n: int, r: int, dtype: str) -> float:
    """K2: L, Linv and Y of N blocks; N (2n^3/3 + 2n^2 r) flops, the
    factor, its inverse and the two triangular products."""
    rate = DMMA_FLOPS if dtype == "float64" else PEAK_FLOPS[dtype]
    return max(apply_elements(N, n, r) * ITEMSIZE[dtype] / HBM_BYTES_PER_S,
               N * (2 * n ** 3 / 3 + 2 * n * n * r) / rate)
