"""Roofline arithmetic of the factor kernels: the least time an NVIDIA H100
could take for the work, from shapes alone (a frozen copy of
``chip_smoke.py``'s ``_factor_elements`` and ``_bound``).

Peaks are NVIDIA's H100 SXM data sheet figures at the full 700 W limit:
3.35 TB/s of HBM, 67 TFLOP/s of float32 on the CUDA cores (FFMA) and
34 TFLOP/s of float64 on the CUDA cores (DFMA).  ``chip_smoke.py`` takes
67 TFLOP/s for float64, the tensor cores' DMMA rate; the factor kernels
these shares read (K1's resident and cluster routes) run DFMA, so the CUDA-core rate is the one they could
reach.  Bytes bind every shape the benchmark runs either way.

The work is counted whatever implements it: each input byte read once,
each output byte written once, and about n^3/3 flops for a Cholesky
factor and as many for the inverse of the triangle.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
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
