"""The benchmark's frozen copies against the originals they were copied
from: the port's generator (byte-identical arrays), and
``chip_smoke.py``'s KKT check and bound arithmetic."""

import numpy as np
import pytest

import chip_smoke
from gpubench import byname, reference, roofline
from piqp_tpu_torch.utils import random as port_random

SEEDS = [0, 7, 100000 * 2 * 2147483701 + 3]
DENSE = byname.load("generators", "dense_strongly_convex_qp").generate


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


@pytest.mark.parametrize("seed", SEEDS)
def test_dense_generator_is_the_ports(seed):
    _same(DENSE(128, 64, 64, seed=seed),
          port_random.dense_strongly_convex_qp(128, 64, 64, seed=seed))


def test_optimality_is_chip_smokes():
    prob = DENSE(12, 4, 5, seed=3)
    rng = np.random.default_rng(1)
    args = [rng.standard_normal(n) for n in (12, 4, 5, 5, 12, 12)]
    assert reference.optimality(prob, *args) == chip_smoke._optimality(prob, *args)


def test_factor_arithmetic_is_chip_smokes():
    assert roofline.factor_elements(1024, 128) == chip_smoke._factor_elements(1024, 128)
    # float32: the same peaks, so the same bound
    nbytes = roofline.factor_elements(1024, 128) * 4
    flops = 1024 * 2 * 128 ** 3 / 3
    assert roofline.factor_s(1024, 128, "float32") * 1e3 == pytest.approx(
        chip_smoke._bound("float32", nbytes, flops)[0])


K2_TIMED = [chip_smoke.K2_FLEET, *chip_smoke.K2_MS48, chip_smoke.K2_SPLIT_TIMED]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", K2_TIMED, ids=lambda s: "N%d_n%d_r%d" % s)
def test_apply_arithmetic_is_chip_smokes(shape, dtype):
    """K2's bound, ``chip_smoke.py``'s at the fleets' timed shapes: the
    same bytes and flops; float64 flops at the DMMA rate, as there."""
    N, n, r = shape
    size = {"float32": 4, "float64": 8}[dtype]
    nbytes = (chip_smoke._factor_elements(N, n) + 2 * N * n * r) * size
    assert roofline.apply_elements(N, n, r) * size == nbytes
    flops = N * (2 * n ** 3 / 3 + 2 * n * n * r)
    assert roofline.apply_s(N, n, r, dtype) * 1e3 == pytest.approx(
        chip_smoke._bound(dtype, nbytes, flops)[0], rel=1e-12)


def test_apply_arithmetic_binds_as_documented():
    # bytes bind the small and resident routes' timed shapes; the split
    # shape is bound by operations in float32 and by bytes in float64
    for N, n, r in [chip_smoke.K2_FLEET, chip_smoke.K2_D23, *chip_smoke.K2_MS48,
                    *chip_smoke.K2_WIDE_TIMED]:
        for dtype in ("float32", "float64"):
            assert roofline.apply_s(N, n, r, dtype) == pytest.approx(
                roofline.apply_elements(N, n, r) * roofline.ITEMSIZE[dtype] / 3.35e12)
    N, n, r = chip_smoke.K2_SPLIT_TIMED
    assert roofline.apply_s(N, n, r, "float32") == pytest.approx(
        N * (2 * n ** 3 / 3 + 2 * n * n * r) / 67e12)
    assert roofline.apply_s(N, n, r, "float64") == pytest.approx(
        roofline.apply_elements(N, n, r) * 8 / 3.35e12)
