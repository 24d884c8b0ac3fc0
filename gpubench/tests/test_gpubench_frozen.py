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
