"""Parity of the PyTorch port's types and generators with the JAX package:
Settings fields and defaults, Status codes, byte-identical random problems,
and the Settings carry-over of convert.py."""

import dataclasses

import numpy as np
import pytest

import piqp_tpu
from piqp_tpu.utils import random as jax_random

import piqp_tpu_torch
from piqp_tpu_torch import convert
from piqp_tpu_torch.utils import random as torch_random


def test_settings_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(piqp_tpu.Settings)}
    tf = {f.name: f.default for f in dataclasses.fields(piqp_tpu_torch.Settings)}
    assert list(jf) == list(tf)
    for name, default in jf.items():
        if name == "kkt_solver":
            assert tf[name].value == default.value
        else:
            assert tf[name] == default, name
    assert piqp_tpu_torch.Settings().verify()
    assert not piqp_tpu_torch.Settings(eps_abs=-1.0).verify()


def test_settings_carry_over():
    js = piqp_tpu.Settings(mixed_precision=True, eps_abs=1e-7, max_iter=33)
    ts = convert.settings(dataclasses.asdict(js))
    assert ts == piqp_tpu_torch.Settings(mixed_precision=True, eps_abs=1e-7, max_iter=33)


def test_status_codes_match():
    assert {s.name: int(s) for s in piqp_tpu.Status} == {
        s.name: int(s) for s in piqp_tpu_torch.Status
    }
    for s in piqp_tpu.Status:
        assert piqp_tpu_torch.status_to_string(int(s)) == piqp_tpu.status_to_string(int(s))


def test_static_reg_rel_matches():
    for dt in ("float64", "float32"):
        assert (
            piqp_tpu_torch.Settings(dtype=dt).static_reg_rel()
            == piqp_tpu.Settings(dtype=dt).static_reg_rel()
        )


@pytest.mark.parametrize("dims", [(16, 4, 8), (128, 64, 64), (7, 0, 0)])
@pytest.mark.parametrize("seed", [0, 1000, 1023])
def test_random_problems_byte_identical(dims, seed):
    a = jax_random.dense_strongly_convex_qp(*dims, seed=seed)
    b = torch_random.dense_strongly_convex_qp(*dims, seed=seed)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
