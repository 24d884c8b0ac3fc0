"""A whole run of each cell on the CPU at its ``tiny`` size, sound and with
the timed path broken underneath: every planted fault, and the control
(the reference in float32 in the program's place), turn ``correct``
false.  The exchange between chips is not a fault these cells can have:
each runs on one chip."""

import dataclasses
import json
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import piqp_tpu_torch
from gpubench import harness, reference
from piqp_tpu_torch import multistage

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2147483901


def run(cell, bench, solve=None, trace=False):
    result, numbers = harness.run(cell, SEED, 1.0, trace, time.perf_counter(), device="cpu",
                                  solve=solve, bench_file=bench)
    return result, numbers


def unchanged(data, settings, warm=None):
    """A solve that returns its state unchanged: the warm start it was
    given, or the zero point it starts a cold solve from."""
    res = piqp_tpu_torch.solve_batch(data, settings, warm=warm)
    if warm is not None and dataclasses.is_dataclass(warm):
        return dataclasses.replace(res, x=warm.x.clone())
    return dataclasses.replace(res, x=torch.zeros_like(res.x))


def half_batch(data, settings, warm=None):
    """Half of the batch left out, the mean of the rest in its place."""
    res = piqp_tpu_torch.solve_batch(data, settings, warm=warm)
    x = res.x.clone()
    h = x.shape[0] // 2
    x[h:] = x[:h].mean(0)
    return dataclasses.replace(res, x=x)


def altered(data, settings, warm=None):
    """One answer altered where it is produced."""
    res = piqp_tpu_torch.solve_batch(data, settings, warm=warm)
    x = res.x.clone()
    x[-1, 0] += 1e-2 * max(1.0, float(x[-1].abs().max()))
    return dataclasses.replace(res, x=x)


def _dense_of(data) -> dict:
    """The problems of a batch as ``problems.dense_form`` gives them; stage
    data (``multistage.StageQPData``) by way of its dense equivalent."""
    if isinstance(data, multistage.StageQPData):
        data = multistage.to_dense(data)

    def bound(v, mask, inf):
        return torch.where(mask, v, inf).numpy()

    return dict(P=data.P.numpy(), c=data.c.numpy(), A=data.A.numpy(), b=data.b.numpy(),
                G=data.G.numpy(), h_l=bound(data.h_l, data.hl_mask, -np.inf),
                h_u=bound(data.h_u, data.hu_mask, np.inf),
                x_l=bound(data.x_l, data.xl_mask, -np.inf),
                x_u=bound(data.x_u, data.xu_mask, np.inf))


def control(data, settings, warm=None):
    """The reference computed in float32, in the program's place."""
    x = reference.solve(_dense_of(data), dtype=torch.float32)[0]
    B = x.shape[0]
    info = types.SimpleNamespace(status=torch.ones(B, dtype=torch.int32),
                                 iter=torch.zeros(B, dtype=torch.int32))
    return types.SimpleNamespace(x=torch.as_tensor(x), info=info)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny_bench):
    result, numbers = run(cell, tiny_bench)
    assert result["correct"], numbers
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "check"
    assert result["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_is_correct(cell, tiny_bench):
    result, numbers = run(cell, tiny_bench, trace=True)
    assert result["correct"], numbers
    assert result["device"]["window_s"] > 0
    assert "setup_s" not in result["metrics"]


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered, control],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, tiny_bench):
    result, numbers = run(cell, tiny_bench, solve=fault)
    assert not result["correct"], numbers


def test_not_solved_is_not_correct(tiny_bench):
    def stalled(data, settings, warm=None):
        res = piqp_tpu_torch.solve_batch(data, settings, warm=warm)
        status = res.info.status.clone()
        status[0] = -1
        return dataclasses.replace(res, info=dataclasses.replace(res.info, status=status))

    result, _ = run("dense128.warm", tiny_bench, solve=stalled)
    assert not result["correct"]
    assert result["failed"] == result["attempted"] // 8


def test_without_a_card_no_result():
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", "dense128.warm",
         "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=harness.ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", "dense128.warm",
         "--seed", "5", "--seconds", "2"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.splitlines()[-1])["correct"]


@pytest.mark.parametrize("name", ["jax", "piqp_tpu.ops"])
def test_jax_loaded_is_no_result(name, tiny_bench, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    with pytest.raises(RuntimeError, match="may not load"):
        run("dense128.warm", tiny_bench)
