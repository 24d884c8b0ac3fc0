"""A stage-structured configuration (``multistage.StageQPData``, the
multistage backend, cyclic reduction at T = 16) runs through the harness
with no file of the benchmark edited: sound and traced runs are
``correct``, each planted fault and the control are not.  The
configuration stands for no deployment."""

import time

import numpy as np
import pytest
import torch

from gpubench import check, harness, mixes
from gpubench import problems as pb
from gpubench.tests import stage_parts
from gpubench.tests.test_gpubench_faults import (SEED, _dense_of, altered, control, half_batch,
                                                 unchanged)
from piqp_tpu_torch import multistage


@pytest.fixture
def stage_bench(tmp_path, monkeypatch):
    """The repo's ``BENCHMARK.json`` plus the test-only stage configuration
    and its cell on the ``warm`` traffic."""
    # stands for no deployment: a configuration the harness has to take by
    # new files only, at a size the CPU holds
    stage_parts.register(monkeypatch.setitem)
    folder = tmp_path / "stage"
    folder.mkdir()
    return stage_parts.write_bench(folder, harness.ROOT / "BENCHMARK.json", stage_parts.config())


def run(bench, solve=None, trace=False):
    return harness.run(stage_parts.CELL, SEED, 1.0, trace, time.perf_counter(), device="cpu",
                       solve=solve, bench_file=bench)


def test_stage_dense_form_is_the_ports(stage_bench):
    config = harness.load_cell(stage_parts.CELL, stage_bench)["config"]
    probs = pb.make_problems(config, 0, 0, 2)
    dense = pb.dense_form(config, probs)
    ref = multistage.to_dense(stage_parts.enter(probs, "cpu"))
    assert multistage._use_cr(config["sizes"]["T"])
    for k in ("P", "c", "A", "b", "G"):
        np.testing.assert_array_equal(dense[k], getattr(ref, k).numpy(), err_msg=k)
    for k, mask, inf in (("h_l", "hl_mask", -np.inf), ("h_u", "hu_mask", np.inf),
                         ("x_l", "xl_mask", -np.inf), ("x_u", "xu_mask", np.inf)):
        np.testing.assert_array_equal(
            dense[k], torch.where(getattr(ref, mask), getattr(ref, k), inf).numpy(), err_msg=k)
    # the control's stand-in reads stage data through the same dense form
    stand_in = _dense_of(stage_parts.enter(probs, "cpu"))
    for k in dense:
        np.testing.assert_array_equal(stand_in[k], dense[k], err_msg=k)


def test_stage_sound_run_is_correct(stage_bench):
    result, numbers = run(stage_bench)
    assert result["correct"], numbers
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"round_ms", "setup_s"}


def test_stage_traced_run_is_correct(stage_bench):
    result, numbers = run(stage_bench, trace=True)
    assert result["correct"], numbers
    assert "lockstep_iters.warm" in result["metrics"]


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered, control],
                         ids=lambda f: f.__name__)
def test_stage_fault_is_not_correct(fault, stage_bench):
    result, numbers = run(stage_bench, solve=fault)
    assert not result["correct"], numbers


def test_counters_keys():
    counters = harness._counters()
    bare = {k for k in counters if "." not in k}
    assert bare == {"launches_by_dtype", "launches_by_route", "apply_launches_by_dtype",
                    "apply_launches_by_route", "apply_factor_launches_by_route"}
    assert all(counters[k] == counters[f"chol_inv.{k}"] for k in bare)
    assert {"chol_inv.launches_by_cluster", "signed_chol_inv.launches_by_dtype",
            "signed_chol_inv.launches_by_route", "signed_chol_inv.launches_by_cluster"} <= set(
        counters)


@pytest.mark.parametrize("cell", ["dense128.warm", stage_parts.CELL])
def test_blocked_primal_check_is_the_whole_batchs(cell, tiny_bench, stage_bench):
    config = harness.load_cell(cell, stage_bench if cell == stage_parts.CELL else tiny_bench)[
        "config"]
    probs = mixes.pool(config, {"mode": "warm"}, SEED)[0]
    n = pb.dense_form(config, probs[:1])["c"].shape[1]
    xs = np.random.default_rng(0).standard_normal((2, len(probs), n))
    whole = check.primal_violation(pb.dense_form(config, probs, with_cost=False), xs, "cpu")
    assert len(probs) == 8
    config["check"]["block"] = 3
    assert check.blocked_primal_violation(config, probs, xs, "cpu") == whole
