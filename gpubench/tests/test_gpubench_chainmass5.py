"""The ``chainmass5`` configuration's own parts: its readers on a trace and
counters made by hand, a traced run of ``chainmass5.warm`` at the
configuration's ``tiny`` size on the CPU, and, on the card, the shapes K2
launches at the published size.  The sound, traced and faulty runs of the
cell (the float32 control and the planted faults among them) are the
cases of ``test_gpubench_faults.py``, which takes every cell of
``BENCHMARK.json`` by name."""

import time

import pytest

from gpubench import harness, mixes, roofline
from gpubench.tests import test_gpubench_span_metrics as span_metrics
from gpubench.tests.test_gpubench_faults import SEED
from gpubench.trace import WINDOW, Event, Trace

CELL = "chainmass5.warm"
MS = 1_000_000  # ns
NEW = ("k2_roofline.warm",)
# the warm readers dense128.warm had, which the cell reports too: each
# finds its spans, counter or device time on the graphed multistage path
SHARED = ("lockstep_iters.warm", "launches_per_round.warm", "device_idle.warm",
          "ipm_idle_ms.warm", "syncs_per_iter.warm", "launches_per_iter.warm",
          "kkt_factor_ms.warm", "kkt_solve_ms.warm", "ruiz_ms.warm", "graph_trip_share.warm")
# on the CPU no kernel runs and no graph is captured: these read nothing
CARD_ONLY = ("k2_roofline.warm", "launches_per_round.warm", "device_idle.warm",
             "graph_trip_share.warm")
# the K2 shapes of one factorization at T = 40, B = 1024: the cyclic
# reduction's levels of 20, 10, 5, 2, 1 and 1 odd blocks, n = D = 24,
# r = 2D = 48 (no arrow)
LEVELS = {20480: 1, 10240: 1, 5120: 1, 2048: 1, 1024: 2}


def read(name, run):
    return harness.metric_reader(name)(run)


def hand_run(counters=None):
    """Two rounds in 100 ms: the span metrics' hand trace and three K2
    kernels (12 ms)."""
    events = span_metrics.hand_trace() + [
        Event("void chol_inv_apply_small_kernel<float, 24>(...)", "kernel", 65 * MS, 70 * MS),
        Event("void chol_inv_apply_small_kernel<double, 24>(...)", "kernel", 70 * MS, 76 * MS),
        Event("void chol_inv_apply_small_kernel<double, 24>(...)", "kernel", 80 * MS, 81 * MS),
    ]
    run = harness.Run({"batch": 1024, "sizes": {"n_mass": 5, "N": 40}}, {"mode": "warm"})
    run.trace = Trace(events, rounds=2)
    run.iters = [5, 6, 7]
    run.counters = counters if counters is not None else {
        "chol_inv.apply_launches_by_shape": {"float32:20480x24x48": 1, "float64:1024x24x48": 2}}
    return run


def test_k2_roofline_prices_each_shape():
    run = hand_run()
    work = (roofline.apply_s(20480, 24, 48, "float32")
            + 2 * roofline.apply_s(1024, 24, 48, "float64"))
    assert read("k2_roofline.warm", run) == pytest.approx(100 * work / 0.012)
    # K2's small shapes are bound by bytes
    assert roofline.apply_s(20480, 24, 48, "float32") == pytest.approx(
        20480 * (24 * 25 / 2 + 2 * 24 * 24 + 2 * 24 * 48) * 4 / 3.35e12)
    assert read("k2_roofline.warm", hand_run({})) is None
    run.trace = Trace([Event(WINDOW, "span", 0, MS)], rounds=1)
    assert read("k2_roofline.warm", run) is None


def test_split_route_counts_its_factor_kernel():
    run = hand_run({"chol_inv.apply_launches_by_shape": {"float32:1280x144x292": 1},
                    "chol_inv.apply_factor_launches_by_route": {"resident": 1, "cluster": 0}})
    # K1's resident kernel [25, 35) ms joins the three K2 kernels
    work = roofline.apply_s(1280, 144, 292, "float32")
    assert read("k2_roofline.warm", run) == pytest.approx(100 * work / 0.022)


def test_k2_roofline_reads_nothing_without_a_trace():
    assert read("k2_roofline.warm", harness.Run({"batch": 1}, {"mode": "warm"})) is None


def test_the_cell_reports_the_new_metrics(tiny_bench):
    spec = harness.load_cell(CELL, tiny_bench)
    assert {m["name"] for m in spec["per_layer"]} == set(NEW) | set(SHARED)
    assert {m["name"] for m in spec["end_to_end"]} == {"round_ms", "round_ms_p90", "setup_s"}
    assert spec["config"]["settings"]["kkt_solver"] == "multistage"


def test_a_traced_tiny_run_reads_the_cpu_metrics(tiny_bench):
    result, numbers = harness.run(CELL, SEED, 1.0, True, time.perf_counter(), device="cpu",
                                  bench_file=tiny_bench)
    assert result["correct"], numbers
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(metrics) == (set(NEW) | set(SHARED)) - set(CARD_ONLY)
    assert metrics["kkt_factor_ms.warm"] > 0 and metrics["kkt_solve_ms.warm"] > 0
    assert metrics["lockstep_iters.warm"] == result["iters_mean"]


def test_every_problem_has_a_feasible_start(tiny_bench):
    config = harness.load_cell(CELL, tiny_bench)["config"]
    problems = mixes.pool(config, {"mode": "warm"}, SEED)[0]
    assert len(problems) == config["batch"] == 4
    assert all(abs(p["x0"]).max() > 0 for p in problems)


@pytest.mark.card
def test_k2_launches_the_levels_of_the_fleet(card):
    """A mixed-precision solve of the published fleet on the card launches
    K2 at exactly the five shapes of a T = 40 factorization in each dtype,
    each level as often as the others and 1024 twice."""
    import torch

    from piqp_tpu_torch import solve_batch
    from piqp_tpu_torch.ops import chol_inv

    spec = harness.load_cell(CELL)
    config = spec["config"]
    batch = mixes.pool(config, spec["traffic"], SEED)[0]
    data = harness.byname.load("entries", config["entry"]).enter(batch, "cuda")
    before = dict(chol_inv.apply_launches_by_shape)
    res = solve_batch(data, harness.settings_of(config))
    torch.cuda.synchronize()
    assert res.info.status.eq(1).all()
    counts = harness.window_counts({"s": before}, {"s": dict(chol_inv.apply_launches_by_shape)})
    counts = {k: v for k, v in counts["s"].items() if v}
    dtypes = {k.split(":")[0] for k in counts}
    assert dtypes == {"float32", "float64"}
    for dtype in dtypes:
        factors = counts[f"{dtype}:20480x24x48"]
        assert {k: v for k, v in counts.items() if k.startswith(dtype)} == {
            f"{dtype}:{N}x24x48": times * factors for N, times in LEVELS.items()}
