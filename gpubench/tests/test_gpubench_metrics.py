"""Every metric reader and the trace reduction on numbers made by hand."""

import pytest

from gpubench import harness, roofline
from gpubench.trace import WINDOW, Event, Trace

MS = 1_000_000  # ns


def dense_config():
    return {"batch": 1024, "sizes": {"dim": 128, "n_eq": 64, "n_ineq": 64}}


def hand_trace():
    """A 100 ms window of two rounds: three kernels, a copy, and the host's
    operators around them."""
    return [
        Event(WINDOW, "span", 0, 100 * MS),
        Event("void chol_inv_resident_kernel<float, 4>(...)", "kernel", 10 * MS, 20 * MS),
        Event("void chol_inv_resident_kernel<double, 4>(...)", "kernel", 15 * MS, 30 * MS),
        Event("void at::native::elementwise_kernel<...>", "kernel", 50 * MS, 60 * MS),
        Event("Memcpy DtoH (Device -> Pageable)", "memcpy", 90 * MS, 95 * MS),
        Event("aten::item", "cpu", 30 * MS, 50 * MS),
        Event("cudaStreamSynchronize", "runtime", 35 * MS, 50 * MS),
        Event("aten::copy_", "cpu", 60 * MS, 95 * MS),
        # outside the window: ignored
        Event("void late_kernel", "kernel", 120 * MS, 130 * MS),
    ]


def run_of(config, **kw):
    run = harness.Run(config, {"mode": "warm"})
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def read(name, run):
    return harness.metric_reader(name)(run)


def test_trace_busy_idle_and_breakdown():
    t = Trace(hand_trace(), rounds=2)
    assert t.window_s == pytest.approx(0.1)
    # [10, 30] + [50, 60] + [90, 95] ms
    assert t.busy_s == pytest.approx(0.035)
    assert len(t.kernels()) == 3
    assert t.gaps() == [(0, 10 * MS), (30 * MS, 50 * MS), (60 * MS, 90 * MS), (95 * MS, 100 * MS)]
    idle = dict(t.idle_gaps())
    # the innermost host operation at each gap's middle
    assert idle["cudaStreamSynchronize"] == pytest.approx(0.020)
    assert idle["aten::copy_"] == pytest.approx(0.030)
    assert idle["host, between operators"] == pytest.approx(0.015)
    ops = dict(t.device_ops())
    assert ops["void chol_inv_resident_kernel<double, 4>(...)"] == pytest.approx(0.015)


def test_device_idle_and_launches():
    run = run_of(dense_config(), trace=Trace(hand_trace(), rounds=2))
    assert read("device_idle.warm", run) == pytest.approx(65.0)
    assert read("device_idle.cold", run) == pytest.approx(65.0)
    assert read("launches_per_round.warm", run) == pytest.approx(1.5)
    assert read("device_idle.warm", run_of(dense_config())) is None


def test_k1_roofline():
    counters = {"launches_by_dtype": {"float32": 1, "float64": 1}}
    run = run_of(dense_config(), trace=Trace(hand_trace(), rounds=2), counters=counters)
    work = roofline.factor_s(1024, 128, "float32") + roofline.factor_s(1024, 128, "float64")
    assert read("k1_roofline.warm", run) == pytest.approx(100 * work / 0.025)
    # bytes bind: 1024 lower triangles read, L and Linv written, float32
    assert roofline.factor_s(1024, 128, "float32") == pytest.approx(
        1024 * (128 * 129 / 2 + 2 * 128 * 128) * 4 / 3.35e12)
    run.counters = {"launches_by_dtype": {"float32": 0, "float64": 0}}
    assert read("k1_roofline.warm", run) is None


def test_host_clock_metrics():
    run = run_of(dense_config(), setup_s=12.5, window_s=3.0,
                 round_s=[0.1 * (i + 1) for i in range(10)], iters=[5] * 9 + [8],
                 prepare_s=[0.2, 0.4])
    assert read("setup_s", run) == 12.5
    assert read("round_ms", run) == pytest.approx(300.0)
    # statistics.quantiles' 90th percentile of 100 ... 1000 ms
    assert read("round_ms_p90", run) == pytest.approx(990.0)
    assert read("solves_per_s", run) == pytest.approx(10 * 1024 / 3.0)
    assert read("prepare_ms.cold", run) == pytest.approx(300.0)
    assert read("lockstep_iters.warm", run) == pytest.approx(5.3)
    assert read("lockstep_iters.cold", run) == pytest.approx(5.3)
    assert read("round_ms_p90", run_of(dense_config(), round_s=[0.1] * 9)) is None
    assert read("prepare_ms.cold", run_of(dense_config())) is None


def test_every_metric_of_the_benchmark_has_a_reader():
    import json

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_every_part_of_every_cell_is_found_by_name():
    import json

    from gpubench import byname, mixes, problems as pb

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        spec = harness.load_cell(cell["name"])
        config, traffic = spec["config"], spec["traffic"]
        assert callable(pb.generator(config).generate)
        assert callable(byname.load("entries", config["entry"]).enter)
        mode = mixes.mode(traffic)
        assert callable(mode.Round) and callable(mode.batch_of) and callable(mode.problems)
        assert "sizes" in config["tiny"] and "batch" in config["tiny"]
