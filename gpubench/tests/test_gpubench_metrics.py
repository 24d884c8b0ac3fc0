"""Every metric reader and the trace reduction on numbers made by hand."""

import json

import pytest

from gpubench import harness, roofline
from gpubench.tests import test_gpubench_span_metrics as span_metrics
from gpubench.trace import WINDOW, Event, Trace
from piqp_tpu_torch.ops import chol_inv, signed_chol_inv

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
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_every_part_of_every_cell_is_found_by_name():
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


# what the readers of the benchmark's commit before stage configurations
# were taken in (whose harness read ``chol_inv``'s counters alone) gave on
# ``every_metric_run``
BEFORE_STAGES = {
    "round_ms": 300.0, "round_ms_p90": 990.0, "solves_per_s": 3413.3333333333335,
    "setup_s": 12.5, "prepare_ms.cold": 300.00000000000006, "lockstep_iters.warm": 5.3,
    "lockstep_iters.cold": 5.3, "launches_per_round.warm": 1.0,
    "k1_roofline.warm": 2.5079746865671644, "device_idle.warm": 88.0,
    "device_idle.cold": 88.0, "ipm_idle_ms.warm": 20.0,
    "syncs_per_iter.warm": 1.3333333333333333, "launches_per_iter.warm": 2.0,
    "kkt_factor_ms.warm": 4.5, "kkt_solve_ms.warm": 6.5, "ruiz_ms.warm": 5.0,
    "entry_canonical_ms.cold": 1.0, "entry_copy_ms.cold": 0.5,
    "graph_trip_share.warm": 66.66666666666667,
}


def every_metric_run(monkeypatch):
    """One run that every reader finds something in: the span metrics'
    hand trace with two graph replays, host-clock numbers, and the window's
    counters as the harness takes them (K1: 3 float32 and 1 float64
    launches; K2 and K3 launches that no reader counts)."""
    before = harness._counters()
    for d, k in ((chol_inv.launches_by_dtype, "float32"), (chol_inv.launches_by_dtype, "float64"),
                 (chol_inv.apply_launches_by_route, "small"),
                 (signed_chol_inv.launches_by_dtype, "float64")):
        monkeypatch.setitem(d, k, d[k])
    chol_inv.launches_by_dtype["float32"] += 3
    chol_inv.launches_by_dtype["float64"] += 1
    chol_inv.apply_launches_by_route["small"] += 2
    signed_chol_inv.launches_by_dtype["float64"] += 5
    counters = harness.window_counts(before, harness._counters())
    events = span_metrics.hand_trace() + [span_metrics.span("piqp.ipm.graph", 22, 30),
                                          span_metrics.span("piqp.ipm.graph", 71, 72)]
    return run_of(dense_config(), setup_s=12.5, window_s=3.0,
                  round_s=[0.1 * (i + 1) for i in range(10)], iters=[5] * 9 + [8],
                  prepare_s=[0.2, 0.4], trace=Trace(events, rounds=2), counters=counters)


def test_every_reader_reads_as_before_stage_configurations(monkeypatch):
    run = every_metric_run(monkeypatch)
    assert run.counters["launches_by_dtype"] == {"float32": 3, "float64": 1}
    assert run.counters["signed_chol_inv.launches_by_dtype"] == {"float32": 0, "float64": 5}
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert {m["name"]: read(m["name"], run)
            for m in bench["end_to_end"] + bench["per_layer"]} == BEFORE_STAGES


def test_window_counts_a_key_that_appears_in_the_window(monkeypatch):
    monkeypatch.setattr(chol_inv, "apply_launches_by_shape", {(64, 8, 20): 2}, raising=False)
    before = harness._counters()
    chol_inv.apply_launches_by_shape[(64, 8, 20)] += 1
    chol_inv.apply_launches_by_shape[(32, 8, 20)] = 4
    monkeypatch.setattr(signed_chol_inv, "launches_by_shape", {(256, 256): 1}, raising=False)
    counts = harness.window_counts(before, harness._counters())
    assert counts["chol_inv.apply_launches_by_shape"] == {(64, 8, 20): 1, (32, 8, 20): 4}
    assert counts["signed_chol_inv.launches_by_shape"] == {(256, 256): 1}
    assert "apply_launches_by_shape" not in counts
