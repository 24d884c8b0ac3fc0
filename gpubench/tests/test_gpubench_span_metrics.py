"""The metric readers of the program's spans (``piqp.*``) on traces made by
hand, and on the CPU profile of a small solve."""

import pytest

from gpubench import harness
from gpubench.trace import WINDOW, Event, Trace

MS = 1_000_000  # ns
SPAN_METRICS = ("ipm_idle_ms.warm", "syncs_per_iter.warm", "launches_per_iter.warm",
                "kkt_factor_ms.warm", "kkt_solve_ms.warm", "ruiz_ms.warm",
                "entry_canonical_ms.cold", "entry_copy_ms.cold")


def span(name, start, end):
    return Event(name, "span", start * MS, end * MS)


def call(name, at, kind="runtime"):
    return Event(name, kind, at * MS, at * MS + MS // 10)


def hand_trace():
    """A 100 ms window of two rounds.  Round 1: the entry, a request with
    Ruiz and two IPM trips; round 2: a request with one trip.  Kernels
    leave the device idle over [0, 25), [35, 62), [64, 100) ms."""
    return [
        Event(WINDOW, "span", 0, 100 * MS),
        span("piqp.entry.canonical", 1, 3),
        span("piqp.entry.copy", 3, 4),
        span("piqp.solve", 5, 60),
        span("piqp.ruiz", 5, 15),
        span("piqp.ipm.iter", 20, 40),
        span("piqp.kkt.factor", 21, 25),
        span("piqp.kkt.solve", 26, 30),
        span("piqp.kkt.solve", 31, 35),
        span("piqp.ipm.iter", 40, 60),
        span("piqp.kkt.factor", 41, 44),
        span("piqp.kkt.solve", 45, 50),
        span("piqp.solve", 61, 90),
        span("piqp.ipm.iter", 70, 80),
        span("piqp.kkt.factor", 71, 73),
        # runtime calls: two launches and a sync in Ruiz, outside every trip
        call("cudaLaunchKernel", 6), call("cudaLaunchKernel", 7),
        call("cudaStreamSynchronize", 12),
        # trip 1: three runtime launches, a driver launch, two syncs
        call("cudaLaunchKernel", 22), call("cudaLaunchKernelExC", 27),
        call("cudaLaunchKernel", 32), call("cuLaunchKernel", 33, kind="cpu"),
        call("cudaStreamSynchronize", 36), call("cudaStreamSynchronize", 39),
        # trip 2: one launch, one sync; trip 3: one launch, a device sync
        call("cudaLaunchKernel", 42), call("cudaStreamSynchronize", 58),
        call("cudaLaunchKernel", 72), call("cudaDeviceSynchronize", 79),
        # the harness's read-back, outside the request
        call("cudaMemcpyAsync", 95),
        Event("void chol_inv_resident_kernel<float, 4>(...)", "kernel", 25 * MS, 35 * MS),
        Event("void at::native::elementwise_kernel<...>", "kernel", 62 * MS, 64 * MS),
        # outside the window: ignored
        span("piqp.ipm.iter", 120, 130),
        span("piqp.ruiz", 120, 130),
        call("cudaStreamSynchronize", 125),
    ]


def run_of(events, rounds=2):
    run = harness.Run({"batch": 4}, {"mode": "warm"})
    run.trace = Trace(events, rounds)
    return run


def read(name, run):
    return harness.metric_reader(name)(run)


def test_host_time_in_spans():
    run = run_of(hand_trace())
    assert read("kkt_factor_ms.warm", run) == pytest.approx((4 + 3 + 2) / 2)
    assert read("kkt_solve_ms.warm", run) == pytest.approx((4 + 4 + 5) / 2)
    assert read("ruiz_ms.warm", run) == pytest.approx(10 / 2)
    assert read("entry_canonical_ms.cold", run) == pytest.approx(2 / 2)
    assert read("entry_copy_ms.cold", run) == pytest.approx(1 / 2)


def test_device_idle_inside_the_trips():
    # trip [20, 40): idle [20, 25) and [35, 40); [40, 60): all idle;
    # [70, 80): all idle
    assert read("ipm_idle_ms.warm", run_of(hand_trace())) == pytest.approx((5 + 5 + 20 + 10) / 2)


def test_syncs_and_launches_per_trip():
    run = run_of(hand_trace())
    # syncs at 36, 39, 58, 79 in three trips; Ruiz's at 12 is outside them
    assert read("syncs_per_iter.warm", run) == pytest.approx(4 / 3)
    # launches at 22, 27, 32, 33 (the driver's), 42, 72
    assert read("launches_per_iter.warm", run) == pytest.approx(6 / 3)


def test_trips_without_calls_read_zero():
    events = [Event(WINDOW, "span", 0, 10 * MS), span("piqp.ipm.iter", 1, 2)]
    run = run_of(events, rounds=1)
    assert read("syncs_per_iter.warm", run) == 0.0
    assert read("launches_per_iter.warm", run) == 0.0
    # no device operation: the whole trip is idle
    assert read("ipm_idle_ms.warm", run) == pytest.approx(1.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_no_span_reads_nothing(name):
    """A program without the spans (a trace of the runtime calls and
    kernels alone) and a run without a trace give no value."""
    bare = [e for e in hand_trace() if e.kind != "span" or e.name == WINDOW]
    assert read(name, run_of(bare)) is None
    assert read(name, harness.Run({"batch": 4}, {"mode": "warm"})) is None


def test_every_span_metric_is_in_the_benchmark():
    import json

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_METRICS:
        assert entries[name]["source"] == "program_span"
        cell = "dense128." + name.rsplit(".", 1)[1]
        assert entries[name]["workloads"] == [cell]


def test_readers_on_a_cpu_profile_of_the_program():
    """The readers find the program's own spans in a profile reduced as the
    harness reduces it: two rounds of a small batch through the entry and a
    warm re-solve."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpubench import trace as tr
    from piqp_tpu_torch import Settings, prepare_batch, solve_batch
    from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

    probs = [dense_strongly_convex_qp(10, 2, 4, seed=i) for i in range(3)]
    settings = Settings(mixed_precision=True)
    last = solve_batch(prepare_batch(probs, device="cpu"), settings)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            for _ in range(2):
                last = solve_batch(prepare_batch(probs, device="cpu"), settings, warm=last)
    assert torch.all(last.info.status == 1)
    run = run_of(tr.from_profiler(prof))
    for name in ("kkt_factor_ms.warm", "kkt_solve_ms.warm", "ruiz_ms.warm",
                 "entry_canonical_ms.cold", "entry_copy_ms.cold", "ipm_idle_ms.warm"):
        assert read(name, run) > 0, name
    # the CPU makes no CUDA runtime call
    assert read("syncs_per_iter.warm", run) == 0.0
    # every factor and KKT solve of a warm round lies in a trip
    trips = [e for e in run.trace.host if e.kind == "span" and e.name == "piqp.ipm.iter"]
    for e in run.trace.host:
        if e.kind == "span" and e.name in ("piqp.kkt.factor", "piqp.kkt.solve"):
            assert any(t.start <= e.start and e.end <= t.end for t in trips), e
