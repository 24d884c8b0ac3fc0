"""The port's spans (``utils/profiling.annotate``) on the CPU: where each
``piqp.*`` span opens, how they nest, how many a solve opens, and that
with no profiler recording a solve enters no ``record_function`` and
gives bitwise the same answer as a traced one."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import piqp_tpu_torch
from piqp_tpu_torch import Settings, batch, prepare_batch, solve_batch, warm_from_result
from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

SOLVED = int(piqp_tpu_torch.Status.SOLVED)
# every setting the dense main path runs: float64, and both phases of mixed
# precision (the benchmark's fleets)
MODES = {"float64": {}, "mixed": {"mixed_precision": True}}


def _problems(count, seed=0):
    return [dense_strongly_convex_qp(12, 3, 5, seed=seed + i) for i in range(count)]


def _spans(prof) -> list:
    """(name, start, end) of the ``piqp.*`` spans of a finished profile, in
    order of start, in µs."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith("piqp.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _named(spans, name) -> list:
    return [s for s in spans if s[0] == name]


def _inside(span, parents) -> bool:
    return any(p[1] <= span[1] and span[2] <= p[2] for p in parents)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_spans_nest_by_layer(mode, warm):
    settings = Settings(**MODES[mode])
    data = prepare_batch(_problems(4), device="cpu")
    start = warm_from_result(solve_batch(data, settings)) if warm else None
    res, spans = _traced(lambda: solve_batch(data, settings, warm=start))
    assert res.info.status.tolist() == [SOLVED] * 4
    solves = _named(spans, "piqp.solve")
    trips = _named(spans, "piqp.ipm.iter")
    assert len(solves) == 1 and len(_named(spans, "piqp.ruiz")) == 1
    assert _inside(_named(spans, "piqp.ruiz")[0], solves)
    assert trips and all(_inside(t, solves) for t in trips)
    for name in ("piqp.kkt.factor", "piqp.kkt.solve"):
        assert _named(spans, name)
        for s in _named(spans, name):
            assert _inside(s, trips + solves), (name, s)
    # a trip holds the factor of its iteration; the ladder's first factor
    # of a cold solve is the only one outside the trips
    outside = [s for s in _named(spans, "piqp.kkt.factor") if not _inside(s, trips)]
    assert len(outside) == (0 if warm else 1)


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_span_counts_of_one_cold_problem(seed):
    """The counts ``api._measure_kkt_times`` scales by: iter + 1 + retries
    factorizations and 2 iter + 1 KKT solves; a trip an iteration, and the
    trip that finds the problem converged."""
    data = prepare_batch(_problems(1, seed), device="cpu")
    res, spans = _traced(lambda: solve_batch(data, Settings()))
    iters, retries = int(res.info.iter[0]), int(res.info.factor_retires[0])
    assert res.info.status.tolist() == [SOLVED] and iters > 0
    assert len(_named(spans, "piqp.kkt.factor")) == iters + 1 + retries
    assert len(_named(spans, "piqp.kkt.solve")) == 2 * iters + 1
    assert len(_named(spans, "piqp.ipm.iter")) == iters + 1


def test_prepare_batch_spans():
    probs = _problems(3)
    data, spans = _traced(lambda: prepare_batch(probs, device="cpu"))
    assert data.B == 3
    assert [s[0] for s in spans] == ["piqp.entry.copy", "piqp.entry.canonical"]
    assert spans[0][2] <= spans[1][1]


def test_prepare_batch_counts_its_staging():
    before = dict(batch.entry_batches_by_staging)
    for calls in (1, 2):
        prepare_batch(_problems(2), device="cpu")
        assert batch.entry_batches_by_staging == dict(
            before, pageable=before["pageable"] + calls)


def test_no_span_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    data = prepare_batch(_problems(2), device="cpu")
    res = solve_batch(data, Settings(mixed_precision=True))
    res = solve_batch(data, Settings(), warm=res)
    assert res.info.status.tolist() == [SOLVED] * 2


@pytest.mark.parametrize("mode", MODES)
def test_profiler_leaves_the_answer_alone(mode):
    settings = Settings(**MODES[mode])
    data = prepare_batch(_problems(4, seed=20), device="cpu")
    off = solve_batch(data, settings)
    on, spans = _traced(lambda: solve_batch(data, settings))
    assert _named(spans, "piqp.ipm.iter")
    assert torch.equal(on.x, off.x)
    assert torch.equal(on.info.status, off.info.status)
    assert torch.equal(on.info.iter, off.info.iter)
