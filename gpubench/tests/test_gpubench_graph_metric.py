"""The reader of ``graph_trip_share.warm`` on traces made by hand: trips
(``piqp.ipm.iter``) with and without a replay span (``piqp.ipm.graph``)."""

import json

import pytest

from gpubench import harness
from gpubench.trace import WINDOW, Event, Trace

MS = 1_000_000  # ns
NAME = "graph_trip_share.warm"


def span(name, start, end):
    return Event(name, "span", start * MS, end * MS)


def read(events, rounds=2):
    run = harness.Run({"batch": 4}, {"mode": "warm"})
    run.trace = Trace(events, rounds)
    return harness.metric_reader(NAME)(run)


def window(*events):
    return [Event(WINDOW, "span", 0, 100 * MS), *events]


def test_share_of_trips_holding_a_replay():
    events = window(
        # trip 1: two replays; trip 2: none (its segments ran eagerly);
        # trip 3: one replay inside a KKT span; trip 4: one
        span("piqp.ipm.iter", 10, 20), span("piqp.ipm.graph", 11, 12),
        span("piqp.ipm.graph", 13, 19),
        span("piqp.ipm.iter", 20, 30), span("piqp.kkt.factor", 21, 25),
        span("piqp.ipm.iter", 40, 50), span("piqp.kkt.solve", 41, 45),
        span("piqp.ipm.graph", 42, 44),
        span("piqp.ipm.iter", 60, 70), span("piqp.ipm.graph", 61, 62),
        # a replay outside every trip (the exit test that opens a loop)
        span("piqp.ipm.graph", 55, 56),
    )
    assert read(events) == pytest.approx(100.0 * 3 / 4)


def test_trips_outside_the_window_are_not_counted():
    events = window(
        span("piqp.ipm.iter", 10, 20), span("piqp.ipm.graph", 11, 12),
        span("piqp.ipm.iter", 20, 30),
        # after the window: a trip with a replay and one without
        span("piqp.ipm.iter", 120, 130), span("piqp.ipm.graph", 121, 122),
        span("piqp.ipm.iter", 130, 140),
    )
    assert read(events) == pytest.approx(50.0)


def test_every_trip_graphed():
    events = window(*[e for k in range(5) for e in (
        span("piqp.ipm.iter", 10 * k, 10 * k + 9),
        span("piqp.ipm.graph", 10 * k + 1, 10 * k + 2))])
    assert read(events) == pytest.approx(100.0)


def test_no_trips_or_no_replays_read_nothing():
    assert read(window(span("piqp.ipm.graph", 11, 12))) is None
    # a program without the graphs: trips, no replay span anywhere
    assert read(window(span("piqp.ipm.iter", 10, 20), span("piqp.ipm.iter", 20, 30))) is None
    assert harness.metric_reader(NAME)(harness.Run({"batch": 4}, {"mode": "warm"})) is None


def test_the_metric_is_in_the_benchmark():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert entry == {"name": NAME, "unit": "%", "better": "higher", "source": "program_span",
                     "layer": "IPM host loop", "moves": "round_ms",
                     "workloads": ["dense128.warm"]}
