"""round_ms_p90: the 90th percentile of the window's round times, in ms
(statistics.quantiles, n = 10; at least 10 rounds)."""

import statistics


def read(run):
    if run.rounds < 10:
        return None
    return statistics.quantiles([1e3 * s for s in run.round_s], n=10)[8]
