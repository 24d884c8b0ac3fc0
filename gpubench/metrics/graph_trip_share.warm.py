"""graph_trip_share.warm: the share of the traced window's IPM trips (host
spans ``piqp.ipm.iter``, one trip of ``solver.solve_scaled``'s loop and the
exit test after it) that hold at least one ``piqp.ipm.graph`` span (a
replay of a CUDA graph of the loop's segments), in %.  A window with no
``piqp.ipm.graph`` span at all (a program without the graphs) reads
nothing."""

import bisect

TRIP = "piqp.ipm.iter"
GRAPH = "piqp.ipm.graph"


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    trips = sorted((e.start, e.end) for e in t.host
                   if e.kind == "span" and e.name == TRIP and t.start <= e.start < t.end)
    replays = [e for e in t.host if e.kind == "span" and e.name == GRAPH]
    if not trips or not replays:
        return None
    starts = [s for s, _ in trips]
    held = set()
    for e in replays:
        # trips follow one another: the one that started last before the
        # replay holds it if it ends after it
        i = bisect.bisect_right(starts, e.start) - 1
        if i >= 0 and e.end <= trips[i][1]:
            held.add(i)
    return 100.0 * len(held) / len(trips)
