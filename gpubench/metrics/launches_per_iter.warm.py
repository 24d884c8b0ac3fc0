"""launches_per_iter.warm: kernel launches an IPM trip: the runtime's and
the driver's launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``)
that start inside the host spans ``piqp.ipm.iter`` (one trip of
``solver.solve_scaled``'s loop and the exit test after it), over the
number of those spans.  A launch the profiler does not see as such a call
is not counted: the hand-written kernels' library (``ops/_build.py``)
links the CUDA runtime statically, and whether its calls reach the trace
is read on the card (PERF.md §3)."""

import bisect

SPAN = "piqp.ipm.iter"
CALLS = ("cudaLaunchKernel", "cuLaunchKernel")


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    spans = sorted((e.start, e.end) for e in t.host
                   if e.kind == "span" and e.name == SPAN and t.start <= e.start < t.end)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    count = 0
    for e in t.host:
        if e.kind != "span" and e.name.startswith(CALLS):
            i = bisect.bisect_right(starts, e.start) - 1
            count += i >= 0 and e.start < spans[i][1]
    return count / len(spans)
