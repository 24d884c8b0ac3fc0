"""ipm_idle_ms.warm: the device's idle time inside the program's IPM trips,
per round, in ms: the traced window's idle gaps (``Trace.gaps()``: no
kernel, copy or fill on the device) intersected with the host spans
``piqp.ipm.iter`` (one trip of ``solver.solve_scaled``'s loop and the exit
test after it), summed over the window and divided by its rounds."""

import bisect

SPAN = "piqp.ipm.iter"


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    spans = [(e.start, e.end) for e in t.host
             if e.kind == "span" and e.name == SPAN and t.start <= e.start < t.end]
    if not spans:
        return None
    gaps = t.gaps()
    ends = [e for _, e in gaps]
    idle = 0
    for s, e in spans:
        # the gaps that end after the span starts, until one starts after it ends
        for gs, ge in gaps[bisect.bisect_right(ends, s):]:
            if gs >= e:
                break
            idle += min(e, ge) - max(s, gs)
    return 1e-6 * idle / t.rounds
