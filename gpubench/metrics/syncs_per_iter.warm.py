"""syncs_per_iter.warm: host synchronisations an IPM trip: the runtime's
sync calls (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``) that
start inside the host spans ``piqp.ipm.iter`` (one trip of
``solver.solve_scaled``'s loop and the exit test after it), over the
number of those spans.  Each ``bool(tensor)`` of a CUDA tensor copies it
to the host and waits for the stream: one ``cudaStreamSynchronize``."""

import bisect

SPAN = "piqp.ipm.iter"
CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


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
