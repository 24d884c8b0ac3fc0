"""entry_canonical_ms.cold: host time in the program's
``piqp.entry.canonical`` spans (``batch.prepare_batch``'s numpy
canonicalisation of each problem and the stack of the batch), summed over
the traced window and divided by its rounds, in ms: what the layer costs
the host, its syncs included."""

SPAN = "piqp.entry.canonical"


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    spans = [e for e in t.host
             if e.kind == "span" and e.name == SPAN and t.start <= e.start < t.end]
    if not spans:
        return None
    return 1e-6 * sum(e.end - e.start for e in spans) / t.rounds
