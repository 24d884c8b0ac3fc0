"""entry_copy_ms.cold: host time in the program's ``piqp.entry.copy`` spans
(``batch.prepare_batch``'s host-to-device copies, one a field), summed
over the traced window and divided by its rounds, in ms: what the layer
costs the host, its syncs included."""

SPAN = "piqp.entry.copy"


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    spans = [e for e in t.host
             if e.kind == "span" and e.name == SPAN and t.start <= e.start < t.end]
    if not spans:
        return None
    return 1e-6 * sum(e.end - e.start for e in spans) / t.rounds
