"""kkt_solve_ms.warm: host time in the program's ``piqp.kkt.solve`` spans
(``kkt.solve``: the condensed right-hand side, the condensed solve,
iterative refinement and the slack and dual recovery), summed over the
traced window and divided by its rounds, in ms: what the layer costs the
host, its syncs included."""

SPAN = "piqp.kkt.solve"


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    spans = [e for e in t.host
             if e.kind == "span" and e.name == SPAN and t.start <= e.start < t.end]
    if not spans:
        return None
    return 1e-6 * sum(e.end - e.start for e in spans) / t.rounds
