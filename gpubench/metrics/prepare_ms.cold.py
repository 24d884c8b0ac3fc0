"""prepare_ms.cold: the program's entry (canonicalisation and the copies to
the card) a round, mean over the window, in ms: the benchmark's own span
around the entry call, host clock."""


def read(run):
    return 1e3 * sum(run.prepare_s) / len(run.prepare_s) if run.prepare_s else None
