"""launches_per_round.warm: device kernels in the traced window over the
rounds it holds."""


def read(run):
    if run.trace is None or not run.trace.kernels():
        return None
    return len(run.trace.kernels()) / run.trace.rounds
