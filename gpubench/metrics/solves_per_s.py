"""solves_per_s: every problem solved in the window over the window's
seconds."""


def read(run):
    return run.rounds * run.batch / run.window_s if run.rounds else None
