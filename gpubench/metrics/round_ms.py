"""round_ms: the window's seconds over the rounds completed in it, in ms:
the fleet's control-step time, every problem's x on the host at its end."""


def read(run):
    return 1e3 * run.window_s / run.rounds if run.rounds else None
