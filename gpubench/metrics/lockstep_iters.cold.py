"""lockstep_iters.cold: the batch's most IPM iterations a round
(Result.info.iter), mean over the window's rounds."""


def read(run):
    return sum(run.iters) / len(run.iters) if run.iters else None
