"""setup_s: process start to the first measured round (import, the kernel
library, the problems from the seed, the warm-up round), host clock."""


def read(run):
    return run.setup_s
