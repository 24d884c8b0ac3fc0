"""The traffic generator: what each round of a mix solves, from the seed.

A traffic file (``traffic/<name>.json``) names its ``mode``
(``modes/<name>.py``, found by name) and the mode's parameters.  The mode
gives ``Round``, which drives the program a round at a time,
``batch_of(traffic, r)``, the batch of the pool whose constraints round r
solves, and ``problems(config, traffic, seed, r, batches)``, the host
problems of round r.  This module makes the pool and draws the sample
that the check compares.

The reference asks the mode again for each round it checks, so both
sides get the same problems from the seed and the round index alone.
"""

from __future__ import annotations

import numpy as np

from . import byname
from . import problems as pb

# a tag per stream drawn from one seed, so that no two streams share draws
# (modes/warm.py takes 1)
_SAMPLE_STREAM = 2
_ORDER_STREAM = 3


def mode(traffic: dict):
    return byname.load("modes", traffic["mode"])


def pool(config: dict, traffic: dict, seed: int) -> list:
    """The batches a mix solves, as lists of host problems: ``pool`` of
    them (1 where the traffic names none).  Batch k holds problems
    k * B ... (k + 1) * B - 1 of the configuration's fleet (``fleet_seed``,
    the same in every run), in an order drawn from the run's seed: every
    seed gives the program the same work, so that a run's times move with
    the program and not with how many hard problems a seed happens to draw
    (a dense128 fleet's slowest problem sets 10.3 warm iterations a round
    on one seed and 13.1 on another)."""
    B = config["batch"]
    rng = np.random.default_rng([pb.nonnegative(seed), _ORDER_STREAM])
    batches = []
    for k in range(traffic.get("pool", 1)):
        fleet = pb.make_problems(config, config["fleet_seed"], k * B, B)
        batches.append([fleet[i] for i in rng.permutation(B)])
    return batches


def round_problems(config: dict, traffic: dict, seed: int, r: int, batches=None) -> list:
    """The host problems round r solves (dicts of the generator's arrays,
    the round's cost in ``c``)."""
    batches = pool(config, traffic, seed) if batches is None else batches
    return mode(traffic).problems(config, traffic, seed, r, batches)


def sample(traffic: dict, config: dict, seed: int, rounds: int) -> list:
    """The (round, problem indices) pairs a run checks against the
    reference: ``check.rounds`` rounds of the window (window rounds are
    1 ... rounds), each with ``check.problems`` of its problems, drawn from
    the seed."""
    check = config["check"]
    rng = np.random.default_rng([pb.nonnegative(seed), _SAMPLE_STREAM])
    at = rng.random(check["rounds"])
    picks = []
    for u in at:
        r = 1 + int(u * rounds)
        idx = np.sort(rng.choice(config["batch"], size=min(check["problems"], config["batch"]),
                                 replace=False))
        picks.append((r, idx))
    return picks
