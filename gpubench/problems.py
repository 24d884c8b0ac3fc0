"""A configuration's problems, from its generator and the seed, and their
dense form, which the reference solves.

A configuration file names its generator (``generators/<name>.py``,
found by name: ``generate(**sizes, seed=...)`` returns one problem as a
dict of host numpy arrays) and its fleet: problem i of fleet f is drawn
from the seed ``100000 * 2f + i``.  A generator whose problems are not
dense arrays also gives ``dense(problem, with_cost)``: the problem as
dense P, c, A, b, G, h_l, h_u, x_l, x_u.  This module imports numpy only.
"""

from __future__ import annotations

import numpy as np

from . import byname

SEED_STRIDE = 100_000
COST = ("P", "c")
CONSTRAINTS = ("A", "b", "G", "h_l", "h_u", "x_l", "x_u")


def nonnegative(seed: int) -> int:
    """A one-to-one map of any whole number onto the non-negative ones
    (numpy's generators take no negative seed)."""
    return 2 * seed if seed >= 0 else -2 * seed - 1


def problem_seeds(seed: int, start: int, count: int) -> list:
    """The generator seeds of problems start ... start + count - 1 of
    fleet ``seed``."""
    base = SEED_STRIDE * nonnegative(seed)
    return [base + start + i for i in range(count)]


def generator(config: dict):
    return byname.load("generators", config["generator"])


def make_problems(config: dict, seed: int, start: int = 0, count: int | None = None) -> list:
    """Problems start ... of the configuration as its generator returns
    them (host numpy arrays)."""
    gen = generator(config).generate
    count = config["batch"] if count is None else count
    return [gen(**config["sizes"], seed=s) for s in problem_seeds(seed, start, count)]


def dense_form(config: dict, problems: list, with_cost: bool = True) -> dict:
    """The problems stacked as dense arrays P (B, n, n), c, A, b, G, h_l,
    h_u, x_l, x_u, infinite bounds as +-inf: what the reference solves
    (without P and c unless ``with_cost``)."""
    to_dense = getattr(generator(config), "dense", None)
    if to_dense is not None:
        problems = [to_dense(p, with_cost) for p in problems]
    keys = (COST if with_cost else ()) + CONSTRAINTS
    return {k: np.stack([p[k] for p in problems]) for k in keys}
