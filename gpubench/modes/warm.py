"""The mode ``warm``, the MPC/SQP loop closed: one batch of the
configuration's fleet, entered once at set-up and cold-solved there; round
r solves it with the cost c + ``scale`` N(0, 1), the perturbation
``r % perturbations`` of a set drawn from the seed, uploaded that round,
warm-started from round r - 1.  Traffic keys: ``scale``,
``perturbations``."""

from __future__ import annotations

import dataclasses

import numpy as np

from gpubench import problems as pb

# the tag of the perturbations' stream of draws from the seed (mixes.py
# takes 2 and 3)
PERTURBATION_STREAM = 1


def perturbations(traffic: dict, seed: int, shape: tuple) -> np.ndarray:
    """The cost perturbations, (perturbations, B, n)."""
    rng = np.random.default_rng([pb.nonnegative(seed), PERTURBATION_STREAM])
    return traffic["scale"] * rng.standard_normal((traffic["perturbations"],) + shape)


def batch_of(traffic: dict, r: int) -> int:
    """The batch of the pool whose constraints round r solves."""
    return 0


def problems(config: dict, traffic: dict, seed: int, r: int, batches: list) -> list:
    """The host problems round r solves, its cost in ``c``."""
    base = batches[0]
    shift = perturbations(traffic, seed, (len(base), base[0]["c"].shape[0]))
    k = r % traffic["perturbations"]
    return [dict(p, c=p["c"] + shift[k, i]) for i, p in enumerate(base)]


class Round:
    def __init__(self, config, traffic, seed, batches, device, solve, settings, enter):
        import torch

        self.data = enter(batches[0], device)
        base_c = np.stack([p["c"] for p in batches[0]])
        shift = perturbations(traffic, seed, base_c.shape)
        self.costs = [np.ascontiguousarray(base_c + s) for s in shift]
        self.torch, self.device, self.solve, self.settings = torch, device, solve, settings
        self.last = solve(self.data, settings)

    def round(self, r):
        """Round r's result, and None: no entry inside the round."""
        c = self.torch.as_tensor(self.costs[r % len(self.costs)]).to(self.device)
        res = self.solve(dataclasses.replace(self.data, c=c), self.settings, warm=self.last)
        self.last = res
        return res, None
