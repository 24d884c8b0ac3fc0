"""The mode ``cold``, a batch solved from host data, closed loop: a pool of
``pool`` batches of the configuration on the host; round r hands batch
``r % pool`` to the program's entry and solves it from nothing.  Traffic
key: ``pool``."""

from __future__ import annotations

import time


def batch_of(traffic: dict, r: int) -> int:
    """The batch of the pool round r solves."""
    return r % traffic["pool"]


def problems(config: dict, traffic: dict, seed: int, r: int, batches: list) -> list:
    """The host problems round r solves."""
    return batches[batch_of(traffic, r)]


class Round:
    def __init__(self, config, traffic, seed, batches, device, solve, settings, enter):
        self.traffic, self.batches, self.enter = traffic, batches, enter
        self.device, self.solve, self.settings = device, solve, settings

    def round(self, r):
        """Round r's result and the seconds its entry took."""
        t = time.perf_counter()
        data = self.enter(self.batches[batch_of(self.traffic, r)], self.device)
        prep = time.perf_counter() - t
        return self.solve(data, self.settings), prep
