"""Sharded solves on ``torch.distributed``: the horizon-sharded multistage
backend (``horizon.py``) and the collectives it and
``batch.solve_batch(sharding=...)`` use (``comm.py``)."""

from .horizon import (  # noqa: F401
    ShardedStageQPData,
    pad_stages,
    shard_horizon,
    sharded_calls,
    solve_horizon_sharded,
)
