"""Collectives of the sharded paths, on ``torch.distributed``.

``group=None`` is the default process group, which the caller must have
initialised (``torch.distributed.init_process_group``: gloo for CPU
tensors, NCCL for CUDA ones).  Importing this module initialises nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..types import tree_map


def require_group(group=None) -> int:
    """The size of ``group``; raises when torch.distributed has no default
    group (a sharded solve has no silent single-process mode)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed is not initialised: call "
            "torch.distributed.init_process_group before a sharded solve"
        )
    return dist.get_world_size(group)


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in rank
    order, on every rank."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def all_gather_tree(value, group=None, dim: int = 0):
    """``all_gather_cat`` over every tensor of a dataclass (or nested
    tuple)."""
    return tree_map(lambda t: all_gather_cat(t, group, dim), value)
