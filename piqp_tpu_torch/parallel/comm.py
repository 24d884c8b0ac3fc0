"""Collectives of the sharded paths, on ``torch.distributed``.

``group=None`` is the default process group, which the caller must have
initialised (``torch.distributed.init_process_group``: gloo for CPU
tensors, NCCL for CUDA ones; gloo also takes CUDA tensors, which it moves
through host memory itself, so several ranks can share one card).
Importing this module initialises nothing.

Every collective here is one ``all_gather``: the neighbour exchange takes
the previous rank's part of it, and the all-reduce sums the gathered
parts on every rank in rank order.  So every rank computes
the same bits from the same parts, which the replicated IPM loop of the
horizon-sharded solve needs, and each collective runs on any backend and
device that ``all_gather`` does.  ``collective_calls`` counts the
collectives this process made, by kind.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..types import tree_map

collective_calls = {"all_gather": 0, "exchange": 0, "all_reduce": 0}


def require_group(group=None) -> int:
    """The size of ``group``; raises when torch.distributed has no default
    group (a sharded solve has no silent single-process mode)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed is not initialised: call "
            "torch.distributed.init_process_group before a sharded solve"
        )
    return world_size(group)


def world_size(group=None) -> int:
    return dist.get_world_size(group)


def rank(group=None) -> int:
    return dist.get_rank(group)


def _all_gather(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` (equal shapes), in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in rank
    order, on every rank."""
    collective_calls["all_gather"] += 1
    return torch.cat(_all_gather(t, group), dim=dim)


def all_gather_tree(value, group=None, dim: int = 0):
    """``all_gather_cat`` over every tensor of a dataclass (or nested
    tuple)."""
    return tree_map(lambda t: all_gather_cat(t, group, dim), value)


def _packed_gather(pieces: tuple, group) -> list:
    """Every rank's ``pieces`` (tensors of one dtype, the problems on the
    leading dimension, equal shapes on every rank) in one all-gather: a
    list over the ranks of tuples shaped like ``pieces``."""
    B = pieces[0].shape[0]
    sizes = [p[0].numel() for p in pieces]
    flat = torch.cat([p.reshape(B, -1) for p in pieces], dim=-1)
    return [tuple(q.reshape(p.shape) for q, p in zip(part.split(sizes, dim=-1), pieces))
            for part in _all_gather(flat, group)]


def all_gather_pieces(pieces: tuple, group=None) -> tuple:
    """Every rank's ``pieces`` in one all-gather: for each piece, the
    ranks' copies stacked on a new leading dimension (world, B, ...)."""
    collective_calls["all_gather"] += 1
    parts = _packed_gather(pieces, group)
    return tuple(torch.stack(ps) for ps in zip(*parts))


def exchange_prev(pieces: tuple, group=None) -> tuple:
    """Rank r's ``pieces`` arrive at rank r + 1, and rank 0 receives zeros
    (the JAX package's ``ppermute`` over the pairs (k, k + 1)).  One
    all-gather of the pieces, of which each rank keeps its neighbour's."""
    collective_calls["exchange"] += 1
    parts = _packed_gather(pieces, group)
    r = rank(group)
    return parts[r - 1] if r else tuple(torch.zeros_like(p) for p in pieces)


def all_reduce(pieces: tuple, group=None) -> tuple:
    """The sum of every rank's terms, on every rank: each piece holds
    terms along dim 1 (one a stage), and the sum runs over every rank's
    terms joined along it in rank order, from one all-gather: the same
    bits one process holding every term computes."""
    collective_calls["all_reduce"] += 1
    parts = _packed_gather(pieces, group)
    return tuple(torch.cat(ps, dim=1).sum(dim=1) for ps in zip(*parts))
