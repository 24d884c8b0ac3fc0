"""Horizon-sharded multistage backend (``piqp_tpu/parallel/horizon.py``):
the block-tridiagonal + arrow factorization split by stage chunks over the
ranks of a ``torch.distributed`` process group.

The reference's multistage factorization is a sequential recursion over
stages (factor_kkt, sparse/multistage_kkt.hpp:1253-1352).  Here it is the
partitioned Schur-complement method of ``multistage._chunked_factor``:

 1. The T stages are split into ``chunks`` contiguous chunks of Q stages;
    the last stage of each chunk is a separator, and removing the
    separators decouples the chunks' interiors.
 2. Each rank factors the interiors of its chunks/world consecutive chunks
    (Q - 1 stages each; by cyclic reduction, one K2 launch a level, when
    they are 16 to 256 stages), with an extended arrow of width
    W = 2D + Da coupling an interior to [previous separator | own
    separator | arrow]; the sweep also gives the chunk's Schur blocks on
    those coupling variables.
 3. The Schur blocks are all-gathered, and the separator chain (a
    ``chunks``-stage block-tridiagonal + arrow system) is factored
    redundantly on every rank.
 4. A solve runs the same two levels: owned interiors forward, the
    gathered reduced right-hand sides through the separator chain, owned
    interiors backward, and the interior x all-gathered.

Collectives: one all-gather of the Schur blocks and the interiors' flags
per factor (B chunks W^2 elements), and per solve one of the reduced
right-hand sides (B chunks W) and one of the interior x (B T D: unlike the
JAX package, whose x stays sharded, every rank gets the whole x).  The
JAX package's neighbour ``ppermute`` is not needed: every rank holds the
stage blocks whole.  The flat vectors and the
IPM's vector work are replicated too, as the JAX package replicates its
vectors, so every rank runs the same loop on bit-identical values; a solve
checks at its end that every rank took the same iterations to the same
status.

With one chunk per rank this is the JAX package's layout over a mesh axis.
With several chunks per rank one device runs the partition of a larger
mesh (the batched form of the same ``shard_map`` body).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from .. import kkt as kkt_mod
from .. import multistage as ms
from ..api import _solve_fresh, _warm_vars
from ..multistage import StageQPData
from ..types import Result, Settings
from ..utils.profiling import annotate
from .comm import all_gather_cat, require_group

# Sharded factors and solves run in this process: the sharded registrations
# add one each, nothing else does, so a caller can tell that they (and not
# the sequential StageQPData ones) ran.
sharded_calls = {"factor": 0, "solve": 0}


@dataclasses.dataclass
class ShardedStageQPData(StageQPData):
    """``StageQPData`` whose chunk interiors are factored over the ranks of
    ``group`` (None: the default process group), ``chunks`` chunks in all,
    chunks/world consecutive ones a rank.  ``group`` and ``chunks`` are
    static: the tree helpers of ``types`` carry them over unchanged, and
    ``dataclasses.replace`` (Ruiz scaling, the float32 copy of mixed
    precision) keeps the type, so the sharded registrations below run."""

    group: Any = dataclasses.field(default=None, metadata={"static": True})
    chunks: int = dataclasses.field(default=1, metadata={"static": True})


def pad_stages(data: StageQPData, T_pad: int) -> StageQPData:
    """Append decoupled identity stages up to T_pad (``horizon.py:104-155``
    of the JAX package): P = I, no couplings, padded inequality rows with
    the benign [-1, 1] bounds of a dead row, so each padded stage is an
    isolated, already optimal x = 0."""
    T = data.T
    if T_pad < T:
        raise ValueError(f"T_pad={T_pad} < T={T}")
    if T_pad == T:
        return data
    names = [f.name for f in dataclasses.fields(StageQPData)]
    arrays = [ms._pad_stage_arrays({k: getattr(data, k)[b].cpu().numpy() for k in names}, T_pad)
              for b in range(data.B)]
    return ms.stage_data_from_arrays(arrays, dtype=data.c.dtype, device=data.c.device)


def shard_horizon(data: StageQPData, group=None, chunks: Optional[int] = None,
                  pad: bool = True) -> ShardedStageQPData:
    """The stage data laid out for a sharded solve over ``group``.

    ``chunks`` (default: the group's size) must be a multiple of the group's
    size.  A horizon is shardable when T % chunks == 0 and T/chunks >= 2
    (each chunk needs an interior stage beside its separator); otherwise
    ``pad=True`` pads T up to max(2 chunks, ceil(T/chunks) chunks) with
    decoupled identity stages and ``pad=False`` raises."""
    world = require_group(group)
    chunks = world if chunks is None else chunks
    if chunks < 1 or chunks % world:
        raise ValueError(f"chunks={chunks} is not a multiple of the group's {world} ranks")
    T = data.T
    if T % chunks or T // chunks < 2:
        if not pad:
            raise ValueError(
                f"T={T} not shardable into {chunks} chunks (need T % chunks == 0 and "
                "T/chunks >= 2); pass pad=True"
            )
        data = pad_stages(data, max(2 * chunks, -(-T // chunks) * chunks))
    fields = {f.name: getattr(data, f.name) for f in dataclasses.fields(StageQPData)}
    return ShardedStageQPData(group=group, chunks=chunks, **fields)


def _partition(data: ShardedStageQPData):
    """(the chunks this rank owns, the gather of ``multistage._chunked_factor``
    and ``_chunked_solve`` that joins per-chunk pieces across the ranks)."""
    per = data.chunks // dist.get_world_size(data.group)
    rank = dist.get_rank(data.group)

    def gather(piece):
        if not isinstance(piece, tuple):
            return all_gather_cat(piece, data.group, dim=1)
        # (Schur blocks, flags): one all-gather, the flags as a last column
        Sacc, ok = piece
        B, Cl, W = Sacc.shape[:3]
        flags = ok.to(Sacc.dtype)[:, None, None].expand(B, Cl, 1)
        packed = all_gather_cat(torch.cat([Sacc.flatten(-2), flags], dim=-1), data.group, dim=1)
        return (packed[..., :-1].reshape(B, -1, W, W),
                (packed[..., -1] == 1.0).all(dim=1))

    return slice(rank * per, (rank + 1) * per), gather


@kkt_mod.factor.register
def _(data: ShardedStageQPData, ks, mixed: bool = False, pre=None, inverse: bool = True):
    """The partitioned factorization, this rank's chunk interiors."""
    with annotate("horizon.factor"):
        Kd, Ksub, Ka, Kc = ms._factor_blocks(data, ks, mixed, pre)
        own, gather = _partition(data)
        factors, ok = ms._chunked_factor(Kd, Ksub, Ka, Kc, data.chunks, inverse, own, gather)
    sharded_calls["factor"] += 1
    return dataclasses.replace(ks, factor=factors), ok


@kkt_mod.condensed_solve_x.register
def _(data: ShardedStageQPData, ks, v):
    """Two-level sweeps in the factor's precision, this rank's interiors."""
    with annotate("horizon.solve"):
        F = ks.factor
        vs, vg = ms._split_x(data, v.to(F[-1].dtype))
        own, gather = _partition(data)
        xs, xg = ms._chunked_solve(F, vs, vg, data.T, data.D, data.Da, own, gather)
    sharded_calls["solve"] += 1
    return ms._join_x(xs, xg).to(v.dtype)


def solve_horizon_sharded(
    data: StageQPData,
    group=None,
    chunks: Optional[int] = None,
    settings: Settings = Settings(),
    has_cone: bool = True,
    warm=None,
) -> Result:
    """Horizon-sharded multistage solve (BASELINE.md config 4) of a batch of
    stage problems over the ranks of ``group`` (None: the default process
    group, which must be initialised; every rank calls this with the same
    data and gets the whole result).

    Lays the data out with ``shard_horizon`` (unless it already is a
    ``ShardedStageQPData``), equilibrates and runs the IPM with the
    partitioned factorization.  The result is in the (possibly padded)
    stage layout; padded coordinates solve an isolated identity problem
    and can be dropped by the caller.

    ``warm``: a previous ``Result`` (or ``BasicVars``) of this function on
    nearby problems, the MPC pattern; it must be in the padded stage layout
    this function returns, and a wrong layout raises."""
    sdata = data if isinstance(data, ShardedStageQPData) else shard_horizon(data, group, chunks)
    warm = _warm_vars(warm)
    if warm is not None and warm.x.shape[-1] != sdata.n:
        raise ValueError(
            f"warm.x has {warm.x.shape[-1]} coords, expected {sdata.n} "
            "(the padded stage layout returned by solve_horizon_sharded)"
        )
    res = _solve_fresh(sdata, settings, has_cone, warm)[0]
    _check_ranks_agree(res, sdata.group)
    return res


def _check_ranks_agree(res: Result, group) -> None:
    """Raise unless every rank ended each problem at the same iteration
    with the same status (the replicated loop must not diverge)."""
    mine = torch.stack([res.info.iter.to(torch.int64), res.info.status.to(torch.int64)])
    every = all_gather_cat(mine[None], group, dim=0)
    if not bool((every == every[:1]).all()):
        raise RuntimeError(
            "ranks disagree on the sharded solve's iterations or status: "
            f"{every.cpu().tolist()}"
        )
