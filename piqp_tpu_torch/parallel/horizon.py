"""Horizon-sharded multistage backend (``piqp_tpu/parallel/horizon.py``):
the stage blocks and the block-tridiagonal + arrow factorization split by
stage chunks over the ranks of a ``torch.distributed`` process group.

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
 3. The Schur blocks and the separators' diagonal and arrow blocks are
    all-gathered, and the separator chain (a ``chunks``-stage
    block-tridiagonal + arrow system) is factored redundantly on every
    rank.
 4. A solve runs the same two levels: owned interiors forward, the
    gathered reduced right-hand sides through the separator chain, owned
    interiors backward, and the interior x all-gathered.

Layout, as the JAX package's stage sharding: a rank holds only its own
stages [rank, rank + 1) x T/world of the nine stage-indexed block fields
(Pd, Psub, Pa, A1, A2, Ag, G1, G2, Gg; ``ShardedStageQPData.stages``), so
their memory, their Ruiz scaling, the block assembly and the structured
matvecs shrink with the group.  Pc and every flat (B, n), (B, p), (B, m)
vector stay whole on every rank, as the JAX package replicates its
vectors, and every rank runs the same IPM loop on bit-identical values; a
solve checks at its end that every rank took the same iterations to the
same status.  The block functions of ``multistage`` compute their owned
stages' rows and join them through three hooks that this module
registers, each one collective of ``comm``:

- ``gather_pieces``, one all-gather: the owned rows of a matvec (one a
  call of P x, A x, A' y, G x, G' z and diag(P)) or of a Ruiz pass's norms
  (one a pass, and one more with ``scale_cost``), each with its last
  stage's share of the next stage (P[i+1, i] x_i, A2' y, G2' z, the norms
  of P[i, i+1], A2 and G2) and its arrow terms, one a stage (or its
  partial max); every rank joins them in rank order into the whole
  horizon's rows and sums the arrow terms over every stage;
- ``prev_pieces``, the neighbour exchange (the JAX package's
  ``ppermute``), once a factor: the A2/G2 terms of the previous rank's
  last stage that fall on this rank's first stage, and its last Ksub
  block, the first owned chunk's coupling to the previous separator;
- ``sum_pieces``, one all-reduce a factor: the arrow block Kc's terms,
  one a stage, summed over every stage.

The joins add in the whole horizon's order, and the stage code's
matrix-vector products (the matvecs, the interior sweeps) are a product
and a sum (``multistage._mv``), whose bits do not depend on how many
stages share a call as the library's batched kernels' do.  So the layout
itself adds nothing that depends on the number of ranks: on the CPU a
solve over 2 or 4 ranks gives the bits of a solve on one, and so does the
D = 48 fleet on an H100.  A library factor or triangular solve can still
round differently at another batch size (config 4 on 4 ranks of an H100,
one problem a batch: x within 2.01e-12 of one rank's in float64).

Per factor, then, one exchange, one all-reduce and one all-gather (the
Schur blocks, the separators' Kd and Ka blocks and the interiors' flags;
B x chunks x (W^2 + D^2 + Da D + 1) elements); per solve two all-gathers,
of the reduced right-hand sides (B chunks W) and of the interior x (B T D:
unlike the JAX package, whose x stays sharded, every rank gets the whole
x).  None of these counts grows with T (``comm.collective_calls``).

With one chunk per rank this is the JAX package's layout over a mesh axis.
With several chunks per rank one device runs the partition of a larger
mesh (the batched form of the same ``shard_map`` body).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .. import kkt as kkt_mod
from .. import multistage as ms
from ..api import _solve_fresh, _warm_vars
from ..multistage import STAGE_BLOCKS, StageQPData, pad_stages
from ..types import Result, Settings
from ..utils.profiling import annotate
from .comm import (
    all_gather_cat, all_gather_pieces, all_reduce, exchange_prev, rank, require_group,
)

# Sharded factors and solves run in this process: the sharded registrations
# add one each, nothing else does, so a caller can tell that they (and not
# the sequential StageQPData ones) ran.
sharded_calls = {"factor": 0, "solve": 0}


@dataclasses.dataclass
class ShardedStageQPData(StageQPData):
    """``StageQPData`` of which this rank holds the stages ``stages`` =
    [start, stop) of the nine stage-indexed block fields, out of a horizon
    of ``horizon`` stages (``T``, and so ``n``, ``p`` and ``m``, are the
    whole horizon's; Pc and the flat vectors are whole).  Its chunk
    interiors are factored over the ranks of ``group`` (None: the default
    process group), ``chunks`` chunks in all, chunks/world consecutive ones
    a rank.  The four fields after the blocks are static: the tree helpers
    of ``types`` carry them over unchanged, and ``dataclasses.replace``
    (Ruiz scaling, the float32 copy of mixed precision) keeps the type, so
    the sharded registrations below run.  Made by ``shard_horizon``."""

    group: Any = dataclasses.field(default=None, metadata={"static": True})
    chunks: int = dataclasses.field(default=1, metadata={"static": True})
    horizon: int = dataclasses.field(default=0, metadata={"static": True})
    stages: tuple = dataclasses.field(default=(0, 0), metadata={"static": True})

    @property
    def T(self) -> int:
        return self.horizon

    @property
    def owned(self) -> slice:
        return slice(*self.stages)


def shard_horizon(data: StageQPData, group=None, chunks: Optional[int] = None,
                  pad: bool = True, device=None) -> ShardedStageQPData:
    """This rank's part of the stage data laid out for a sharded solve over
    ``group``.

    ``chunks`` (default: the group's size) must be a multiple of the group's
    size.  A horizon is shardable when T % chunks == 0 and T/chunks >= 2
    (each chunk needs an interior stage beside its separator); otherwise
    ``pad=True`` pads T up to max(2 chunks, ceil(T/chunks) chunks) with
    decoupled identity stages and ``pad=False`` raises.  The rank keeps
    the stage blocks of its chunks and the whole of Pc and the flat
    vectors, on ``device`` (None: the data's own), so a long horizon can
    be handed over on the host and only each rank's stages reach its
    card."""
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
    per = data.T // world
    r = rank(group)
    return _take_stages(data, (r * per, (r + 1) * per), group, chunks, device)


def _take_stages(data: StageQPData, stages: tuple, group=None, chunks: int = 1,
                device=None) -> ShardedStageQPData:
    """The ``ShardedStageQPData`` that holds the stages [start, stop) of
    ``data``'s blocks (compact copies) and the whole of its other fields,
    on ``device`` (None: the data's own); ``shard_horizon``'s layout
    without a process group."""
    start, stop = stages
    dev = data.c.device if device is None else torch.device(device)
    fields = {}
    for f in dataclasses.fields(StageQPData):
        t = getattr(data, f.name)
        if f.name in STAGE_BLOCKS:
            t = t[:, start:stop]
        fields[f.name] = t.to(dev).contiguous()
    return ShardedStageQPData(group=group, chunks=chunks, horizon=data.T,
                              stages=(start, stop), **fields)


@ms.gather_pieces.register
def _(data: ShardedStageQPData, pieces: tuple) -> tuple:
    return all_gather_pieces(pieces, data.group)


@ms.prev_pieces.register
def _(data: ShardedStageQPData, pieces: tuple) -> tuple:
    return exchange_prev(pieces, data.group)


@ms.sum_pieces.register
def _(data: ShardedStageQPData, pieces: tuple) -> tuple:
    return all_reduce(pieces, data.group)


def _partition(data: ShardedStageQPData):
    """(the chunks this rank owns, the gather of ``multistage._chunked_factor``
    and ``_chunked_solve`` that joins per-chunk pieces across the ranks)."""
    Q = data.T // data.chunks
    own = slice(data.stages[0] // Q, data.stages[1] // Q)

    def gather(piece):
        if not isinstance(piece, tuple):
            return all_gather_cat(piece, data.group, dim=1)
        # (Schur blocks, separators' Kd and Ka, flags): one all-gather, the
        # flags as a last column
        *blocks, ok = piece
        parts = all_gather_pieces(tuple(blocks) + (ok.to(blocks[0].dtype)[:, None],), data.group)
        joined = tuple(p.movedim(0, 1).flatten(1, 2) for p in parts[:-1])
        return joined + ((parts[-1][..., 0] == 1.0).all(dim=0),)

    return own, gather


@kkt_mod.factor.register
def _(data: ShardedStageQPData, ks, mixed: bool = False, pre=None, inverse: bool = True):
    """The partitioned factorization, this rank's chunk interiors."""
    with annotate("piqp.horizon.factor"):
        Kd, Ksub, Ka, Kc, E_first = ms._factor_blocks(data, ks, mixed, pre)
        own, gather = _partition(data)
        factors, ok = ms._chunked_factor(Kd, Ksub, Ka, Kc, data.chunks, inverse, own, gather,
                                         E_first)
    sharded_calls["factor"] += 1
    return dataclasses.replace(ks, factor=factors), ok


@kkt_mod.condensed_solve_x.register
def _(data: ShardedStageQPData, ks, v):
    """Two-level sweeps in the factor's precision, this rank's interiors."""
    with annotate("piqp.horizon.solve"):
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
