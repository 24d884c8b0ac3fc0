"""piqp_tpu_torch — the PyTorch/CUDA port of piqp_tpu.

A proximal interior-point QP solver for convex QPs

    min 0.5 x'Px + c'x   s.t.  Ax = b,  h_l <= Gx <= h_u,  x_l <= x <= x_u

written batch-first in PyTorch: every problem tensor has a leading batch
dimension, and a single problem is a batch of one.  The condensed KKT
matrices are factored by a hand-written CUDA kernel on an NVIDIA Hopper
GPU (``ops/chol_inv.py``).  Entry points put data on the CUDA device
unless the caller passes ``device="cpu"``.

The backends follow ``Settings.kkt_solver`` as in the JAX package: the
dense condensed Cholesky (default), ``dense_lu`` and ``dense_ldlt`` on the
full 3-block KKT matrix (the latter through a hand-written signed-Cholesky
kernel), and ``multistage`` for block-tridiagonal + arrow problems, given
as stacked stage blocks (``multistage.StageQPData``) or as a sparse QP
(``SparseSolver``), whose cyclic reduction runs a hand-written
factor-inverse-apply kernel.  ``SparseSolver`` also has the JAX
package's host sparse route (``hostsparse.py``, NumPy/SciPy on the CPU)
for ``kkt_solver=sparse_host`` and for problems above
``dense_routing_max_n``.

Around the solve: ``solve_batch_sqp`` runs warm re-solve rounds,
``solve_batch_compact`` re-solves a batch's stragglers as a smaller
batch, and ``solve_qp_diff`` / ``qp_layer`` differentiate the solution
with ``torch.autograd`` (implicit differentiation of the KKT
conditions).  Across the ranks of a ``torch.distributed`` process group,
``solve_horizon_sharded`` splits a multistage horizon into stage chunks
(``parallel/horizon.py``) and ``solve_batch(sharding=group)`` splits a
batch; importing the package initialises no process group.  The JAX package ``piqp_tpu`` is the reference, and no
module here imports it or JAX.
"""

from .types import (
    PIQP_INF,
    BasicVars,
    Info,
    KKTBackend,
    QPData,
    Result,
    Scaling,
    Settings,
    Status,
    status_to_string,
)
from .api import DenseSolver, has_cone, prepare_data, solve_dense, solve_prepared
from .batch import (
    prepare_batch,
    prepare_stage_batch,
    solve_batch,
    solve_batch_compact,
    solve_batch_sqp,
    warm_from_result,
)
from .diff import qp_layer, solve_qp_diff
from .multistage import StageQPData, random_multistage_batch, random_multistage_qp
from .parallel import ShardedStageQPData, shard_horizon, solve_horizon_sharded
from .sparse import SparseSolver

__version__ = "0.1.0"

__all__ = [
    "PIQP_INF",
    "BasicVars",
    "DenseSolver",
    "Info",
    "KKTBackend",
    "QPData",
    "Result",
    "Scaling",
    "Settings",
    "SparseSolver",
    "ShardedStageQPData",
    "StageQPData",
    "Status",
    "status_to_string",
    "has_cone",
    "prepare_data",
    "prepare_batch",
    "prepare_stage_batch",
    "solve_dense",
    "solve_prepared",
    "solve_batch",
    "solve_batch_compact",
    "solve_batch_sqp",
    "solve_qp_diff",
    "qp_layer",
    "random_multistage_batch",
    "random_multistage_qp",
    "shard_horizon",
    "solve_horizon_sharded",
    "warm_from_result",
    "__version__",
]
