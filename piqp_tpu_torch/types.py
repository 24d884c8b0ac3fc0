"""Core types of the PyTorch port (dense pieces of ``piqp_tpu/types.py``).

Problem data, iterates, results and scalings are dataclasses of tensors
with the batch as their leading dimension: a single problem is B = 1.
Bounds stay full-length with boolean masks and exact zeros at inactive
entries, as in the JAX package, so every per-bound loop of the reference
is a masked vector expression.

``select(mask, new, old)`` is the port's counterpart of what ``vmap`` does
to a ``while_loop`` or a ``cond``: problem b takes ``new`` where
``mask[b]`` and keeps ``old`` otherwise.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

# Values greater or equal in magnitude are treated as infinite
# (mirrors PIQP_INF = 1e30, fwd.hpp:54).
PIQP_INF = 1e30

# Farkas-certificate validation tolerances (piqp_tpu/types.py:46-48).
CERT_EQ_TOL = 1e-4
CERT_NEG_TOL = 0.5
CERT_SUP_TOL = 1e-2


class Status(enum.IntEnum):
    """Solver status codes (mirrors results.hpp:18-27)."""

    SOLVED = 1
    MAX_ITER_REACHED = -1
    PRIMAL_INFEASIBLE = -2
    DUAL_INFEASIBLE = -3
    NUMERICS = -8
    UNSOLVED = -9
    INVALID_SETTINGS = -10
    # internal: the IPM loop is still running for this problem
    RUNNING = 0


def status_to_string(status: int) -> str:
    try:
        s = Status(int(status))
    except ValueError:
        return "unknown"
    return {
        Status.SOLVED: "solved",
        Status.MAX_ITER_REACHED: "max iterations reached",
        Status.PRIMAL_INFEASIBLE: "primal infeasible",
        Status.DUAL_INFEASIBLE: "dual infeasible",
        Status.NUMERICS: "numerics issue",
        Status.UNSOLVED: "unsolved",
        Status.INVALID_SETTINGS: "invalid settings",
        Status.RUNNING: "running",
    }[s]


class KKTBackend(enum.Enum):
    """KKT solver backends (names as in ``piqp_tpu.KKTBackend``).
    ``sparse_host`` is the NumPy/SciPy route of ``SparseSolver``
    (``hostsparse.py``); dense data given it keeps the condensed backend."""

    dense_cholesky = "dense_cholesky"
    dense_lu = "dense_lu"
    dense_ldlt = "dense_ldlt"
    multistage = "multistage"
    sparse_host = "sparse_host"

    @classmethod
    def from_piqp(cls, name: str) -> "KKTBackend":
        """The backend for a PIQP KKTSolver name (settings.hpp:18-26), as
        ``piqp_tpu.KKTBackend.from_piqp`` maps it: ``sparse_ldlt`` (the
        full KKT) -> ``sparse_host``, the three partial eliminations ->
        ``dense_cholesky`` (they condense to the same n x n system),
        ``sparse_multistage`` -> ``multistage``; the port's own names map
        to themselves."""
        aliases = {
            "sparse_ldlt": cls.sparse_host,
            "sparse_ldlt_eq_cond": cls.dense_cholesky,
            "sparse_ldlt_ineq_cond": cls.dense_cholesky,
            "sparse_ldlt_cond": cls.dense_cholesky,
            "sparse_multistage": cls.multistage,
        }
        return aliases[name] if name in aliases else cls(name)


@dataclasses.dataclass(frozen=True)
class Settings:
    """Solver settings: the same fields and defaults as
    ``piqp_tpu.Settings`` (see there for each field's meaning).

    ``pallas_kernels`` selects every backend's factor representation: None
    or True factor with explicit inverses (L, Linv), through the
    hand-written kernels on a CUDA tensor and their plain versions on a CPU
    tensor; False keeps the library factorizations with triangular solves
    (for ``dense_ldlt``, the blocked signed Cholesky of ``ops/ldlt.py``)."""

    rho_init: float = 1e-6
    delta_init: float = 1e-4

    eps_abs: float = 1e-8
    eps_rel: float = 1e-9

    check_duality_gap: bool = True
    eps_duality_gap_abs: float = 1e-8
    eps_duality_gap_rel: float = 1e-9

    infeasibility_threshold: float = 0.9

    reg_lower_limit: float = 1e-10
    reg_finetune_lower_limit: float = 1e-13
    reg_finetune_primal_update_threshold: int = 7
    reg_finetune_dual_update_threshold: int = 7

    max_iter: int = 250
    max_factor_retires: int = 10

    preconditioner_scale_cost: bool = False
    preconditioner_reuse_on_update: bool = False
    preconditioner_iter: int = 10

    tau: float = 0.99

    kkt_solver: KKTBackend = KKTBackend.dense_cholesky

    iterative_refinement_always_enabled: bool = False
    iterative_refinement_eps_abs: float = 1e-12
    iterative_refinement_eps_rel: float = 1e-12
    iterative_refinement_max_iter: int = 10
    iterative_refinement_min_improvement_rate: float = 5.0
    iterative_refinement_static_regularization_eps: float = 1e-8
    iterative_refinement_static_regularization_rel: Optional[float] = None

    verbose: bool = False
    compute_timings: bool = False

    dtype: str = "float64"
    mixed_precision: bool = False
    mixed_precision_mu_switch: float = 1e-5
    mixed_phase_a_patience: int = 12
    pallas_kernels: bool | None = None
    dense_routing_max_n: Optional[int] = None
    refine_mu_factor: float = 1e-2
    refine_static_passes: int = 1
    verify_certificates: bool = True
    warm_start_mu: float = 1e-7
    centrality_correctors: int = 0

    def verify(self) -> bool:
        """Mirror of Settings::verify_settings (settings.hpp:84-106)."""
        return (
            self.rho_init > 0
            and self.delta_init > 0
            and self.eps_abs > 0
            and self.eps_rel >= 0
            and self.eps_duality_gap_abs > 0
            and self.eps_duality_gap_rel >= 0
            and self.infeasibility_threshold >= 0
            and self.reg_lower_limit > 0
            and self.reg_finetune_primal_update_threshold >= 0
            and self.reg_finetune_dual_update_threshold >= 0
            and self.max_iter > 0
            and self.max_factor_retires > 0
            and self.preconditioner_iter >= 0
            and self.tau > 0
            and self.tau <= 1
            and self.mixed_precision_mu_switch > 0
            and self.mixed_phase_a_patience >= 0
            and self.refine_mu_factor >= 0
            and self.refine_static_passes >= -1
            and (
                self.dense_routing_max_n is None
                or self.dense_routing_max_n >= 0
            )
            and self.warm_start_mu > 0
            and 0 <= self.centrality_correctors <= 10
            and self.iterative_refinement_eps_abs > 0
            and self.iterative_refinement_eps_rel >= 0
            and self.iterative_refinement_max_iter >= 0
            and self.iterative_refinement_min_improvement_rate >= 1.0
            and self.iterative_refinement_static_regularization_eps > 0
            and (
                self.iterative_refinement_static_regularization_rel is None
                or self.iterative_refinement_static_regularization_rel >= 0
            )
        )

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def factor_inverse(self) -> bool:
        """True when the factors are kept with explicit inverses."""
        return self.pallas_kernels is not False

    def static_reg_rel(self) -> float:
        if self.iterative_refinement_static_regularization_rel is not None:
            return self.iterative_refinement_static_regularization_rel
        eps = torch.finfo(self.torch_dtype).eps
        return eps * eps


def resolve_device(device) -> torch.device:
    """The device an entry point puts data on: CUDA unless the caller names
    another.  Without a GPU the caller must ask for the CPU explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "piqp_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def tree_map(fn, value, *rest):
    """``fn`` over every tensor of a dataclass (or nested tuple or dict)
    ``value`` and the matching tensors of ``rest`` (values of the same
    structure).  None stays None.  Fields marked
    ``metadata={"static": True}`` (a process group, a chunk count) are not
    visited: ``dataclasses.replace`` carries them over from ``value``."""
    if isinstance(value, torch.Tensor):
        return fn(value, *rest)
    if value is None:
        return None
    if isinstance(value, tuple):
        return tuple(tree_map(fn, *parts) for parts in zip(value, *rest))
    if isinstance(value, dict):
        return {k: tree_map(fn, value[k], *(r[k] for r in rest)) for k in sorted(value)}
    if dataclasses.is_dataclass(value):
        return dataclasses.replace(value, **{
            f.name: tree_map(fn, getattr(value, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(value) if not f.metadata.get("static")
        })
    raise TypeError(f"cannot map over {type(value).__name__}")


def select(mask: torch.Tensor, new, old):
    """Per-problem choice between two values of the same structure
    (dataclasses, tuples, tensors with a leading batch dimension): problem
    b takes ``new`` where ``mask[b]`` is true.  None stays None."""
    def pick(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)

    return tree_map(pick, new, old)


def max0(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.max(v, axis=dim, initial=0.0)``: max(0, max of v over ``dim``)
    for each problem, 0 for an empty axis.  NaN propagates."""
    if v.shape[dim] == 0:
        shape = list(v.shape)
        del shape[dim]
        return v.new_zeros(shape)
    return torch.clamp(v.amax(dim=dim), min=0.0)


def min0(v: torch.Tensor) -> torch.Tensor:
    """``jnp.min(v, axis=-1, initial=0.0)`` for each problem."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.clamp(v.amin(dim=-1), max=0.0)


def to_device(value, device):
    """Move every tensor of a dataclass (or nested tuple) to ``device``."""
    return tree_map(lambda t: t.to(device), value)


def index(value, i):
    """Take problem(s) ``i`` (an int or an index tensor) from every tensor
    of a dataclass (or nested tuple); an int drops the batch dimension."""
    return tree_map(lambda t: t[i], value)


def index_put(value, i, new):
    """``value`` with problems ``i`` (an index tensor) replaced by the
    problems of ``new``, in every tensor of a dataclass (or nested tuple):
    the scatter counterpart of ``index``."""
    def put(t, n):
        out = t.clone()
        out[i] = n
        return out

    return tree_map(put, value, new)


def concat(values: list):
    """Concatenate dataclasses (or nested tuples) of batched tensors along
    the batch."""
    return tree_map(lambda *ts: torch.cat(ts, dim=0), *values)


@dataclasses.dataclass
class QPData:
    """Batched canonical problem data (``piqp_tpu.types.QPData`` with a
    leading batch dimension B on every field):

    min 0.5 x'Px + c'x  s.t.  Ax = b,  h_l <= Gx <= h_u,
                              x_l <= x_b_scaling * x <= x_u

    P is the full symmetric matrix; inactive bounds are 0 with a False
    mask; rows of G with both bounds infinite are zeroed and get the fake
    bounds [-1, 1] (disable_inf_constraints, dense/data.hpp:144-169)."""

    P: torch.Tensor  # (B, n, n)
    c: torch.Tensor  # (B, n)
    A: torch.Tensor  # (B, p, n)
    b: torch.Tensor  # (B, p)
    G: torch.Tensor  # (B, m, n)
    h_l: torch.Tensor  # (B, m)
    h_u: torch.Tensor  # (B, m)
    x_l: torch.Tensor  # (B, n)
    x_u: torch.Tensor  # (B, n)
    x_b_scaling: torch.Tensor  # (B, n)
    hl_mask: torch.Tensor  # (B, m) bool
    hu_mask: torch.Tensor  # (B, m) bool
    xl_mask: torch.Tensor  # (B, n) bool
    xu_mask: torch.Tensor  # (B, n) bool

    @property
    def B(self) -> int:
        return self.P.shape[0]

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def p(self) -> int:
        return self.A.shape[-2]

    @property
    def m(self) -> int:
        return self.G.shape[-2]


def canonical_bounds(h_l, h_u, x_l, x_u) -> tuple:
    """The bounds of the masked representation, elementwise on any leading
    shape and device: masks from the PIQP_INF convention (dense/data.hpp:
    100-142), fake bounds [-1, 1] on dead rows, those with both inequality
    bounds inactive (dense/data.hpp:144-169), and exact zeros at inactive
    bounds.  Returns (h_l, h_u, x_l, x_u, hl_mask, hu_mask, xl_mask,
    xu_mask, dead); each caller zeroes the dead rows of its own G layout."""
    hl_mask = h_l > -PIQP_INF
    hu_mask = h_u < PIQP_INF
    dead = ~hl_mask & ~hu_mask
    h_l = torch.where(dead, -1.0, h_l)
    h_u = torch.where(dead, 1.0, h_u)
    hl_mask = h_l > -PIQP_INF
    hu_mask = h_u < PIQP_INF
    xl_mask = x_l > -PIQP_INF
    xu_mask = x_u < PIQP_INF
    return (torch.where(hl_mask, h_l, 0.0), torch.where(hu_mask, h_u, 0.0),
            torch.where(xl_mask, x_l, 0.0), torch.where(xu_mask, x_u, 0.0),
            hl_mask, hu_mask, xl_mask, xu_mask, dead)


@dataclasses.dataclass
class FullKKTQPData(QPData):
    """``QPData`` that routes the KKT layer to the full 3-block dense LU
    backend (``KKTBackend.dense_lu``).  Identical fields; the data's type
    selects the backend (``piqp_tpu/types.py:399-410``)."""


@dataclasses.dataclass
class LDLTKKTQPData(QPData):
    """``QPData`` that routes the KKT layer to the full 3-block signed
    Cholesky backend (``KKTBackend.dense_ldlt``, ``ops/ldlt.py``)."""


@dataclasses.dataclass
class BasicVars:
    """(x, y, z_l, z_u, z_bl, z_bu) — mirrors BasicVariables
    (variables.hpp:16-62); z_bl/z_bu are full length n (masked)."""

    x: torch.Tensor
    y: torch.Tensor
    z_l: torch.Tensor
    z_u: torch.Tensor
    z_bl: torch.Tensor
    z_bu: torch.Tensor


@dataclasses.dataclass
class Vars:
    """Full variables incl. slacks — mirrors Variables (variables.hpp:64-105)."""

    x: torch.Tensor
    y: torch.Tensor
    z_l: torch.Tensor
    z_u: torch.Tensor
    z_bl: torch.Tensor
    z_bu: torch.Tensor
    s_l: torch.Tensor
    s_u: torch.Tensor
    s_bl: torch.Tensor
    s_bu: torch.Tensor

    def basic(self) -> BasicVars:
        return BasicVars(self.x, self.y, self.z_l, self.z_u, self.z_bl, self.z_bu)


def zero_vars(B: int, n: int, p: int, m: int, dtype, device) -> Vars:
    def z(k):
        return torch.zeros((B, k), dtype=dtype, device=device)

    return Vars(z(n), z(p), z(m), z(m), z(n), z(n), z(m), z(m), z(n), z(n))


@dataclasses.dataclass
class Info:
    """Per-problem solve metrics, mirrors Info (results.hpp:44-89): every
    field has shape (B,).  The time fields stay zero unless
    ``Settings.compute_timings`` is set on a stateful solver
    (``api.DenseSolver``, ``sparse.SparseSolver``)."""

    status: torch.Tensor  # int32
    iter: torch.Tensor  # int32
    rho: torch.Tensor
    delta: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    primal_step: torch.Tensor
    dual_step: torch.Tensor
    primal_res: torch.Tensor
    primal_res_rel: torch.Tensor
    dual_res: torch.Tensor
    dual_res_rel: torch.Tensor
    primal_res_reg: torch.Tensor
    primal_res_reg_rel: torch.Tensor
    dual_res_reg: torch.Tensor
    dual_res_reg_rel: torch.Tensor
    primal_prox_inf: torch.Tensor
    dual_prox_inf: torch.Tensor
    prev_primal_res: torch.Tensor
    prev_dual_res: torch.Tensor
    primal_obj: torch.Tensor
    dual_obj: torch.Tensor
    duality_gap: torch.Tensor
    duality_gap_rel: torch.Tensor
    factor_retires: torch.Tensor  # int32
    reg_limit: torch.Tensor
    no_primal_update: torch.Tensor  # int32
    no_dual_update: torch.Tensor  # int32
    setup_time: torch.Tensor
    update_time: torch.Tensor
    solve_time: torch.Tensor
    kkt_factor_time: torch.Tensor
    kkt_solve_time: torch.Tensor
    run_time: torch.Tensor


_INFO_INT_FIELDS = ("status", "iter", "factor_retires", "no_primal_update",
                    "no_dual_update")


def init_info(settings: Settings, B: int, dtype, device) -> Info:
    init = dict(
        status=int(Status.RUNNING), iter=0,
        rho=settings.rho_init, delta=settings.delta_init,
        mu=0.0, sigma=0.0, primal_step=0.0, dual_step=0.0,
        primal_res=float("inf"), primal_res_rel=float("inf"),
        dual_res=float("inf"), dual_res_rel=float("inf"),
        primal_res_reg=float("inf"), primal_res_reg_rel=float("inf"),
        dual_res_reg=float("inf"), dual_res_reg_rel=float("inf"),
        primal_prox_inf=0.0, dual_prox_inf=0.0,
        prev_primal_res=float("inf"), prev_dual_res=float("inf"),
        primal_obj=0.0, dual_obj=0.0,
        duality_gap=float("inf"), duality_gap_rel=float("inf"),
        factor_retires=0, reg_limit=settings.reg_lower_limit,
        no_primal_update=0, no_dual_update=0,
        setup_time=0.0, update_time=0.0, solve_time=0.0,
        kkt_factor_time=0.0, kkt_solve_time=0.0, run_time=0.0,
    )
    return Info(**{
        k: torch.full(
            (B,), v, device=device,
            dtype=torch.int32 if k in _INFO_INT_FIELDS else dtype,
        )
        for k, v in init.items()
    })


@dataclasses.dataclass
class Result:
    """Solution + info, mirrors Result (results.hpp:91-95)."""

    x: torch.Tensor
    y: torch.Tensor
    z_l: torch.Tensor
    z_u: torch.Tensor
    z_bl: torch.Tensor
    z_bu: torch.Tensor
    s_l: torch.Tensor
    s_u: torch.Tensor
    s_bl: torch.Tensor
    s_bu: torch.Tensor
    info: Info


@dataclasses.dataclass
class Scaling:
    """Ruiz equilibration state (dense/preconditioner.hpp:36-42), per
    problem: c (B,), d_x (B, n), d_y (B, p), d_z (B, m), d_b (B, n)."""

    c: torch.Tensor
    d_x: torch.Tensor
    d_y: torch.Tensor
    d_z: torch.Tensor
    d_b: torch.Tensor

