"""User-facing API of the port (``piqp_tpu/api.py``, dense backend).

- :func:`prepare_data`: canonicalize user matrices into a batched
  :class:`QPData` with B = 1 (dense::Data construction and
  disable_inf_constraints, dense/data.hpp:55-212).
- :func:`solve_prepared`: functional solve of prepared (batched) data.
- :func:`solve_dense`: one-shot solve of one problem.
- :class:`DenseSolver`: stateful wrapper mirroring piqp::DenseSolver
  (solver.hpp:1262-1291): settings / setup / update / solve / result.

``Settings.kkt_solver`` picks the backend through the data's type
(``_route_backend``): ``dense_cholesky`` (condensed), ``dense_lu`` and
``dense_ldlt`` (full 3-block KKT) on dense data; stage-block data
(``multistage.StageQPData``) always runs the multistage backend.

Entry points put the data on the CUDA device unless the caller passes
``device="cpu"``; without a GPU they raise instead of falling back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import kkt, ruiz, solver
from .ops import matvec as ops
from .types import (
    PIQP_INF,
    BasicVars,
    FullKKTQPData,
    KKTBackend,
    LDLTKKTQPData,
    QPData,
    Result,
    Scaling,
    Settings,
    Status,
    Vars,
    index,
    init_info,
    resolve_device,
    zero_vars,
)
from .utils.profiling import annotate

def _route_backend(data, settings: Settings):
    """Re-wrap dense data in the type that selects ``settings.kkt_solver``
    (``piqp_tpu/api.py:42-72``): ``dense_lu`` -> FullKKTQPData,
    ``dense_ldlt`` -> LDLTKKTQPData.  Other data (stage blocks) and the
    other backends keep their type, as in the JAX package: ``multistage``
    and ``sparse_host`` on dense data run the condensed dense backend (the
    host sparse route is ``SparseSolver``'s)."""
    if type(data) is QPData:
        cls = {KKTBackend.dense_lu: FullKKTQPData,
               KKTBackend.dense_ldlt: LDLTKKTQPData}.get(settings.kkt_solver)
        if cls is not None:
            return cls(**{f.name: getattr(data, f.name)
                          for f in dataclasses.fields(QPData)})
    return data


def _as_2d(M, rows, cols, dtype):
    if M is None:
        return np.zeros((rows, cols), dtype=dtype)
    M = np.asarray(M, dtype=dtype)
    if M.shape != (rows, cols):
        raise ValueError(f"expected shape {(rows, cols)}, got {M.shape}")
    return M


def _as_1d(v, size, dtype, fill):
    if v is None:
        return np.full(size, fill, dtype=dtype)
    v = np.asarray(v, dtype=dtype)
    if v.shape != (size,):
        raise ValueError(f"expected shape {(size,)}, got {v.shape}")
    return v


def _canon_bounds(h_l, h_u, x_l, x_u):
    """Bound canonicalization: masks from the PIQP_INF convention
    (dense/data.hpp:100-142), dead-row fake bounds [-1, 1]
    (dense/data.hpp:144-169), exact zeros at inactive entries.  Returns the
    vectors, the four masks and the dead-row mask."""
    hl_mask = h_l > -PIQP_INF
    hu_mask = h_u < PIQP_INF
    dead = ~hl_mask & ~hu_mask
    if dead.any():
        h_l = np.where(dead, -1.0, h_l)
        h_u = np.where(dead, 1.0, h_u)
        hl_mask = h_l > -PIQP_INF
        hu_mask = h_u < PIQP_INF

    xl_mask = x_l > -PIQP_INF
    xu_mask = x_u < PIQP_INF

    h_l = np.where(hl_mask, h_l, 0.0)
    h_u = np.where(hu_mask, h_u, 0.0)
    x_l = np.where(xl_mask, x_l, 0.0)
    x_u = np.where(xu_mask, x_u, 0.0)
    return h_l, h_u, x_l, x_u, hl_mask, hu_mask, xl_mask, xu_mask, dead


def _symmetrize(P) -> np.ndarray:
    """Use the upper triangle of P only (solver.hpp:182)."""
    return np.triu(P) + np.triu(P, 1).T


def prepare_data(
    P, c, A=None, b=None, G=None, h_l=None, h_u=None, x_l=None, x_u=None,
    dtype=torch.float64, device=None,
) -> QPData:
    """Canonicalize one QP into the masked representation, as a batch of
    one on ``device`` (CUDA unless the caller passes another), through
    ``batch.prepare_batch``:

      - only the upper triangle of P is used and symmetrized;
      - bounds with magnitude >= 1e30 (PIQP_INF) are inactive;
      - rows of G with neither bound are zeroed and get fake bounds [-1, 1].
    """
    from .batch import prepare_batch

    prob = dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l, h_u=h_u, x_l=x_l, x_u=x_u)
    return prepare_batch([prob], dtype, device)


def has_cone(data: QPData) -> bool:
    """Static dispatch flag: any inequality or bound constraint present in
    the batch (the reference's ``m + n_x_l + n_x_u > 0``, solver.hpp:504)."""
    return bool(data.m > 0 or bool(data.xl_mask.any()) or bool(data.xu_mask.any()))


def _solve_fresh(data: QPData, settings: Settings, cone: bool, warm=None):
    """Equilibrate + solve; returns (result, scaling)."""
    with annotate("piqp.solve"):
        with annotate("piqp.ruiz"):
            sdata, sc = ruiz.equilibrate(
                data,
                max_iter=settings.preconditioner_iter,
                scale_cost=settings.preconditioner_scale_cost,
            )
        return solver.solve_scaled(sdata, sc, settings, cone, warm), sc


def _solve_reuse(data: QPData, sc: Scaling, settings: Settings, cone: bool, warm=None):
    with annotate("piqp.solve"):
        sdata = ruiz.apply_scaling(data, sc)
        return solver.solve_scaled(sdata, sc, settings, cone, warm)


def _warm_vars(warm) -> BasicVars | None:
    if isinstance(warm, Result):
        return BasicVars(x=warm.x, y=warm.y, z_l=warm.z_l, z_u=warm.z_u,
                         z_bl=warm.z_bl, z_bu=warm.z_bu)
    return warm


def solve_prepared(
    data: QPData, settings: Settings = Settings(),
    scaling: Optional[Scaling] = None, warm=None,
) -> Result:
    """Solve prepared (batched) data; the result is batched like the data.
    ``warm``: a previous batched ``Result`` (or ``BasicVars``) of nearby
    problems to warm-start from."""
    data = _route_backend(data, settings)
    cone = has_cone(data)
    warm = _warm_vars(warm)
    if scaling is not None:
        return _solve_reuse(data, scaling, settings, cone, warm)
    result, _ = _solve_fresh(data, settings, cone, warm)
    return result


def solve_dense(
    P, c, A=None, b=None, G=None, h_l=None, h_u=None, x_l=None, x_u=None,
    settings: Settings = Settings(), device=None,
) -> Result:
    """One-shot dense QP solve; the result has no batch dimension."""
    data = prepare_data(
        P, c, A, b, G, h_l, h_u, x_l, x_u, dtype=settings.torch_dtype,
        device=device,
    )
    return index(solve_prepared(data, settings), 0)


class _SettingsView:
    """Attribute-mutable view over a solver's frozen Settings
    (``solver.settings.eps_abs = 1e-9``); every set swaps a new frozen
    instance into the owning solver."""

    __slots__ = ("_solver",)

    def __init__(self, solver):
        object.__setattr__(self, "_solver", solver)

    def unwrap(self) -> Settings:
        return self._solver._settings

    def __getattr__(self, name):
        return getattr(self._solver._settings, name)

    def __setattr__(self, name, value):
        cur = self._solver._settings
        if not hasattr(cur, name):
            raise AttributeError(f"Settings has no field {name!r}")
        self._solver._settings = dataclasses.replace(cur, **{name: value})

    def __repr__(self):
        return repr(self._solver._settings)

    def __eq__(self, other):
        if isinstance(other, _SettingsView):
            other = other.unwrap()
        return self._solver._settings == other

    def __hash__(self):
        return hash(self._solver._settings)


class _SettingsProperty:
    """``settings`` descriptor of the stateful solver."""

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return _SettingsView(obj)

    def __set__(self, obj, value):
        if isinstance(value, _SettingsView):
            value = value.unwrap()
        if not isinstance(value, Settings):
            raise TypeError(f"expected Settings, got {type(value).__name__}")
        obj._settings = value


class DenseSolver:
    """Stateful solver mirroring piqp::DenseSolver (solver.hpp:1262-1291).

    Usage:
        solver = DenseSolver(device="cuda")
        solver.setup(P, c, A, b, G, h_l, h_u, x_l, x_u)
        status = solver.solve()
        x = solver.result.x
        solver.update(P=P2, h_u=h_u2)
        status = solver.solve(warm_start=True)
    """

    settings = _SettingsProperty()

    def __init__(self, settings: Settings = Settings(), device=None):
        self._settings = settings
        self._device = resolve_device(device)
        self._raw: dict = {}
        self._data: Optional[QPData] = None
        self._scaling: Optional[Scaling] = None
        self._result: Optional[Result] = None
        self._batched_result: Optional[Result] = None
        self._cone = True
        self._first_run = True
        self._setup_time = 0.0
        self._update_time = 0.0

    def setup(self, P, c, A=None, b=None, G=None, h_l=None, h_u=None,
              x_l=None, x_u=None) -> None:
        t0 = time.perf_counter()
        self._raw = dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l, h_u=h_u,
                         x_l=x_l, x_u=x_u)
        self._data = prepare_data(
            P, c, A, b, G, h_l, h_u, x_l, x_u,
            dtype=self._settings.torch_dtype, device=self._device,
        )
        self._cone = has_cone(self._data)
        np_dtype = self._np_dtype()
        m = self._data.m
        hl = _as_1d(h_l, m, np_dtype, -np.inf)
        hu = _as_1d(h_u, m, np_dtype, np.inf)
        self._dead = ~(hl > -PIQP_INF) & ~(hu < PIQP_INF)
        self._scaling = None
        self._first_run = True
        self._setup_time = time.perf_counter() - t0

    def _np_dtype(self):
        return np.dtype(self._settings.dtype)

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(v), device=self._device)[None]

    def update(self, P=None, c=None, A=None, b=None, G=None, h_l=None,
               h_u=None, x_l=None, x_u=None) -> None:
        """Update problem data in place (solver.hpp:218-359); shapes must
        match the setup call.  Only the changed fields are canonicalized
        and copied to the device."""
        if self._data is None:
            raise RuntimeError("Solver not setup yet")
        t0 = time.perf_counter()
        updates = dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l, h_u=h_u,
                       x_l=x_l, x_u=x_u)
        for k, v in updates.items():
            if v is not None:
                self._raw[k] = v

        d = self._data
        np_dtype = self._np_dtype()
        n, p, m = d.n, d.p, d.m
        new = {}

        bounds_changed = any(
            updates[k] is not None for k in ("h_l", "h_u", "x_l", "x_u")
        )
        if bounds_changed or updates["G"] is not None:
            hl = _as_1d(self._raw.get("h_l"), m, np_dtype, -np.inf)
            hu = _as_1d(self._raw.get("h_u"), m, np_dtype, np.inf)
            xl = _as_1d(self._raw.get("x_l"), n, np_dtype, -np.inf)
            xu = _as_1d(self._raw.get("x_u"), n, np_dtype, np.inf)
            hl, hu, xl, xu, hl_m, hu_m, xl_m, xu_m, dead = _canon_bounds(
                hl, hu, xl, xu
            )
            old_dead = self._dead
            self._dead = dead
            new.update(
                h_l=self._tensor(hl), h_u=self._tensor(hu),
                x_l=self._tensor(xl), x_u=self._tensor(xu),
                hl_mask=self._tensor(hl_m), hu_mask=self._tensor(hu_m),
                xl_mask=self._tensor(xl_m), xu_mask=self._tensor(xu_m),
            )
            if updates["G"] is None and not np.array_equal(dead, old_dead):
                # the dead-row pattern changed: re-canonicalize G
                updates["G"] = self._raw.get("G")

        if updates["P"] is not None:
            Pm = np.asarray(updates["P"], dtype=np_dtype)
            if Pm.shape != (n, n):
                raise ValueError(f"expected shape {(n, n)}, got {Pm.shape}")
            new["P"] = self._tensor(_symmetrize(Pm))
        if updates["A"] is not None:
            new["A"] = self._tensor(_as_2d(updates["A"], p, n, np_dtype))
        if updates["G"] is not None:
            Gm = _as_2d(updates["G"], m, n, np_dtype)
            if self._dead.any():
                Gm = Gm.copy()
                Gm[self._dead, :] = 0.0
            new["G"] = self._tensor(Gm)
        if updates["c"] is not None:
            new["c"] = self._tensor(_as_1d(updates["c"], n, np_dtype, 0.0))
        if updates["b"] is not None:
            new["b"] = self._tensor(_as_1d(updates["b"], p, np_dtype, 0.0))

        self._data = dataclasses.replace(d, **new)
        if bounds_changed:
            self._cone = has_cone(self._data)
        matrices_changed = any(updates[k] is not None for k in ("P", "A", "G"))
        if matrices_changed and not self._settings.preconditioner_reuse_on_update:
            self._scaling = None  # recompute Ruiz on the next solve
        self._update_time = time.perf_counter() - t0

    def solve(self, warm_start: bool = False) -> Status:
        """Solve the current problem.  ``warm_start=True`` seeds the IPM
        from the previous solve's iterates (x, y, z_*).

        With ``Settings.compute_timings`` the result's info carries the
        set-up, update, solve and run times from the host clock, and
        estimates of the cumulative KKT factor and solve times
        (``_measure_kkt_times``)."""
        if self._data is None:
            raise RuntimeError("Solver not setup yet")
        if not self._settings.verify():
            self._result = _invalid_result(self._settings, self._device)
            self._batched_result = None
            return Status.INVALID_SETTINGS
        data = _route_backend(self._data, self._settings)
        if self._settings.verbose:
            self._print_header()

        warm = None
        if warm_start and self._batched_result is not None:
            warm = _warm_vars(self._batched_result)

        t0 = time.perf_counter()
        if self._scaling is None or not self._settings.preconditioner_reuse_on_update:
            result, sc = _solve_fresh(data, self._settings, self._cone, warm)
            self._scaling = sc
        else:
            result = _solve_reuse(
                data, self._scaling, self._settings, self._cone, warm
            )
        status = Status(int(result.info.status[0]))  # waits for the device
        solve_time = time.perf_counter() - t0
        if self._settings.compute_timings:
            t_factor, t_solve = _measure_kkt_times(
                data, self._settings, int(result.info.iter[0]),
                int(result.info.factor_retires[0]),
            )
            result = _with_timings(
                result, setup_time=self._setup_time,
                update_time=self._update_time, solve_time=solve_time,
                kkt_factor_time=t_factor, kkt_solve_time=t_solve,
                run_time=(self._setup_time if self._first_run
                          else self._update_time) + solve_time,
            )
        self._first_run = False
        self._batched_result = result
        self._result = index(result, 0)
        if self._settings.verbose:
            print(f"\nstatus:               {status.name.lower()}")
            print(f"number of iterations: {int(self._result.info.iter)}")
            print(f"objective:            {float(self._result.info.primal_obj):.5e}")
        return status

    def _print_header(self):
        from . import __version__

        print("----------------------------------------------------------")
        print(f"         piqp_tpu_torch v{__version__} (PyTorch/CUDA)        ")
        print("----------------------------------------------------------")
        d = self._data
        print(f"variables n = {d.n}, equality constraints p = {d.p}, "
              f"inequality constraints m = {d.m}")
        print()
        print("iter  prim_obj       dual_obj       duality_gap   prim_res"
              "      dual_res      rho         delta       mu          "
              "p_step   d_step")

    @property
    def result(self) -> Result:
        """The last solve's result, without the batch dimension."""
        if self._result is None:
            raise RuntimeError("No solve has been performed yet")
        return self._result


def _with_timings(result: Result, **times: float) -> Result:
    """``result`` with the named time fields of its info set to the given
    seconds for every problem."""
    info = result.info
    return dataclasses.replace(result, info=dataclasses.replace(info, **{
        k: torch.full_like(getattr(info, k), v) for k, v in times.items()
    }))


def _elapsed(fn, device: torch.device) -> float:
    """Seconds of one call of ``fn`` after a warm-up call: CUDA events
    around it on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _measure_kkt_times(data, settings: Settings, iters: int, retries: int):
    """Estimates of the cumulative KKT factor and solve time of a solve
    (results.hpp:87-88), as the JAX package makes them
    (``piqp_tpu/api.py:560-603``): one factorization and one KKT solve of a
    cold-start state, each timed once after a warm-up call, scaled by the
    run's counts, iters + 1 + retries factorizations and 2 iters + 1 KKT
    solves.  They are estimates, not measurements of the solve: the probe
    runs outside the IPM loop, so the two need not sum to ``solve_time``.
    Nothing is timed inside the loop itself."""
    mixed = bool(settings.mixed_precision)
    B, dt, dev = data.B, data.c.dtype, data.c.device

    ones = [mask.to(dt) for mask in (data.hl_mask, data.hu_mask, data.xl_mask, data.xu_mask)]
    v = Vars(data.c.new_zeros((B, data.n)), data.c.new_zeros((B, data.p)), *ones, *ones)
    ks = kkt.compute_scalings(
        data, settings, v,
        torch.full((B,), settings.rho_init, dtype=dt, device=dev),
        torch.full((B,), settings.delta_init, dtype=dt, device=dev),
        torch.zeros((B,), dtype=torch.bool, device=dev),
        ops.P_diag(data),
    )
    pre = kkt.precompute(data, mixed)
    inverse = settings.factor_inverse
    ks, _ = kkt.factor(data, ks, mixed, pre, inverse)
    t_factor = _elapsed(lambda: kkt.factor(data, ks, mixed, pre, inverse), dev)
    t_solve = _elapsed(lambda: kkt.solve(data, settings, ks, v), dev)
    return t_factor * (iters + 1 + retries), t_solve * (2 * iters + 1)


def _invalid_result(settings: Settings, device) -> Result:
    """Placeholder result carrying only the INVALID_SETTINGS status."""
    info = index(init_info(settings, 1, settings.torch_dtype, device), 0)
    info = dataclasses.replace(
        info, status=torch.tensor(int(Status.INVALID_SETTINGS), dtype=torch.int32)
    )
    v = index(zero_vars(1, 0, 0, 0, settings.torch_dtype, device), 0)
    return Result(
        **{f.name: getattr(v, f.name) for f in dataclasses.fields(v)}, info=info
    )
