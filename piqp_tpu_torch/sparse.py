"""Sparse problem front end (``piqp_tpu/sparse.py``): piqp::SparseSolver's
API (solver.hpp:1293-1322) over scipy.sparse inputs.

- ``kkt_solver=multistage``: host-side structure detection (the port's
  C++ library, ``_native``) turns the problem into stage blocks
  (``multistage.from_sparse``) and the block-tridiagonal + arrow backend
  solves it on the device.  Without usable structure it falls back to the
  dense route when ``multistage_fallback`` is True.
- ``kkt_solver=sparse_host``, or a ``dense_cholesky`` problem with more
  than ``dense_routing_max_n`` variables: the host sparse route, the
  NumPy/SciPy IPM of ``hostsparse.py`` on the CPU, as in the JAX package.
  The settings or the size choose it; it is never a fallback from the
  card.  Its result is a numpy ``hostsparse.HostResult``.
- Otherwise the problem is densified and solved by the dense backend
  ``kkt_solver`` names.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .api import (
    DenseSolver,
    _measure_kkt_times,
    _route_backend,
    _solve_fresh,
    _with_timings,
    has_cone,
)
from .hostsparse import HostResult, solve_sparse_host
from .types import BasicVars, KKTBackend, Result, Settings, Status, index


def _to_dense(M):
    if M is None:
        return None
    if hasattr(M, "toarray"):
        return M.toarray()
    return np.asarray(M)


class _PermutedResult:
    """User-order view of one stage-layout Result (no batch dimension):
    tensors on the result's device."""

    def __init__(self, res: Result, layout):
        dev = res.x.device

        def idx(a):
            return torch.as_tensor(a, device=dev)

        vm, am, gm = idx(layout.var_map), idx(layout.a_row_map), idx(layout.g_row_map)
        empty = res.x.new_zeros(0)
        self.info = res.info
        self.x = res.x[vm]
        self.y = res.y[am] if layout.p else empty
        self.z_l = res.z_l[gm] if layout.m else empty
        self.z_u = res.z_u[gm] if layout.m else empty
        self.s_l = res.s_l[gm] if layout.m else empty
        self.s_u = res.s_u[gm] if layout.m else empty
        self.z_bl = res.z_bl[vm]
        self.z_bu = res.z_bu[vm]
        self.s_bl = res.s_bl[vm]
        self.s_bu = res.s_bu[vm]


class SparseSolver(DenseSolver):
    """Sparse-input solver with PIQP's SparseSolver API.  Accepts
    scipy.sparse matrices (any format) or dense arrays for P, A, G; runs on
    the CUDA device unless ``device`` names another.  ``host_kkt_mode`` is
    the KKT elimination level of the host sparse route ("auto", "full",
    "eq", "ineq" or "cond"; ``hostsparse._KKT``)."""

    #: densify at most this many variables unless
    #: ``Settings.dense_routing_max_n`` says otherwise (the JAX package's
    #: default; a larger problem goes to the host sparse route)
    DENSE_ROUTING_MAX_N = 512

    def __init__(self, settings: Settings = Settings(), device=None,
                 multistage_fallback: bool = True, host_kkt_mode: str = "auto"):
        super().__init__(settings, device)
        self._multistage_fallback = multistage_fallback
        self._host_kkt_mode = host_kkt_mode
        self._host_raw = None
        self._stage_data = None
        self._layout = None
        self._stage_raw = None
        self._stage_result = None

    @property
    def _dense_routing_max_n(self) -> int:
        cap = self._settings.dense_routing_max_n
        return self.DENSE_ROUTING_MAX_N if cap is None else cap

    def setup(self, P, c, A=None, b=None, G=None, h_l=None, h_u=None,
              x_l=None, x_u=None) -> None:
        self._stage_data = self._layout = self._stage_result = None
        self._host_raw = None
        if self._settings.kkt_solver == KKTBackend.multistage:
            from . import multistage as ms

            try:
                self._stage_raw = dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l,
                                       h_u=h_u, x_l=x_l, x_u=x_u)
                self._stage_data, self._layout = ms.from_sparse(
                    P, c, A, b, G, h_l, h_u, x_l, x_u,
                    dtype=self._settings.torch_dtype, device=self._device,
                )
                self._cone = has_cone(self._stage_data)
                self._result = None
                return
            except ValueError:
                if not self._multistage_fallback:
                    raise
                self._stage_data = self._layout = None
        n = P.shape[0] if hasattr(P, "shape") else np.asarray(P).shape[0]
        if self._settings.kkt_solver == KKTBackend.sparse_host or (
            self._settings.kkt_solver == KKTBackend.dense_cholesky
            and n > self._dense_routing_max_n
        ):
            self._host_raw = dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l,
                                  h_u=h_u, x_l=x_l, x_u=x_u)
            self._result = None
            return
        super().setup(_to_dense(P), c, _to_dense(A), b, _to_dense(G), h_l, h_u, x_l, x_u)

    def update(self, P=None, c=None, A=None, b=None, G=None, h_l=None,
               h_u=None, x_l=None, x_u=None) -> None:
        if self._host_raw is not None:
            updates = dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l, h_u=h_u,
                           x_l=x_l, x_u=x_u)
            self._host_raw.update({k: v for k, v in updates.items() if v is not None})
            return
        if self._stage_data is None:
            super().update(_to_dense(P), c, _to_dense(A), b, _to_dense(G),
                           h_l, h_u, x_l, x_u)
            return
        from . import multistage as ms

        updates = dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l, h_u=h_u, x_l=x_l, x_u=x_u)
        for k, v in updates.items():
            if v is not None:
                self._stage_raw[k] = v
        if P is None and A is None and G is None:
            # vectors only: the stage blocks stay the same device tensors,
            # unless the dead-row pattern changed
            sr = self._stage_raw
            new = ms.update_vectors(
                self._layout, self._stage_data, c=sr["c"], b=sr.get("b"),
                h_l=sr.get("h_l"), h_u=sr.get("h_u"), x_l=sr.get("x_l"),
                x_u=sr.get("x_u"),
            )
            if new is not None:
                self._stage_data = new
                self._cone = has_cone(new)
                return
        # values re-scattered through the cached maps, no structure detection
        self._stage_data, self._layout = ms.update_values(
            self._layout, **self._stage_raw, dtype=self._settings.torch_dtype,
            device=self._device,
        )
        self._cone = has_cone(self._stage_data)

    def solve(self, warm_start: bool = False) -> Status:
        """Solve; ``warm_start=True`` seeds the IPM from the previous
        solve's iterates (stage layout, before the permutation back, or
        the host route's last ``HostResult``).  The host route's info
        carries its exact cumulative timers; the stage route fills the
        solve, run and KKT time estimates with ``compute_timings``."""
        if self._host_raw is not None:
            if not self._settings.verify():
                return Status.INVALID_SETTINGS
            hwarm = self._result if warm_start and isinstance(self._result, HostResult) else None
            self._result = solve_sparse_host(
                **self._host_raw, settings=self._settings,
                verbose=self._settings.verbose, warm=hwarm,
                kkt_mode=self._host_kkt_mode,
            )
            return Status(int(self._result.info.status))
        if self._stage_data is None:
            return super().solve(warm_start)
        if not self._settings.verify():
            return Status.INVALID_SETTINGS
        data = _route_backend(self._stage_data, self._settings)
        warm = None
        if warm_start and self._stage_result is not None:
            r = self._stage_result
            warm = BasicVars(x=r.x, y=r.y, z_l=r.z_l, z_u=r.z_u, z_bl=r.z_bl, z_bu=r.z_bu)
        t0 = time.perf_counter()
        res, _ = _solve_fresh(data, self._settings, self._cone, warm)
        status = Status(int(res.info.status[0]))  # waits for the device
        solve_time = time.perf_counter() - t0
        if self._settings.compute_timings:
            t_factor, t_solve = _measure_kkt_times(
                data, self._settings, int(res.info.iter[0]),
                int(res.info.factor_retires[0]),
            )
            res = _with_timings(res, solve_time=solve_time, kkt_factor_time=t_factor,
                                kkt_solve_time=t_solve, run_time=solve_time)
        self._stage_result = res
        self._result = _PermutedResult(index(res, 0), self._layout)
        return status
