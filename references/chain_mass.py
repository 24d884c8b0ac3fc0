"""The chain of masses as a fleet of linear MPC problems: a plain reference.

The model is the chain of masses of Wirsching, Bock & Diehl, "Fast NMPC of
a chain of masses connected by springs" (IEEE CCA 2006), with the settings
of acados' example ``examples/acados_python/chain_mass``
(``get_chain_params``; Verschueren et al., "acados", Math. Prog. Comp.
2022): ``n_mass`` masses in a chain, the first fixed at the origin, the
last moved by its velocity, the ``M = n_mass - 2`` between them free.

- State x = (p_1 ... p_{M+1}, v_1 ... v_M) in R^{6M+3}, control
  u = dp_{M+1}/dt in R^3.
- Spring k = 1 ... M+1, with p_0 = 0:
  F_k = D (1 - L / |p_k - p_{k-1}|) (p_k - p_{k-1}).
- dv_i/dt = (F_{i+1} - F_i) / m + g, dp_i/dt = v_i (i = 1 ... M).
- Rest: v = 0, p_{M+1} = (6 L (M + 1), 0, 0) (acados' ``xEndRef``) and
  p_1 ... p_M from Newton on the force balance.
- Cost W = blkdiag(Q, R): Q = 2 diag(1, ..., 1, M + 1 on the end mass's
  three positions, 1, ...), R = 2e-2 I_3, W_e = Q.
- Bounds |u| <= 1; the wall y >= -0.05 (``yPosWall``) on p_1 ... p_M,
  hard.

The QP, in deviation variables from the rest state, over z = (u_0, dx_1,
..., u_{N-1}, dx_N) in this natural forward order:

    min sum_{t<N} 0.5 (dx_{t+1}' Q dx_{t+1} + u_t' R u_t) + c'z
    s.t. dx_{t+1} = A_d dx_t + B_d u_t  (dx_0 given),  -1 <= u_t <= 1,
         the y-coordinates of p_1 ... p_M in dx_{t+1} >= -0.05.

Where this departs from acados' example, on purpose:

- linear MPC at the rest state: acados runs an SQP on the nonlinear model;
- the exact zero-order hold, [A_d B_d; 0 I] = exp([A_c B_c; 0 0] Ts):
  acados integrates with an explicit Runge-Kutta scheme;
- dx_0's constant cost 0.5 dx_0' Q dx_0 is dropped;
- the wall: acados' example puts it on the y-coordinates of all M + 1
  moving positions, the actuated end's too, as a soft constraint (its
  slacks weighted 1e3 quadratically and 1 linearly); here it is M hard
  rows, on p_1 ... p_M.  The draw of initial states keeps the
  chain off it: no optimum of the fleets solved so far touches it, so
  the wall's rows shape no solution there.

The model is derived in plain PyTorch, float64, on the CPU (TF32 off, as
everywhere a float32 product could run on a card): the dynamics f(x, u),
the rest state, A_c and B_c by ``torch.autograd.functional.jacobian``, the
hold by ``torch.linalg.matrix_exp``, the LQR gain by the Riccati
recursion iterated to convergence.  The initial states are drawn with
numpy's generator from a seed.  This module imports numpy and torch only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DTYPE = torch.float64
# acados examples/acados_python/chain_mass, get_chain_params
TS = 0.2  # s, the sample time
MASS = 0.033  # kg, each free mass
SPRING = 1.0  # N/m, D
REST_LENGTH = 0.033  # m, L
U_MAX = 1.0  # m/s, |u| <= U_MAX in each coordinate
WALL = -0.05  # m, yPosWall
GRAVITY = (0.0, 0.0, -9.81)
NU = 3
# Newton on the rest state, and the Riccati recursion: stop once the step
# (the change of the cost-to-go matrix) is this small relative to its size
NEWTON_TOL = 1e-14
RICCATI_TOL = 1e-12
MAX_STEPS = 100_000
# pushes at the bound, then steps of the clipped LQR, before the state is
# handed to the MPC: 1-3 and 0-9, each uniform
PUSHES = (1, 4)
SETTLE = (0, 10)


def free_masses(n_mass: int) -> int:
    return n_mass - 2


def state_size(n_mass: int) -> int:
    """nx = 6M + 3: the positions of the M free masses and the end, and
    the free masses' velocities."""
    return 6 * free_masses(n_mass) + 3


def wall_rows(n_mass: int) -> list:
    """The indices in x of the y-coordinates of p_1 ... p_M."""
    return [3 * i + 1 for i in range(free_masses(n_mass))]


def end_position(n_mass: int) -> torch.Tensor:
    """p_{M+1} at rest: (6 L (M + 1), 0, 0), acados' ``xEndRef``."""
    return torch.tensor([6.0 * REST_LENGTH * (free_masses(n_mass) + 1), 0.0, 0.0], dtype=DTYPE)


def spring_forces(p: torch.Tensor) -> torch.Tensor:
    """F_k (M + 1, 3) of the springs k = 1 ... M + 1 for the positions
    p = (p_1 ... p_{M+1}) (M + 1, 3), with p_0 = 0."""
    d = p - torch.cat([p.new_zeros(1, 3), p[:-1]])
    return SPRING * (1.0 - REST_LENGTH / torch.linalg.vector_norm(d, dim=-1, keepdim=True)) * d


def accelerations(p: torch.Tensor) -> torch.Tensor:
    """dv_i/dt (M, 3) of the free masses."""
    F = spring_forces(p)
    return (F[1:] - F[:-1]) / MASS + torch.tensor(GRAVITY, dtype=p.dtype)


def dynamics(x: torch.Tensor, u: torch.Tensor, n_mass: int) -> torch.Tensor:
    """f(x, u) = dx/dt: (v_1 ... v_M, u, dv_1/dt ... dv_M/dt), acados'
    ``f_expl``."""
    M = free_masses(n_mass)
    p = x[:3 * (M + 1)].reshape(M + 1, 3)
    v = x[3 * (M + 1):]
    return torch.cat([v, u, accelerations(p).reshape(-1)])


def rest_state(n_mass: int) -> torch.Tensor:
    """x at rest: v = 0, the end at ``end_position``, the free masses where
    the force balance holds, by Newton from the straight line between the
    two ends."""
    M = free_masses(n_mass)
    end = end_position(n_mass)

    def residual(q):
        return accelerations(torch.cat([q.reshape(M, 3), end[None]])).reshape(-1)

    q = (torch.arange(1, M + 1, dtype=DTYPE)[:, None] / (M + 1) * end).reshape(-1)
    for _ in range(100):
        J = torch.autograd.functional.jacobian(residual, q)
        step = torch.linalg.solve(J, residual(q))
        q = q - step
        if float(step.abs().max()) <= NEWTON_TOL * max(1.0, float(q.abs().max())):
            break
    return torch.cat([q, end, torch.zeros(3 * M, dtype=DTYPE)])


def linearised(n_mass: int) -> tuple:
    """(A_c, B_c): the Jacobians of f at (rest, u = 0)."""
    x = rest_state(n_mass)
    u = torch.zeros(NU, dtype=DTYPE)
    A_c, B_c = torch.autograd.functional.jacobian(lambda x, u: dynamics(x, u, n_mass), (x, u))
    return A_c, B_c


def zero_order_hold(A_c: torch.Tensor, B_c: torch.Tensor, ts: float = TS) -> tuple:
    """(A_d, B_d) of the exact hold: [A_d B_d; 0 I] = exp([A_c B_c; 0 0] ts)."""
    nx, nu = B_c.shape
    Mc = torch.zeros(nx + nu, nx + nu, dtype=DTYPE)
    Mc[:nx, :nx] = A_c
    Mc[:nx, nx:] = B_c
    E = torch.linalg.matrix_exp(Mc * ts)
    return E[:nx, :nx].contiguous(), E[:nx, nx:].contiguous()


def weights(n_mass: int) -> tuple:
    """(Q, R) of acados' example: Q = 2 diag(q) with q = M + 1 on the end
    mass's positions and 1 elsewhere, R = 2e-2 I."""
    M = free_masses(n_mass)
    q = torch.ones(state_size(n_mass), dtype=DTYPE)
    q[3 * M:3 * M + 3] = M + 1
    return 2.0 * torch.diag(q), 2.0 * 1e-2 * torch.eye(NU, dtype=DTYPE)


def lqr_gain(A: torch.Tensor, B: torch.Tensor, Q: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """K with u = K x: the infinite-horizon discrete LQR gain, from the
    Riccati recursion P <- Q + A'P(A + BK), K = -(R + B'PB)^-1 B'PA,
    iterated until P stops moving."""
    P = Q.clone()
    for _ in range(MAX_STEPS):
        K = -torch.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        nxt = Q + A.T @ P @ (A + B @ K)
        nxt = 0.5 * (nxt + nxt.T)
        done = float((nxt - P).abs().max()) <= RICCATI_TOL * float(nxt.abs().max())
        P = nxt
        if done:
            return -torch.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
    raise RuntimeError("the Riccati recursion did not converge")


@functools.lru_cache(maxsize=4)
def model(n_mass: int) -> dict:
    """Everything the fleet shares, as float64 numpy arrays: the rest
    state, A_d, B_d, Q, R and the LQR gain K."""
    A_c, B_c = linearised(n_mass)
    A, B = zero_order_hold(A_c, B_c)
    Q, R = weights(n_mass)
    K = lqr_gain(A, B, Q, R)
    out = dict(rest=rest_state(n_mass), A=A, B=B, Q=Q, R=R, K=K)
    return {k: v.numpy() for k, v in out.items()}


def wall_bound(n_mass: int) -> np.ndarray:
    """The wall as lower bounds on the wall rows of dx: WALL minus the rest
    state's y-coordinate."""
    rows = wall_rows(n_mass)
    return WALL - model(n_mass)["rest"][rows]


def clipped_lqr(mdl: dict, x: np.ndarray) -> np.ndarray:
    return np.clip(mdl["K"] @ x, -U_MAX, U_MAX)


def keeps_the_wall(n_mass: int, x0: np.ndarray, N: int) -> bool:
    """Whether the clipped LQR, run for N steps from x0, keeps every wall
    row of dx_1 ... dx_N: then (u_t, dx_{t+1}) of that run is a feasible
    point of the QP."""
    mdl = model(n_mass)
    rows, low = wall_rows(n_mass), wall_bound(n_mass)
    x = x0
    for _ in range(N):
        x = mdl["A"] @ x + mdl["B"] @ clipped_lqr(mdl, x)
        if (x[rows] < low).any():
            return False
    return True


def initial_state(n_mass: int, N: int, seed: int) -> np.ndarray:
    """dx_0 of one problem, from its seed: a push at the bound, d with
    entries uniform in [-1, 1] scaled so that max |d| = 1, for 1-3 steps,
    then 0-9 steps of the clipped LQR; redrawn from the same stream until
    ``keeps_the_wall``."""
    mdl = model(n_mass)
    rng = np.random.default_rng(seed)
    while True:
        d = rng.uniform(-1.0, 1.0, NU)
        d = U_MAX * d / np.abs(d).max()
        pushes = int(rng.integers(*PUSHES))
        settle = int(rng.integers(*SETTLE))
        x = np.zeros(state_size(n_mass))
        for _ in range(pushes):
            x = mdl["A"] @ x + mdl["B"] @ d
        for _ in range(settle):
            x = mdl["A"] @ x + mdl["B"] @ clipped_lqr(mdl, x)
        if keeps_the_wall(n_mass, x, N):
            return x


def initial_rows(n_mass: int, x0: np.ndarray) -> np.ndarray:
    """The right-hand side of the first dynamics rows, A_d dx_0."""
    return model(n_mass)["A"] @ x0


def natural_qp(n_mass: int, N: int, x0: np.ndarray) -> dict:
    """The QP in natural forward order, z = (u_0, dx_1, ..., u_{N-1},
    dx_N): dense P, c (zeros), A, b, G (no rows), h_l, h_u, x_l, x_u,
    infinite bounds as +-inf."""
    mdl = model(n_mass)
    nx = state_size(n_mass)
    D = NU + nx
    n = N * D
    P = np.zeros((n, n))
    A = np.zeros((N * nx, n))
    stage = np.zeros((D, D))
    stage[:NU, :NU] = mdl["R"]
    stage[NU:, NU:] = mdl["Q"]
    x_l = np.full(D, -np.inf)
    x_u = np.full(D, np.inf)
    x_l[:NU], x_u[:NU] = -U_MAX, U_MAX
    x_l[[NU + r for r in wall_rows(n_mass)]] = wall_bound(n_mass)
    for t in range(N):
        at, rows = slice(t * D, (t + 1) * D), slice(t * nx, (t + 1) * nx)
        P[at, at] = stage
        # dx_{t+1} - B_d u_t - A_d dx_t = 0
        A[rows, t * D:t * D + NU] = -mdl["B"]
        A[rows, t * D + NU:(t + 1) * D] = np.eye(nx)
        if t:
            A[rows, (t - 1) * D + NU:t * D] = -mdl["A"]
    b = np.zeros(N * nx)
    b[:nx] = initial_rows(n_mass, x0)
    return dict(P=P, c=np.zeros(n), A=A, b=b, G=np.zeros((0, n)), h_l=np.zeros(0),
                h_u=np.zeros(0), x_l=np.tile(x_l, N), x_u=np.tile(x_u, N))
