"""Model-predictive control with the PyTorch/CUDA port: a double-integrator
tracking problem built directly as stage blocks, solved with the multistage
backend, then re-solved in a warm loop as the reference shifts (the
SQP/MPC usage pattern; examples/mpc_example.py with JAX).

Run: python examples/torch_mpc_example.py [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from piqp_tpu_torch import Status, solve_prepared
from piqp_tpu_torch import multistage as ms

# double integrator: state (pos, vel), control accel; stage var = (x, u)
T = 32          # horizon
dt = 0.1
D = 3           # per-stage variables: pos, vel, accel
STEPS = 3       # warm re-solves, each with the reference moved by SHIFT
SHIFT = np.array([0.1, 0.0])

A_dyn = np.array([[1.0, dt], [0.0, 1.0]])
B_dyn = np.array([[0.5 * dt**2], [dt]])

Q = np.diag([10.0, 1.0])
R = np.array([[0.1]])
X0 = np.array([1.0, 0.0])


def stage_blocks(x_ref) -> dict:
    """The problem's stage blocks (keyword arguments of
    ``multistage.from_stage_blocks``)."""
    # quadratic cost per stage: (x - x_ref)' Q (x - x_ref) + u' R u
    Pd = np.zeros((T, D, D))
    Pd[:, :2, :2] = Q
    Pd[:, 2:, 2:] = R
    c = np.zeros((T, D))
    c[:, :2] = -Q @ x_ref
    # dynamics: x_{t+1} = A x_t + B u_t  ->  [A B] z_t - [I 0] z_{t+1} = 0
    A1 = np.zeros((T, 2, D))
    A1[:, :, :2] = A_dyn
    A1[:, :, 2:] = B_dyn
    A2 = np.zeros((T, 2, D))
    A2[:, :, :2] = -np.eye(2)
    A2[T - 1] = 0.0  # no successor for the last stage
    b = np.zeros((T, 2))
    # initial condition via the first stage's bounds
    x_l = np.full(T * D, -np.inf)
    x_u = np.full(T * D, np.inf)
    x_l[0:2] = x_u[0:2] = X0
    # control limits
    x_l[2::D] = -2.0
    x_u[2::D] = 2.0
    return dict(Pd=Pd, Psub=None, Pa=None, Pc=None, c=c.reshape(-1),
                A1=A1, A2=A2, Ag=None, b=b.reshape(-1), x_l=x_l, x_u=x_u)


def tracking_error(x, x_ref) -> float:
    """How close the planned positions come to the reference.  The last
    stage's dynamics row has no successor, so it pins the state after the
    horizon to the origin and the plan turns back there at its end."""
    return float(np.abs(x[: T * D].reshape(T, D)[:, 0] - x_ref[0]).min())


def main(device=None) -> dict:
    """The cold solve and the warm loop.  Returns each solve's x (host),
    status, iterations and tracking error."""
    x_ref = np.zeros(2)  # drive to the origin
    res = solve_prepared(ms.from_stage_blocks(**stage_blocks(x_ref), device=device))
    xs = res.x[0].cpu().numpy()
    out = dict(x=[xs], status=[int(res.info.status[0])], iters=[int(res.info.iter[0])],
               tracking=[tracking_error(xs, x_ref)])
    assert out["status"][0] == Status.SOLVED
    stages = xs[: T * D].reshape(T, D)
    print(f"solved in {out['iters'][0]} iterations on {res.x.device}")
    print("positions:", np.round(stages[:8, 0], 3), "...")
    print("controls: ", np.round(stages[:8, 2], 3), "...")

    # warm MPC loop: shift the reference, re-solve seeded from the previous
    # iterates (warm start cuts the iteration count)
    for k in range(STEPS):
        x_ref = x_ref + SHIFT
        res = solve_prepared(ms.from_stage_blocks(**stage_blocks(x_ref), device=device),
                             warm=res)
        xs = res.x[0].cpu().numpy()
        out["x"].append(xs)
        out["status"].append(int(res.info.status[0]))
        out["iters"].append(int(res.info.iter[0]))
        out["tracking"].append(tracking_error(xs, x_ref))
        print(f"step {k}: status={out['status'][-1]} iters={out['iters'][-1]} "
              f"(warm-started), tracking error {out['tracking'][-1]:.2e}")
        assert out["status"][-1] == Status.SOLVED
    # every plan reaches its reference within the horizon
    assert max(out["tracking"]) < 1e-2, out["tracking"]
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; pass cpu without a GPU)")
    main(parser.parse_args().device)
