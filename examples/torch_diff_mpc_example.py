"""Differentiable MPC with the PyTorch/CUDA port: tune a controller's cost
weights by gradient descent through the QP solver
(examples/diff_mpc_example.py with JAX and optax).

A condensed finite-horizon LQR-with-constraints problem is solved as a
dense QP; the loss is the tracking error of the resulting trajectory
against an expert trajectory.  ``piqp_tpu_torch.solve_qp_diff`` makes the
argmin differentiable (implicit differentiation of the KKT system), so
``torch.optim.Adam`` reaches the cost weights: the learned-MPC /
inverse-optimal-control pattern.  A second part takes the gradient of a
multistage QP's solution in its stage-cost blocks.

Run: python examples/torch_diff_mpc_example.py [--device cuda|cpu]
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from piqp_tpu_torch import Settings, prepare_data, solve_qp_diff
from piqp_tpu_torch import multistage as ms

# double integrator, condensed over the horizon: decision vars = controls
T = 16
dt = 0.1
A_dyn = np.array([[1.0, dt], [0.0, 1.0]])
B_dyn = np.array([[0.5 * dt**2], [dt]])
x0 = np.array([1.0, 0.0])

# x_t = A^t x0 + sum_k A^(t-1-k) B u_k  ->  X = F x0 + G U
F = np.zeros((2 * T, 2))
Gm = np.zeros((2 * T, T))
Ak = np.eye(2)
for t in range(T):
    Ak = Ak @ A_dyn
    F[2 * t : 2 * t + 2] = Ak
    Aj = np.eye(2)
    for k in range(t, -1, -1):
        Gm[2 * t : 2 * t + 2, k : k + 1] = Aj @ B_dyn
        Aj = Aj @ A_dyn

u_max = 2.0
TIGHT = Settings(eps_abs=1e-11, eps_rel=1e-12)
# expert weights (q_pos, q_vel, r); the learner starts at START's
EXPERT = (25.0, 2.0, 0.05)
START = (5.0, 5.0, 0.5)
STEPS = 120
LR = 0.15


class Problem:
    """The condensed QP's pieces on one device."""

    def __init__(self, device):
        self.G = torch.as_tensor(Gm, device=device)
        self.Fx0 = torch.as_tensor(F @ x0, device=device)
        P0, c0 = self.qp_of_weights(*(torch.tensor(w, dtype=torch.float64, device=device)
                                      for w in START))
        self.template = prepare_data(
            P0.detach().cpu().numpy(), c0.detach().cpu().numpy(),
            x_l=-u_max * np.ones(T), x_u=u_max * np.ones(T), device=device,
        )

    def qp_of_weights(self, q_pos, q_vel, r):
        """min 0.5 U'(G'QG + R)U + (F x0)'QG U, |U| <= u_max."""
        eye = torch.eye(T, dtype=torch.float64, device=self.G.device)
        Q = torch.kron(eye, torch.diag(torch.stack([q_pos, q_vel])))
        P = self.G.T @ Q @ self.G + r * eye
        c = self.G.T @ Q @ self.Fx0
        return P, c

    def controls(self, q_pos, q_vel, r):
        P, c = self.qp_of_weights(q_pos, q_vel, r)
        d = dataclasses.replace(self.template, P=P[None], c=c[None])
        return solve_qp_diff(d, TIGHT, True).x[0]

    def trajectory(self, u):
        return self.G @ u + self.Fx0


def main(device=None) -> dict:
    """Learn the expert's behaviour with Adam, then the structured gradient.
    Returns the losses, the first gradient in log-weights, the learned
    weights and the structured gradient."""
    prob = Problem(device)
    expert = [torch.tensor(w, dtype=torch.float64, device=prob.G.device) for w in EXPERT]
    u_expert = prob.controls(*expert).detach()
    x_expert = prob.trajectory(u_expert)

    def loss(theta):
        w = torch.exp(theta)
        u = prob.controls(w[0], w[1], w[2])
        x = prob.trajectory(u)
        return torch.mean((x - x_expert) ** 2) + 1e-3 * torch.mean((u - u_expert) ** 2)

    # the weights are identifiable only up to a joint scale (scaling
    # (q_pos, q_vel, r) together leaves the argmin unchanged), so the check
    # is behavioural: the learned controller reproduces the expert
    # trajectory, not the expert's weights
    theta = torch.log(torch.tensor(START, dtype=torch.float64, device=prob.G.device))
    theta.requires_grad_()
    opt = torch.optim.Adam([theta], lr=LR)
    losses, first_grad = [], None
    print("step  loss        weights (q_pos, q_vel, r)")
    for it in range(STEPS):
        opt.zero_grad()
        val = loss(theta)
        val.backward()
        if first_grad is None:
            first_grad = theta.grad.detach().cpu().numpy().copy()
        losses.append(float(val.detach()))
        opt.step()
        if it % 15 == 0 or it == STEPS - 1:
            w = np.exp(theta.detach().cpu().numpy())
            print(f"{it:4d}  {losses[-1]:.3e}  {w.round(3)}")
    with torch.no_grad():
        final = float(loss(theta.detach()))
    assert final < 1e-6, final
    print("recovered expert behaviour through the solver: loss", final)
    return dict(losses=losses, final_loss=final, first_grad=first_grad,
                weights=np.exp(theta.detach().cpu().numpy()),
                structured_grad=structured(device))


def structured(device=None) -> float:
    """The same pattern through the structured backend: the gradient lands
    on the stage-cost blocks Pd of a multistage QP, and the adjoint solve
    reuses the block-tridiagonal factorization."""
    sdata = ms.random_multistage_qp(T=8, D=3, Da=2, ra=1, rg=2, seed=0, device=device)
    scale = torch.ones((), dtype=torch.float64, device=sdata.Pd.device, requires_grad=True)
    d = dataclasses.replace(sdata, Pd=sdata.Pd * scale)
    x = solve_qp_diff(d, TIGHT, True).x
    torch.mean((x - 0.05) ** 2).backward()
    g = float(scale.grad)
    print(f"structured: dL/d(stage-cost scale) = {g:+.4f} "
          f"(adjoint via the block-tridiagonal factorization)")
    assert np.isfinite(g)
    return g


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; pass cpu without a GPU)")
    main(parser.parse_args().device)
