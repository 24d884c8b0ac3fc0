"""The port's examples (examples/torch_*.py) on the CPU, each through its
``main(device="cpu")``: the batch example solves every problem (and over
a gloo process group of one rank); the MPC example's x lies within 1e-8
(scaled by max(1, |x|)) of ``piqp_tpu.solve_prepared`` on the same stage
blocks, cold and through the warm loop, with equal iterations; the
differentiable example's first gradient lies within rel 1e-6 of
``jax.grad`` through ``piqp_tpu.solve_qp_diff`` on the same data (the JAX
example's own functions), and its loss falls below 1e-6."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import piqp_tpu
from piqp_tpu import multistage as jms

from test_torch_horizon_ranks import gloo  # noqa: F401  (fixture)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(np.asarray(got) - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} x {scale:.3e}"


def test_batch_example_solves_every_problem():
    out = _load("torch_batch_example").main(device="cpu")
    B = _load("torch_batch_example").B
    for key in ("status", "warm_status", "compact_status"):
        assert out[key].shape == (B,) and (out[key] == 1).all(), key
    assert out["warm_iters"].max() < out["iters"].max()
    assert "sharded_status" not in out


def test_batch_example_over_a_process_group(gloo):  # noqa: F811
    out = _load("torch_batch_example").main(device="cpu")
    assert (out["sharded_status"] == 1).all()


def test_mpc_example_matches_jax():
    ex = _load("torch_mpc_example")
    out = ex.main(device="cpu")
    x_ref, warm = np.zeros(2), None
    for k in range(ex.STEPS + 1):
        if k:
            x_ref = x_ref + ex.SHIFT
        res = piqp_tpu.solve_prepared(jms.from_stage_blocks(**ex.stage_blocks(x_ref)),
                                      piqp_tpu.Settings(pallas_kernels=True), warm=warm)
        warm = res
        assert out["status"][k] == int(res.info.status) == 1, k
        assert out["iters"][k] == int(res.info.iter), k
        _close(out["x"][k], res.x, 1e-8, f"step {k} x")


def test_diff_mpc_example_first_gradient_matches_jax():
    ex = _load("torch_diff_mpc_example")
    out = ex.main(device="cpu")
    assert out["final_loss"] < 1e-6 and out["losses"][-1] < out["losses"][0]
    assert np.isfinite(out["structured_grad"])

    jex = _load("diff_mpc_example")  # the JAX example's own functions
    T = jex.T
    P0, c0 = jex.qp_of_weights(*ex.START)
    data = piqp_tpu.prepare_data(np.asarray(P0), np.asarray(c0),
                                 x_l=-jex.u_max * np.ones(T), x_u=jex.u_max * np.ones(T))
    u_expert = jex.controls(*ex.EXPERT, data)
    x_expert = jnp.asarray(jex.Gm) @ u_expert + jnp.asarray(jex.F @ jex.x0)

    def loss(theta):
        u = jex.controls(jnp.exp(theta[0]), jnp.exp(theta[1]), jnp.exp(theta[2]), data)
        x = jnp.asarray(jex.Gm) @ u + jnp.asarray(jex.F @ jex.x0)
        return jnp.mean((x - x_expert) ** 2) + 1e-3 * jnp.mean((u - u_expert) ** 2)

    value, grad = jax.value_and_grad(loss)(jnp.log(jnp.array(ex.START)))
    assert out["losses"][0] == pytest.approx(float(value), rel=1e-8)
    _close(out["first_grad"] / np.abs(grad).max(), np.asarray(grad) / np.abs(grad).max(),
           1e-6, "first gradient (relative to its largest entry)")
