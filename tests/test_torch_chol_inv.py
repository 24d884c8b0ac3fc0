"""K1, the batched Cholesky-with-inverse, in the PyTorch port: its plain
version against the JAX Pallas kernel (interpret mode on the CPU), the
non-finite contract on indefinite input, the inverse solve, and the
wrapper's argument checks.  The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piqp_tpu.ops.pallas_chol import _pallas_chol_inv_batched

from piqp_tpu_torch.ops import chol_inv


def _spd_batch(B, n, seed):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(-1, 1, (B, n, n))
    return Q @ np.swapaxes(Q, 1, 2) + n * np.eye(n)


@pytest.mark.parametrize("n", [8, 32, 100])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reference_matches_jax_kernel(n, dtype):
    K = _spd_batch(5, n, seed=n)
    Lj, Lij = (np.asarray(a) for a in _pallas_chol_inv_batched(jnp.asarray(K, dtype)))
    Lt, Lit = (a.numpy() for a in chol_inv.cholesky_with_inverse(
        torch.as_tensor(K, dtype=getattr(torch, dtype))))
    tol = 5e-5 if dtype == "float32" else 1e-11
    np.testing.assert_allclose(Lt, Lj, atol=tol, rtol=tol)
    np.testing.assert_allclose(Lit, Lij, atol=50 * tol, rtol=50 * tol)
    eye = np.broadcast_to(np.eye(n), K.shape)
    np.testing.assert_allclose(Lt @ Lit, eye, atol=50 * tol, rtol=0)
    # exact zeros above the diagonal of both factors
    iu = np.triu_indices(n, 1)
    assert not Lt[:, iu[0], iu[1]].any() and not Lit[:, iu[0], iu[1]].any()


def test_indefinite_gives_nonfinite_for_that_problem_only():
    K = _spd_batch(3, 12, seed=4)
    K[1, 5, 5] = -50.0  # problem 1 is indefinite
    for L, Linv in (
        (np.asarray(a) for a in _pallas_chol_inv_batched(jnp.asarray(K))),
        (a.numpy() for a in chol_inv.cholesky_with_inverse(torch.as_tensor(K))),
    ):
        fin = np.isfinite(L).all(axis=(1, 2)) & np.isfinite(Linv).all(axis=(1, 2))
        assert fin.tolist() == [True, False, True]


def test_inv_solve_roundtrip():
    K = torch.as_tensor(_spd_batch(4, 64, seed=3))
    _, Linv = chol_inv.cholesky_with_inverse(K)
    v = torch.as_tensor(np.random.default_rng(0).standard_normal((4, 64)))
    x = chol_inv.inv_solve(Linv, v)
    np.testing.assert_allclose((K @ x[..., None])[..., 0].numpy(), v.numpy(), atol=1e-9)


@pytest.mark.parametrize(
    "K",
    [
        torch.eye(4, dtype=torch.float16)[None],
        torch.zeros((2, 4, 5), dtype=torch.float64),
        torch.eye(4, dtype=torch.float64),
    ],
    ids=["float16", "non-square", "unbatched"],
)
def test_wrapper_rejects_bad_input(K):
    with pytest.raises((TypeError, ValueError)):
        chol_inv.cholesky_with_inverse(K)


def test_no_launches_on_cpu():
    before = (chol_inv.launches, dict(chol_inv.launches_by_dtype))
    for dt in (torch.float32, torch.float64):
        chol_inv.cholesky_with_inverse(torch.as_tensor(_spd_batch(2, 6, 0), dtype=dt))
    assert (chol_inv.launches, chol_inv.launches_by_dtype) == before
