"""The dense entry (``batch.prepare_batch``, ``api.prepare_data``) against
the JAX package's ``prepare_batch`` / ``prepare_data``: every field of the
canonical batch bitwise equal, masks included, over the edge cases of the
canonicalisation, and the same ``ValueError`` for each malformed input.

The test marked ``card`` holds the CUDA entry (pinned staging, copies that
do not block, the canonicalisation on the card) against the CPU one and
skips without a CUDA device.  JAX is imported inside the parity tests only,
so that one runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_entry.py -m card
"""

import numpy as np
import pytest
import torch

from piqp_tpu_torch import batch, prepare_batch, prepare_data
from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

FIELDS = ("P", "c", "A", "b", "G", "h_l", "h_u", "x_l", "x_u", "x_b_scaling",
          "hl_mask", "hu_mask", "xl_mask", "xu_mask")
DIMS = (6, 2, 5)


def _base(count, seed=0):
    return [dense_strongly_convex_qp(*DIMS, seed=seed + i) for i in range(count)]


def _edit(probs, fn):
    out = []
    for i, prob in enumerate(probs):
        prob = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in prob.items()}
        fn(i, prob)
        out.append({k: v for k, v in prob.items() if v is not None})
    return out


def _huge(i, prob):
    """Bounds at, around and beyond PIQP_INF, in both signs; 9.9999999e29
    is active in float64 and rounds to PIQP_INF in float32."""
    big = [1e30, 1e31, 9.9999999e29, 9.99999e29, 1.0000001e30, np.inf, 1e29]
    prob["h_l"][:2] = -big[i % 7], -big[(i + 1) % 7]
    prob["h_u"][2:4] = big[(i + 2) % 7], big[(i + 3) % 7]
    prob["x_l"][0], prob["x_u"][1] = -big[(i + 4) % 7], big[(i + 5) % 7]
    prob["x_u"][2] = big[(i + 6) % 7]


def _dead(i, prob):
    """Rows of G with both bounds infinite or beyond PIQP_INF."""
    prob["h_l"][0], prob["h_u"][0] = -np.inf, np.inf
    prob["h_l"][i % 5], prob["h_u"][i % 5] = -1e30, 2e30


def _zeros(i, prob):
    """Finite bounds at 0 and at -0.0."""
    prob["h_l"][:2], prob["h_u"][:2] = -0.0, 0.0
    prob["h_u"][2] = -0.0
    prob["x_l"][:3], prob["x_u"][:3] = 0.0, -0.0


def _signed_p(i, prob):
    """P with -0.0 entries and a lower triangle unlike its upper one."""
    P = prob["P"]
    P[np.tril_indices(DIMS[0], -1)] = np.arange(15) - 7.5 - i
    P[0, 1], P[1, 1], P[2, 0] = -0.0, -0.0, -0.0


def _no_a(i, prob):
    prob["A"] = prob["b"] = None


def _no_g(i, prob):
    prob["G"] = prob["h_l"] = prob["h_u"] = None


def _no_bounds(i, prob):
    prob["G"] = prob["h_l"] = prob["h_u"] = prob["x_l"] = prob["x_u"] = None


def _h_l_only(i, prob):
    prob["h_u"] = None


def _some_omit(i, prob):
    """x_l and h_u given by some problems of the batch only."""
    if i % 2:
        prob["x_l"] = None
    if i % 3 == 1:
        prob["h_u"] = None


def _lists(i, prob):
    for k, v in prob.items():
        prob[k] = v.tolist()


def _float32(i, prob):
    for k, v in prob.items():
        prob[k] = v.astype(np.float32)


CASES = {
    "inf_bounds": lambda i, prob: None,
    "huge_bounds": _huge,
    "dead_rows": _dead,
    "zero_bounds": _zeros,
    "signed_zero_p": _signed_p,
    "no_A": _no_a,
    "no_G": _no_g,
    "no_bounds": _no_bounds,
    "h_l_only": _h_l_only,
    "some_omit": _some_omit,
    "lists": _lists,
    "float32_inputs": _float32,
}


def _same(got: torch.Tensor, want: np.ndarray, what: str):
    want = torch.from_numpy(np.array(want))
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got, want), what
    if got.is_floating_point():
        assert torch.equal(torch.signbit(got), torch.signbit(want)), f"{what}: signs of zero"


@pytest.mark.parametrize("B", [1, 7])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_entry_is_the_jax_entry_bitwise(case, dtype, B):
    import jax.numpy as jnp
    from piqp_tpu import batch as jbatch
    from piqp_tpu import prepare_data as jprepare_data

    probs = _edit(_base(B, seed=10 * B), CASES[case])
    before = dict(batch.entry_batches_by_staging)
    got = prepare_batch(probs, dtype=getattr(torch, dtype), device="cpu")
    want = jbatch.prepare_batch(probs, dtype=getattr(jnp, dtype))
    for f in FIELDS:
        _same(getattr(got, f), getattr(want, f), f)
    if B == 1:
        one = prepare_data(**probs[0], dtype=getattr(torch, dtype), device="cpu")
        jone = jprepare_data(**probs[0], dtype=getattr(jnp, dtype))
        for f in FIELDS:
            _same(getattr(one, f)[0], getattr(jone, f), f)
    calls = 2 if B == 1 else 1
    assert batch.entry_batches_by_staging == dict(before, pageable=before["pageable"] + calls)


def _square(probs):
    probs[1]["P"] = probs[1]["P"][:, :-1]


def _shape(probs):
    probs[1]["c"] = probs[1]["c"][:-1]


def _g_unbounded(probs):
    del probs[1]["h_l"], probs[1]["h_u"]


def _other_dims(probs):
    probs[1] = dense_strongly_convex_qp(DIMS[0], DIMS[1], DIMS[2] + 1, seed=99)


ERRORS = {
    "not_square": (_square, "P must be square"),
    "wrong_shape": (_shape, r"expected shape \(6,\), got \(5,\)"),
    "G_without_bounds": (_g_unbounded, "h_l or h_u should be provided when G is given"),
    "other_dims": (_other_dims, "differs in shape"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_entry_raises_as_before(case):
    from piqp_tpu import batch as jbatch

    edit, message = ERRORS[case]
    probs = _base(3)
    edit(probs)
    before = dict(batch.entry_batches_by_staging)
    with pytest.raises(ValueError, match=message):
        prepare_batch(probs, device="cpu")
    with pytest.raises(ValueError):
        jbatch.prepare_batch(probs)
    assert batch.entry_batches_by_staging == before
    if case != "other_dims":
        with pytest.raises(ValueError, match=message):
            prepare_data(**probs[1], device="cpu")


@pytest.mark.card
def test_card_entry_is_the_cpu_entry():
    """64 of dense128's problems: the CUDA entry bitwise the CPU one, one
    pinned batch a call, and a second call of the shape pins no new host
    memory (the caching host allocator reuses the first call's blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    probs = [dense_strongly_convex_qp(128, 64, 64, seed=i) for i in range(64)]
    cpu = prepare_batch(probs, device="cpu")
    stats = getattr(torch.cuda.memory, "host_memory_stats", None)
    allocs = []
    for _ in range(2):
        before = dict(batch.entry_batches_by_staging)
        got = prepare_batch(probs, device="cuda")
        torch.cuda.synchronize()
        assert batch.entry_batches_by_staging == dict(before, pinned=before["pinned"] + 1)
        for f in FIELDS:
            _same(getattr(got, f).cpu(), getattr(cpu, f).numpy(), f)
        if stats is not None:
            allocs.append(stats().get("num_host_alloc"))
    if stats is not None:
        assert allocs[0] is not None and allocs[1] == allocs[0], allocs
