"""The port's kernels K1 (Cholesky with inverse), K2 (Cholesky with
inverse and apply) and K3 (signed Cholesky with inverse): their plain
versions against the JAX Pallas kernels (interpret mode on the CPU), the
non-finite contract on indefinite or wrong-sign input, the inverse solves,
and the wrappers' argument checks.  The CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import piqp_tpu
from piqp_tpu import batch as jbatch
from piqp_tpu.ops.pallas_chol import (
    _chol_inv_apply_fallback,
    _pallas_chol_inv_apply_batched,
    _pallas_chol_inv_batched,
    _pallas_signed_chol_inv_batched,
    _signed_inv_xla,
)
from piqp_tpu.utils.random import dense_strongly_convex_qp

import piqp_tpu_torch
from piqp_tpu_torch.ops import chol_inv, ldlt, signed_chol_inv


def _spd_batch(B, n, seed):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(-1, 1, (B, n, n))
    return Q @ np.swapaxes(Q, 1, 2) + n * np.eye(n)


@pytest.mark.parametrize("n", [8, 32, 100, 128])
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
    counts = (chol_inv.launches_by_dtype, chol_inv.launches_by_route,
              chol_inv.launches_by_cluster)
    before = tuple(dict(c) for c in counts)
    for dt in (torch.float32, torch.float64):
        for n in (6, 200):  # a resident and, in float64, a cluster shape
            chol_inv.cholesky_with_inverse(torch.as_tensor(_spd_batch(2, n, 0), dtype=dt))
    assert counts == before


@pytest.mark.parametrize(
    "n,dtype,route",
    [
        (8, torch.float32, "resident"),
        (128, torch.float32, "resident"),
        (128, torch.float64, "resident"),
        (169, torch.float64, "resident"),
        (170, torch.float64, "cluster"),
        (240, torch.float32, "resident"),
        (241, torch.float32, "cluster"),
        (256, torch.float32, "cluster"),
        (256, torch.float64, "cluster"),
        (257, torch.float32, "library"),
        (257, torch.float64, "library"),
    ],
)
def test_kernel_route(n, dtype, route):
    assert chol_inv.kernel_route(n, dtype) == route


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resident_limit_fills_the_block(dtype):
    """The resident limit is the largest n whose work square and diagonal
    fit in one block's shared memory; the next n does not fit."""
    name = str(dtype).removeprefix("torch.")
    n = chol_inv.RESIDENT_MAX_N[name]
    assert n == {"float32": 240, "float64": 169}[name]
    assert chol_inv.resident_smem_bytes(n, dtype.itemsize) <= chol_inv.SMEM_PER_BLOCK
    assert chol_inv.resident_smem_bytes(n + 1, dtype.itemsize) > chol_inv.SMEM_PER_BLOCK
    # the main path's n = 128: three float32 blocks or one float64 block
    # share an SM's 228 KB, each block with 1 KB of it reserved by the system
    per_sm = 233_472 // (chol_inv.resident_smem_bytes(128, dtype.itemsize) + 1024)
    assert per_sm == {"float32": 3, "float64": 1}[name]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resident_layout_matches_the_kernel_source(dtype):
    """The route's shared-memory formula and per-block limit are the ones
    the resident kernel's launcher checks n against, so every n routed to
    it launches."""
    src = (Path(chol_inv.__file__).parents[1] / "csrc" / "chol_inv_resident.cu").read_text()
    limit = int(re.search(r"constexpr int kSmemPerBlock = (\d+);", src).group(1))
    expr = re.search(
        r"constexpr int resident_smem_bytes\(int n, int elem\) \{ return ([^;]+); \}", src
    ).group(1)
    assert limit == chol_inv.SMEM_PER_BLOCK
    for n in range(1, chol_inv.MAX_KERNEL_N + 2):
        assert eval(expr, {}, {"n": n, "elem": dtype.itemsize}) == \
            chol_inv.resident_smem_bytes(n, dtype.itemsize)


@pytest.mark.parametrize(
    "n,dtype,cluster",
    [
        (241, torch.float32, 2),
        (256, torch.float32, 2),
        (170, torch.float64, 2),
        (225, torch.float64, 2),
        (226, torch.float64, 3),
        (256, torch.float64, 3),
    ],
)
def test_cluster_size(n, dtype, cluster):
    """Blocks per matrix on K1's cluster route, on both sides of each
    limit: 2 from the resident limit, 3 in float64 from n = 226 (K3, which
    also holds the signs, from n = 225)."""
    assert chol_inv.kernel_route(n, dtype) == "cluster"
    assert chol_inv.cluster_size(n, dtype) == cluster


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cluster_layout_matches_the_kernel_source(dtype):
    """K1's cluster layout is the cluster kernel's unsigned one: the
    shared-memory formula, per-block limit, panel rows and largest cluster
    its launcher checks a launch against, with the signs' n elements left
    out; the cluster size the route picks is the smallest whose blocks fit,
    and every n of the route needs a cluster (2 or 3 blocks)."""
    src = (Path(chol_inv.__file__).parents[1] / "csrc"
           / "signed_chol_inv_resident.cu").read_text()
    limit = int(re.search(r"constexpr int kSmemPerBlock = (\d+);", src).group(1))
    max_cluster = int(re.search(r"constexpr int kMaxCluster = (\d+);", src).group(1))
    panel = int(re.search(r"constexpr int kNb = (\d+);", src).group(1))
    expr = re.search(
        r"constexpr int resident_smem_bytes\(int n, int elem, int c, bool sgn\) \{\s*"
        r"return ([^;]+);\s*\}", src
    ).group(1).replace("/", "//")  # C's integer division
    assert (limit, max_cluster, panel) == (
        chol_inv.SMEM_PER_BLOCK, chol_inv.MAX_CLUSTER, chol_inv.PANEL_ROWS)
    size = dtype.itemsize
    for n in range(1, chol_inv.MAX_KERNEL_N + 1):
        for c in range(1, max_cluster + 1):
            assert eval(expr, {}, {"n": n, "elem": size, "c": c, "sgn": False}) == \
                chol_inv.cluster_resident_smem_bytes(n, size, c)
        c = chol_inv.cluster_size(n, dtype)
        assert chol_inv.cluster_resident_smem_bytes(n, size, c) <= limit
        assert c == 1 or chol_inv.cluster_resident_smem_bytes(n, size, c - 1) > limit
        if chol_inv.kernel_route(n, dtype) == "cluster":
            assert c in chol_inv.launches_by_cluster


@pytest.mark.parametrize("n,dtype", [(176, "float64"), (248, "float32")])
def test_reference_matches_jax_kernel_above_the_resident_limit(n, dtype):
    """K1's plain version on the CPU, the one the cluster kernel is held to
    on the card, against the JAX kernel in interpret mode at an n of the
    cluster route (about a second each on the CPU)."""
    K = _spd_batch(2, n, seed=n)
    assert chol_inv.kernel_route(n, getattr(torch, dtype)) == "cluster"
    Lj, Lij = (np.asarray(a) for a in _pallas_chol_inv_batched(jnp.asarray(K, dtype)))
    Lt, Lit = (a.numpy() for a in chol_inv.cholesky_with_inverse(
        torch.as_tensor(K, dtype=getattr(torch, dtype))))
    tol = 5e-5 if dtype == "float32" else 1e-11
    np.testing.assert_allclose(Lt, Lj, atol=tol, rtol=tol)
    np.testing.assert_allclose(Lit, Lij, atol=50 * tol, rtol=50 * tol)
    np.testing.assert_allclose(Lt @ Lit, np.broadcast_to(np.eye(n), K.shape), atol=50 * tol,
                               rtol=0)


@pytest.mark.parametrize("n", [12, 64])
def test_signed_reference_with_plus_signs_is_the_unsigned_one(n):
    """K3's recurrence with every sign +1 is K1's: the identity that lets
    one cluster kernel serve both (its unsigned instance is K1's cluster
    route)."""
    K = torch.as_tensor(_spd_batch(2, n, seed=5))
    want = chol_inv.chol_inv_reference(K)
    got = signed_chol_inv.signed_chol_inv_reference(K, torch.ones(n, dtype=K.dtype))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-12, rtol=1e-12)


def test_float64_solve_above_the_resident_limit_matches_jax():
    """Two float64 dense QPs at n = 172 (p = m = 86), an n of K1's cluster
    route: the port on the CPU, which runs K1's plain version (the one the
    cluster kernel is held to on the card), against the JAX package with
    its kernel (interpret mode), equal status and iterations, x within 1e-9
    (about 11 s on one CPU worker, mostly JAX's compile)."""
    probs = [dense_strongly_convex_qp(172, 86, 86, seed=1000 + i) for i in range(2)]
    assert chol_inv.kernel_route(172, torch.float64) == "cluster"
    jres = jax.tree.map(np.asarray, jbatch.solve_batch(
        jbatch.prepare_batch(probs), piqp_tpu.Settings(pallas_kernels=True)))
    tres = piqp_tpu_torch.solve_batch(piqp_tpu_torch.prepare_batch(probs, device="cpu"),
                                      piqp_tpu_torch.Settings())
    assert tres.info.status.tolist() == jres.info.status.tolist() == [1, 1]
    assert tres.info.iter.tolist() == jres.info.iter.tolist()
    np.testing.assert_allclose(tres.x.numpy(), jres.x, atol=1e-9, rtol=0)


# ---------------------------------------------------------------------------
# K2: factor + inverse + apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,r", [(4, 12), (8, 20), (23, 50), (32, 68), (33, 70), (48, 100),
                                 (64, 132)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_apply_reference_matches_jax_kernel(n, r, dtype):
    K = _spd_batch(5, n, seed=n + r)
    RHS = np.random.default_rng(r).standard_normal((5, n, r))
    want = [np.asarray(a) for a in _pallas_chol_inv_apply_batched(
        jnp.asarray(K, dtype), jnp.asarray(RHS, dtype))]
    tdt = getattr(torch, dtype)
    got = [a.numpy() for a in chol_inv.cholesky_inverse_apply(
        torch.as_tensor(K, dtype=tdt), torch.as_tensor(RHS, dtype=tdt))]
    tol = 5e-5 if dtype == "float32" else 1e-10
    for g, w, what in zip(got, want, ("L", "Linv", "Y")):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=what)
    # Y really is K^-1 RHS
    np.testing.assert_allclose(K @ got[2], RHS, atol=1e-3 if dtype == "float32" else 1e-9)


def test_apply_indefinite_block_gives_nonfinite_for_that_block_only():
    K = _spd_batch(3, 10, seed=2)
    K[0, 3, 3] = -40.0
    L, Linv, Y = chol_inv.cholesky_inverse_apply(
        torch.as_tensor(K), torch.ones((3, 10, 24), dtype=torch.float64))
    fin = [bool(torch.isfinite(a[i]).all()) for i in range(3) for a in (L, Linv, Y)]
    assert fin == [False] * 3 + [True] * 6


@pytest.mark.parametrize(
    "K,RHS",
    [
        (torch.eye(4, dtype=torch.float64)[None], torch.ones((1, 4, 3), dtype=torch.float32)),
        (torch.eye(4, dtype=torch.float64)[None], torch.ones((2, 4, 3), dtype=torch.float64)),
        (torch.eye(4, dtype=torch.float64)[None], torch.ones((1, 5, 3), dtype=torch.float64)),
    ],
    ids=["dtype-mismatch", "batch-mismatch", "rows-mismatch"],
)
def test_apply_wrapper_rejects_bad_input(K, RHS):
    with pytest.raises((TypeError, ValueError)):
        chol_inv.cholesky_inverse_apply(K, RHS)


@pytest.mark.parametrize(
    "n,r,dtype,route",
    [
        (1, 6, torch.float32, "small"),
        (1, 6, torch.float64, "small"),
        (32, 68, torch.float32, "small"),
        (32, 68, torch.float64, "small"),
        (33, 70, torch.float32, "resident"),
        (33, 70, torch.float64, "resident"),
        (48, 100, torch.float32, "resident"),
        (48, 100, torch.float64, "resident"),
        (64, 132, torch.float32, "resident"),
        (64, 132, torch.float64, "resident"),
        # the resident square's limit at r = 2n + 4, each side
        (138, 280, torch.float32, "resident"),
        (139, 282, torch.float32, "split"),
        (97, 198, torch.float64, "resident"),
        (98, 200, torch.float64, "split"),
        (256, 516, torch.float32, "split"),
        (256, 516, torch.float64, "split"),
        (257, 518, torch.float32, "library"),
        (257, 518, torch.float64, "library"),
        # one warp's right-hand blocks too wide for shared memory
        (32, 1800, torch.float32, "split"),
        (32, 900, torch.float64, "split"),
        # the D = 144 fleet's levels, and the limit at r = 4n + 4 (the
        # chunked and sharded interiors' width), each side
        (144, 292, torch.float32, "split"),
        (144, 292, torch.float64, "split"),
        (75, 304, torch.float32, "resident"),
        (75, 304, torch.float64, "resident"),
        (76, 308, torch.float32, "resident"),
        (76, 308, torch.float64, "split"),
        (107, 432, torch.float32, "resident"),
        (107, 432, torch.float64, "split"),
        (108, 436, torch.float32, "split"),
        (108, 436, torch.float64, "split"),
    ],
)
def test_apply_kernel_route(n, r, dtype, route):
    assert chol_inv.apply_kernel_route(n, dtype, r) == route


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resident_apply_layout_matches_the_kernel_source(dtype):
    """The resident K2 kernel's shared-memory formula, block size, largest n
    and per-block limit are the ones the route's Python mirror uses, so a
    shape routed to it launches, and one the kernel refuses is not routed
    to it."""
    src = (Path(chol_inv.__file__).parents[1] / "csrc" / "chol_inv_apply_resident.cu").read_text()
    max_n = int(re.search(r"constexpr int kMaxN = (\d+);", src).group(1))
    small_n = int(re.search(r"constexpr int kSmallBlockN = (\d+);", src).group(1))
    limit = int(re.search(r"constexpr int kSmemPerBlock = (\d+);", src).group(1))
    smem = re.search(
        r"constexpr int apply_smem_bytes\(int n, int r, int elem\) \{\s*return ([^;]+);\s*\}",
        src).group(1)
    threads = re.search(
        r"constexpr int apply_threads\(int n\) \{\s*return n <= kSmallBlockN \? (\d+) : (\d+);",
        src).groups()
    assert (max_n, small_n, limit) == (
        chol_inv.MAX_KERNEL_N, chol_inv.RESIDENT_APPLY_SMALL_N, chol_inv.SMEM_PER_BLOCK)
    size = dtype.itemsize
    for n in range(1, max_n + 1):
        assert chol_inv.resident_apply_threads(n) == int(threads[0] if n <= small_n else threads[1])
        for r in (0, 1, 3, 2 * n + 4, 100, 1780, 1800):
            got = eval(smem, {}, {"n": n, "r": r, "elem": size})
            assert got == chol_inv.resident_apply_smem_bytes(n, r, size)
            route = chol_inv.apply_kernel_route(n, dtype, r)
            # the launcher refuses a square above the limit
            assert (route == "resident") == (got <= limit and route != "small")


@pytest.mark.parametrize(
    "n,dtype,factor,cluster",
    [
        (144, torch.float32, "resident", None),
        (144, torch.float64, "resident", None),
        (170, torch.float32, "resident", None),
        (170, torch.float64, "cluster", 2),
        (226, torch.float32, "resident", None),
        (226, torch.float64, "cluster", 3),
        (241, torch.float32, "cluster", 2),
        (241, torch.float64, "cluster", 3),
        (256, torch.float32, "cluster", 2),
        (256, torch.float64, "cluster", 3),
    ],
)
def test_split_route_factors_on_k1s_route(monkeypatch, n, dtype, factor, cluster):
    """A split call launches K1's kernel on the route and cluster size
    kernel_route and cluster_size name, then the product kernel, and counts
    once in K2's counters (its factor in the split-factor counters), never in
    K1's.  The two launches are replaced by their plain versions, so the
    wrapper's own logic runs on the CPU."""
    assert chol_inv.apply_kernel_route(n, dtype, 2 * n + 4) == "split"
    assert chol_inv.kernel_route(n, dtype) == factor
    assert cluster is None or chol_inv.cluster_size(n, dtype) == cluster
    launched = []
    monkeypatch.setattr(chol_inv, "_launch_factor",
                        lambda K, route: launched.append(route) or chol_inv.chol_inv_reference(K))
    monkeypatch.setattr(chol_inv, "_launch_product",
                        lambda Linv, RHS: launched.append("product")
                        or chol_inv.inv_apply_reference(Linv, RHS))
    counts = (chol_inv.apply_launches_by_dtype, chol_inv.apply_launches_by_route,
              chol_inv.apply_factor_launches_by_route, chol_inv.apply_factor_launches_by_cluster,
              chol_inv.launches_by_dtype, chol_inv.launches_by_route,
              chol_inv.launches_by_cluster)
    before = [dict(c) for c in counts]
    try:
        K = torch.as_tensor(_spd_batch(1, n, seed=n), dtype=dtype)
        RHS = torch.as_tensor(np.random.default_rng(n).uniform(-1, 1, (1, n, 4)), dtype=dtype)
        got = chol_inv._launch_apply(K, RHS, "split")
        grown = [{k: c[k] - b[k] for k in b} for c, b in zip(counts, before)]
    finally:
        for c, b in zip(counts, before):
            c.update(b)
    assert launched == [factor, "product"]
    name = str(dtype).removeprefix("torch.")
    assert grown[0] == {k: int(k == name) for k in grown[0]}
    assert grown[1] == {k: int(k == "split") for k in grown[1]}
    assert grown[2] == {k: int(k == factor) for k in grown[2]}
    assert grown[3] == {k: int(k == cluster) for k in grown[3]}
    assert all(not any(g.values()) for g in grown[4:])  # K1's counters stay K1's
    for g, w in zip(got, chol_inv.chol_inv_apply_reference(K, RHS)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_split_plain_versions_match_jax_fallback():
    """The split route's plain versions against the JAX package's XLA
    fallback (``_chol_inv_apply_fallback``, on the CPU in float64) at the
    D = 144 fleet's n = 144, R = 292: K2's plain version on K, and the
    product's plain version on the fallback's own Linv.  Both sum in
    another order than XLA, so they are held to 1e-12 relative to each
    output's largest entry."""
    N, n, R = 2, 144, 292
    K = _spd_batch(N, n, seed=12)
    RHS = np.random.default_rng(12).standard_normal((N, n, R))
    want = [np.array(a) for a in jax.vmap(_chol_inv_apply_fallback)(
        jnp.asarray(K), jnp.asarray(RHS))]
    got = [a.numpy() for a in chol_inv.chol_inv_apply_reference(
        torch.as_tensor(K), torch.as_tensor(RHS))]
    for g, w, what in zip(got, want, ("L", "Linv", "Y")):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12 * np.abs(w).max(), err_msg=what)
    Y = chol_inv.inv_apply_reference(torch.as_tensor(want[1]), torch.as_tensor(RHS)).numpy()
    np.testing.assert_allclose(Y, want[2], rtol=1e-12, atol=1e-12 * np.abs(want[2]).max())


def test_product_reads_the_lower_triangle_only():
    """What lies above Linv's diagonal does not reach the product's plain
    version, as the kernel zero-fills it."""
    K = torch.as_tensor(_spd_batch(2, 20, seed=3))
    _, Linv = chol_inv.chol_inv_reference(K)
    RHS = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 20, 7)))
    poisoned = Linv + torch.triu(torch.full_like(Linv, float("nan")), 1)
    torch.testing.assert_close(chol_inv.inv_apply_reference(poisoned, RHS),
                               chol_inv.inv_apply_reference(Linv, RHS), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_product_layout_matches_the_kernel_source(dtype):
    """The product kernel's tile width, panel depth, tile rows and shared-
    memory formula are the ones its Python mirror states, with its largest
    n and per-block limit; every n up to 256 fits a block."""
    src = (Path(chol_inv.__file__).parents[1] / "csrc" / "chol_inv_apply_product.cu").read_text()
    max_n = int(re.search(r"constexpr int kMaxN = (\d+);", src).group(1))
    limit = int(re.search(r"constexpr int kSmemPerBlock = (\d+);", src).group(1))

    def body(fn):
        return re.search(rf"__host__ __device__ constexpr int {fn}\([^)]*\) \{{\s*"
                         rf"return ([^;]+);\s*\}}", src).group(1).replace("/", "//")

    assert (max_n, limit) == (chol_inv.MAX_KERNEL_N, chol_inv.SMEM_PER_BLOCK)
    size = dtype.itemsize
    names = {"tile_cols": chol_inv.product_tile_cols,
             "panel_depth": chol_inv.product_panel_depth,
             "tile_rows": chol_inv.product_tile_rows,
             "group_rows": lambda elem: eval(body("group_rows"), {}, {"elem": elem})}
    assert eval(body("tile_cols"), {}, {"elem": size}) == chol_inv.product_tile_cols(size)
    assert eval(body("panel_depth"), {}, {"elem": size}) == chol_inv.product_panel_depth(size)
    for n in range(1, max_n + 1):
        assert eval(body("tile_rows"), names, {"n": n, "elem": size}) == \
            chol_inv.product_tile_rows(n, size)
        smem = eval(body("product_smem_bytes"), names, {"n": n, "elem": size})
        assert smem == chol_inv.product_smem_bytes(n, size) <= limit


@pytest.mark.parametrize(
    "n,dtype,tile,smem,per_sm",
    [
        (144, torch.float32, 64, 69_120, 3),
        (144, torch.float64, 32, 69_120, 3),
        (256, torch.float32, 64, 110_592, 2),
        (256, torch.float64, 32, 122_880, 1),
    ],
)
def test_product_placement_at_the_stated_shapes(n, dtype, tile, smem, per_sm):
    """The placements the product kernel's note states: right-hand columns
    a block, shared memory a block and blocks an SM by shared memory
    (228 KB, 1 KB reserved per block)."""
    got = chol_inv.product_smem_bytes(n, dtype.itemsize)
    assert (chol_inv.product_tile_cols(dtype.itemsize), got, 233_472 // (got + 1024)) == (
        tile, smem, per_sm)


@pytest.mark.parametrize(
    "n,r,dtype,threads,smem,per_sm",
    [
        (48, 100, torch.float32, 128, 28_800, 7),
        (48, 100, torch.float64, 128, 57_600, 3),
        (64, 132, torch.float32, 128, 50_688, 4),
        (64, 132, torch.float64, 128, 101_376, 2),
    ],
)
def test_resident_apply_placement_at_the_timed_shapes(n, r, dtype, threads, smem, per_sm):
    """The placements the kernel's note states: threads, shared memory a
    block and blocks an SM by shared memory (228 KB, 1 KB reserved per
    block)."""
    got = chol_inv.resident_apply_smem_bytes(n, r, dtype.itemsize)
    assert (chol_inv.resident_apply_threads(n), got, 233_472 // (got + 1024)) == (
        threads, smem, per_sm)


@pytest.mark.parametrize("n,lanes", [(1, 4), (4, 4), (5, 8), (8, 8), (9, 16), (16, 16),
                                     (17, 32), (32, 32)])
def test_group_lanes(n, lanes):
    assert chol_inv.group_lanes(n) == lanes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_small_layout_matches_the_kernel_source(dtype):
    """The small K2 kernel's block size, largest n, per-block limit and
    shared-memory formula are the ones the route's Python mirror uses, so
    every shape routed to it launches with the placement the mirror names."""
    src = (Path(chol_inv.__file__).parents[1] / "csrc" / "chol_inv_apply_small.cu").read_text()
    threads = int(re.search(r"constexpr int kSmallThreads = (\d+);", src).group(1))
    max_n = int(re.search(r"constexpr int kMaxSmallN = (\d+);", src).group(1))
    limit = int(re.search(r"constexpr int kSmemPerBlock = (\d+);", src).group(1))
    expr = re.search(
        r"constexpr int small_smem_bytes\(int n, int r, int elem, int m\) \{\s*return ([^;]+);\s*\}",
        src).group(1).replace("/", "//").replace("\n", " ")  # C's integer division
    assert (threads, max_n, limit) == (
        chol_inv.SMALL_THREADS, chol_inv.SMALL_MAX_N, chol_inv.SMEM_PER_BLOCK)
    names = {"group_lanes": chol_inv.group_lanes, "step_cols": chol_inv.step_cols}
    size = dtype.itemsize
    for n in range(1, max_n + 1):
        for r in (0, 1, 3, 4, 2 * n + 4, 50, 68, 700, 2000):
            assert eval(expr, names, {"n": n, "r": r, "elem": size, "m": 3}) == \
                chol_inv.small_smem_bytes(n, r, size, 3)
            # the launcher's loop: halve from kSmallThreads while the block
            # does not fit, 0 when one warp's does not
            t = threads
            while t > 32 and chol_inv.small_smem_bytes(
                    n, r, size, t // chol_inv.group_lanes(n)) > limit:
                t //= 2
            fits = chol_inv.small_smem_bytes(n, r, size, t // chol_inv.group_lanes(n)) <= limit
            assert chol_inv.small_threads(n, r, size) == (t if fits else 0)


@pytest.mark.parametrize(
    "n,r,dtype,threads,smem,per_sm",
    [
        (8, 20, torch.float32, 64, 9_216, 22),
        (8, 20, torch.float64, 64, 16_384, 13),
        (23, 50, torch.float32, 64, 14_464, 15),
        (23, 50, torch.float64, 64, 28_912, 7),
    ],
)
def test_small_placement_at_the_timed_shapes(n, r, dtype, threads, smem, per_sm):
    """The placements the kernel's note states: threads, shared memory a
    block and blocks an SM (228 KB, 1 KB of it reserved per block)."""
    t = chol_inv.small_threads(n, r, dtype.itemsize)
    got = chol_inv.small_smem_bytes(n, r, dtype.itemsize, t // chol_inv.group_lanes(n))
    assert (t, got, 233_472 // (got + 1024)) == (threads, smem, per_sm)


# ---------------------------------------------------------------------------
# K3: signed Cholesky with inverse
# ---------------------------------------------------------------------------

def _quasidef_batch(B, n, npos, seed):
    """B quasi-definite matrices [[H, C'], [C, -M]] under one random
    symmetric permutation (still factorizable without pivoting), with the
    permuted sign vector."""
    rng = np.random.default_rng(seed)
    q = n - npos
    Q1 = rng.standard_normal((B, npos, npos))
    Q2 = rng.standard_normal((B, q, q))
    K = np.zeros((B, n, n))
    K[:, :npos, :npos] = Q1 @ np.swapaxes(Q1, 1, 2) + npos * np.eye(npos)
    K[:, npos:, npos:] = -(Q2 @ np.swapaxes(Q2, 1, 2) + q * np.eye(q))
    C = rng.standard_normal((B, q, npos))
    K[:, npos:, :npos] = C
    K[:, :npos, npos:] = np.swapaxes(C, 1, 2)
    s = np.concatenate([np.ones(npos), -np.ones(q)])
    perm = rng.permutation(n)
    return np.ascontiguousarray(K[:, perm][:, :, perm]), s[perm]


@pytest.mark.parametrize("n,npos", [(24, 10), (64, 40), (128, 64)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_signed_reference_matches_jax_kernel(n, npos, dtype):
    K, s = _quasidef_batch(4, n, npos, seed=n)
    Lj, Lij = (np.asarray(a) for a in _pallas_signed_chol_inv_batched(
        jnp.asarray(K, dtype), jnp.asarray(s, dtype)))
    tdt = getattr(torch, dtype)
    Lt, Lit = (a.numpy() for a in signed_chol_inv.signed_cholesky_with_inverse(
        torch.as_tensor(K, dtype=tdt), torch.as_tensor(s, dtype=tdt)))
    tol = 5e-5 if dtype == "float32" else 1e-10
    np.testing.assert_allclose(Lt, Lj, atol=tol, rtol=tol)
    np.testing.assert_allclose(Lit, Lij, atol=50 * tol, rtol=50 * tol)
    np.testing.assert_allclose((Lt * s) @ np.swapaxes(Lt, 1, 2), K,
                               atol=50 * tol * np.abs(K).max())


def test_signed_wrong_sign_pivot_gives_nonfinite_for_that_problem_only():
    K, s = _quasidef_batch(3, 16, 8, seed=4)
    j = int(np.nonzero(s > 0)[0][0])
    K[1, j, j] = -50.0  # problem 1's pivot j disagrees with its sign
    for L, Linv in (
        (np.asarray(a) for a in _pallas_signed_chol_inv_batched(jnp.asarray(K), jnp.asarray(s))),
        (a.numpy() for a in signed_chol_inv.signed_cholesky_with_inverse(
            torch.as_tensor(K), torch.as_tensor(s))),
    ):
        fin = np.isfinite(L).all(axis=(1, 2)) & np.isfinite(Linv).all(axis=(1, 2))
        assert fin.tolist() == [True, False, True]


def test_signed_inv_solve_roundtrip():
    K, s = _quasidef_batch(3, 32, 20, seed=9)
    _, Linv = signed_chol_inv.signed_cholesky_with_inverse(torch.as_tensor(K), torch.as_tensor(s))
    v = np.random.default_rng(1).standard_normal((3, 32))
    x = signed_chol_inv.signed_inv_solve(Linv, torch.as_tensor(s), torch.as_tensor(v))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(K, v[..., None])[..., 0], atol=1e-9)


def test_blocked_inverse_matches_jax():
    """The route above the kernel's size limit (``_signed_inv_xla``'s
    counterpart), at a small block size."""
    K, s = _quasidef_batch(2, 48, 30, seed=11)
    Lj, Lij = jax.vmap(lambda k: _signed_inv_xla(k, jnp.asarray(s), block=16))(jnp.asarray(K))
    Lt, Lit = ldlt.blocked_inverse(torch.as_tensor(K), torch.as_tensor(s), block=16)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(Lit.numpy(), np.asarray(Lij), atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize(
    "K,s",
    [
        (torch.eye(4, dtype=torch.float16)[None], torch.ones(4, dtype=torch.float16)),
        (torch.eye(4, dtype=torch.float64)[None], torch.ones(5, dtype=torch.float64)),
        (torch.eye(4, dtype=torch.float64), torch.ones(4, dtype=torch.float64)),
    ],
    ids=["float16", "signs-length", "unbatched"],
)
def test_signed_wrapper_rejects_bad_input(K, s):
    with pytest.raises((TypeError, ValueError)):
        signed_chol_inv.signed_cholesky_with_inverse(K, s)


def test_no_k2_k3_launches_on_cpu():
    counts = (chol_inv.apply_launches_by_dtype, chol_inv.apply_launches_by_route,
              chol_inv.apply_factor_launches_by_route, chol_inv.apply_factor_launches_by_cluster,
              signed_chol_inv.launches_by_dtype, signed_chol_inv.launches_by_route,
              signed_chol_inv.launches_by_cluster)
    before = tuple(dict(c) for c in counts)
    for dt in (torch.float32, torch.float64):
        # K2 on its small, resident and split routes; K3 on a one-block
        # and a clustered resident shape
        for n in (6, 48, 240):
            K = torch.as_tensor(_spd_batch(2, n, 0), dtype=dt)
            chol_inv.cholesky_inverse_apply(K, torch.ones((2, n, 4), dtype=dt))
            signed_chol_inv.signed_cholesky_with_inverse(K, torch.ones(n, dtype=dt))
    assert counts == before


@pytest.mark.parametrize(
    "n,dtype,route,cluster",
    [
        (8, torch.float32, "resident", 1),
        (239, torch.float32, "resident", 1),
        (240, torch.float32, "resident", 2),
        (256, torch.float32, "resident", 2),
        (64, torch.float64, "resident", 1),
        (168, torch.float64, "resident", 1),
        (169, torch.float64, "resident", 2),
        (224, torch.float64, "resident", 2),
        (225, torch.float64, "resident", 3),
        (256, torch.float64, "resident", 3),
        (257, torch.float32, "blocked", None),
        (257, torch.float64, "blocked", None),
    ],
)
def test_signed_kernel_route(n, dtype, route, cluster):
    assert signed_chol_inv.kernel_route(n, dtype) == route
    if cluster is not None:
        assert signed_chol_inv.cluster_size(n, dtype) == cluster


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_signed_resident_layout_matches_the_kernel_source(dtype):
    """The route's shared-memory formula, per-block limit and largest
    cluster are the ones the resident K3 launcher checks a launch against,
    and the cluster size the route picks is the smallest whose blocks fit."""
    src = (Path(signed_chol_inv.__file__).parents[1] / "csrc"
           / "signed_chol_inv_resident.cu").read_text()
    limit = int(re.search(r"constexpr int kSmemPerBlock = (\d+);", src).group(1))
    max_cluster = int(re.search(r"constexpr int kMaxCluster = (\d+);", src).group(1))
    panel = int(re.search(r"constexpr int kNb = (\d+);", src).group(1))
    expr = re.search(
        r"constexpr int resident_smem_bytes\(int n, int elem, int c, bool sgn\) \{\s*"
        r"return ([^;]+);\s*\}", src
    ).group(1).replace("/", "//")  # C's integer division
    assert (limit, max_cluster, panel) == (
        signed_chol_inv.SMEM_PER_BLOCK, signed_chol_inv.MAX_CLUSTER, signed_chol_inv.PANEL_ROWS)
    size = dtype.itemsize
    for n in range(1, signed_chol_inv.MAX_KERNEL_N + 1):
        for c in range(1, max_cluster + 1):
            assert eval(expr, {}, {"n": n, "elem": size, "c": c, "sgn": True}) == \
                signed_chol_inv.resident_smem_bytes(n, size, c)
        c = signed_chol_inv.cluster_size(n, dtype)
        assert signed_chol_inv.resident_smem_bytes(n, size, c) <= limit
        assert c == 1 or signed_chol_inv.resident_smem_bytes(n, size, c - 1) > limit
