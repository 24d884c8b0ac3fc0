"""The multistage backend of the PyTorch port against the JAX package:
stage data and its generator, the structured matvecs, stage Ruiz, the
block factorizations of all three schemes (chain, cyclic reduction,
chunked with chain or cyclic-reduction interiors) in both representations,
batched solves end to end, and the sparse-input construction (structure
detection in the port's C++ library against its numpy plain versions).
JAX runs its Pallas kernels in interpret mode and the port its plain
versions.

Tolerances: float64 end to end, status and iteration count equal, x to
1e-8 and y to 1e-6 (scaled by max(1, |x|)); mixed precision, status equal
and x to 1e-4 (ROADMAP Queue 3); stage Ruiz scalings to 1e-12; block
factors and solves to 1e-10."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import piqp_tpu
from piqp_tpu import batch as jbatch
from piqp_tpu import kkt as jkkt
from piqp_tpu import multistage as jms
from piqp_tpu import ops as jops
from piqp_tpu import ruiz as jruiz
from piqp_tpu.types import Vars as JVars

import piqp_tpu_torch
from piqp_tpu_torch import _native, convert, solve_batch, solve_prepared, warm_from_result
from piqp_tpu_torch import kkt as tkkt
from piqp_tpu_torch import multistage as tms
from piqp_tpu_torch import ruiz as truiz
from piqp_tpu_torch.ops import matvec as tops
from piqp_tpu_torch.types import concat

SOLVED = int(piqp_tpu_torch.Status.SOLVED)
BLOCKS = ("Pd", "Psub", "Pa", "Pc", "A1", "A2", "Ag", "G1", "G2", "Gg")

CASES = [
    dict(T=4, D=3, Da=2, ra=2, rg=2, seed=0),
    dict(T=6, D=4, Da=0, ra=2, rg=3, seed=1),
    dict(T=3, D=2, Da=1, ra=0, rg=2, seed=2),
    dict(T=5, D=3, Da=2, ra=2, rg=0, seed=3),
]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _stack(datas):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *datas)


def _assert_data_equal(t, j, atol=0.0):
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name))
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=f.name)


@pytest.fixture
def cr_max():
    """Lower the cyclic-reduction horizon cap in both packages (as the JAX
    tests do) to reach the chunked schemes at a CPU-testable T."""
    old = (jms._CR_MAX_T, tms._CR_MAX_T)

    def set_(value):
        jms._CR_MAX_T = tms._CR_MAX_T = value

    yield set_
    jms._CR_MAX_T, tms._CR_MAX_T = old


@pytest.mark.parametrize("case", CASES)
def test_generator_and_to_dense_match_jax(case):
    t = tms.random_multistage_qp(**case, device="cpu")
    j = jms.random_multistage_qp(**case)
    _assert_data_equal(t, _stack([j]))
    carried = convert.qpdata(_np(j))  # a single JAX problem becomes B = 1
    assert type(carried) is tms.StageQPData
    _assert_data_equal(carried, _stack([j]))
    dt, dj = tms.to_dense(t), jms.to_dense(j)
    for name in ("P", "A", "G"):
        np.testing.assert_array_equal(getattr(dt, name)[0].numpy(), np.asarray(getattr(dj, name)))
    assert (t.n, t.p, t.m, t.T, t.D, t.Da) == (j.n, j.p, j.m, j.T, j.D, j.Da)


@pytest.mark.parametrize("case", CASES)
def test_matvecs_match_jax_and_dense(case):
    cases = [dict(case, seed=case["seed"] + k) for k in range(2)]
    t = concat([tms.random_multistage_qp(**c, device="cpu") for c in cases])
    js = [jms.random_multistage_qp(**c) for c in cases]
    dense = tms.to_dense(t)
    rng = np.random.default_rng(99)
    x, y, z = (rng.standard_normal((2, k)) for k in (t.n, t.p, t.m))
    tx, ty, tz = (torch.as_tensor(v) for v in (x, y, z))
    for name, tv, v in (("P_x", tx, x), ("A_x", tx, x), ("AT_y", ty, y),
                        ("G_x", tx, x), ("GT_z", tz, z)):
        if (name[0] == "A" and t.p == 0) or (name[0] == "G" and t.m == 0):
            continue
        got = getattr(tops, name)(t, tv).numpy()
        want = np.stack([np.asarray(getattr(jops, name)(js[b], jnp.asarray(v[b])))
                         for b in range(2)])
        np.testing.assert_allclose(got, want, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(got, getattr(tops, name)(dense, tv).numpy(), atol=1e-12,
                                   err_msg=name)
    np.testing.assert_array_equal(tops.P_diag(t).numpy(), tops.P_diag(dense).numpy())
    absd = tops.abs_data(t)
    for k in BLOCKS:
        np.testing.assert_array_equal(getattr(absd, k).numpy(), np.abs(getattr(t, k).numpy()))


def _rand_vars(data, seed):
    """Random interior iterates for a B = 1 port data and its JAX twin."""
    rng = np.random.default_rng(seed)

    def pos(mask):
        m = np.asarray(mask)
        return np.where(m, rng.uniform(0.5, 2.0, m.shape), 0.0)

    v = dict(x=rng.standard_normal(data.n), y=rng.standard_normal(data.p),
             z_l=pos(data.hl_mask[0]), z_u=pos(data.hu_mask[0]),
             z_bl=pos(data.xl_mask[0]), z_bu=pos(data.xu_mask[0]),
             s_l=pos(data.hl_mask[0]), s_u=pos(data.hu_mask[0]),
             s_bl=pos(data.xl_mask[0]), s_bu=pos(data.xu_mask[0]))
    return v


SCHEMES = [
    ("chain", dict(T=6, D=3, Da=2, ra=2, rg=2, seed=5), None),
    ("cr", dict(T=17, D=3, Da=2, ra=2, rg=2, seed=6), None),
    ("chunked", dict(T=36, D=3, Da=2, ra=2, rg=2, seed=7), 20),
    ("chunked-cr", dict(T=34, D=3, Da=2, ra=2, rg=2, seed=8), 20),
]


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("scheme,case,cap", SCHEMES, ids=[s[0] for s in SCHEMES])
def test_block_factor_and_solve_match_jax(scheme, case, cap, inverse, cr_max):
    """From the same scalings, the block factor of each scheme and its
    solve agree with the JAX package's to 1e-10, and the solve with the
    assembled condensed matrix."""
    if cap is not None:
        cr_max(cap)
    T = case["T"]
    C = tms._chunk_count(T)
    expect = {"chain": T < 16, "cr": tms._use_cr(T),
              "chunked": not tms._use_cr(T) and C and not tms._use_cr(T // C - 1),
              "chunked-cr": not tms._use_cr(T) and C and tms._use_cr(T // C - 1)}
    assert expect[scheme]

    t = tms.random_multistage_qp(**case, device="cpu")
    j = jms.random_multistage_qp(**case)
    v = _rand_vars(t, case["seed"] + 50)
    js = piqp_tpu.Settings(pallas_kernels=inverse)
    jks = jkkt.compute_scalings(j, js, JVars(**{k: jnp.asarray(a) for k, a in v.items()}),
                                1e-6, 1e-4, jnp.asarray(False), jops.P_diag(j))
    jks, jok = jkkt.factor(j, jks)
    rhs = np.random.default_rng(10).standard_normal(t.n)
    jx = np.asarray(jkkt.condensed_solve_x(j, jks, jnp.asarray(rhs)))

    ts = piqp_tpu_torch.Settings(pallas_kernels=inverse)
    tks = tkkt.compute_scalings(
        t, ts, convert.vars_(types.SimpleNamespace(**v)), torch.full((1,), 1e-6, dtype=torch.float64),
        torch.full((1,), 1e-4, dtype=torch.float64),
        torch.zeros(1, dtype=torch.bool), tops.P_diag(t))
    tks, tok = tkkt.factor(t, tks, inverse=inverse)
    assert bool(jok) and tok.tolist() == [True]
    tx = tkkt.condensed_solve_x(t, tks, torch.as_tensor(rhs)[None])[0].numpy()
    np.testing.assert_allclose(tx, jx, atol=1e-10, rtol=1e-10)

    # the factor has the JAX package's structure and values
    want = convert.kkt_state(_np(jks), condensed=False).factor
    flat_t, flat_w = [], []
    for tree, out in ((tks.factor, flat_t), (want, flat_w)):
        stack = [tree]
        while stack:
            node = stack.pop()
            if isinstance(node, tuple):
                stack.extend(reversed(node))
            else:
                out.append(node)
    assert [a.shape for a in flat_t] == [a.shape for a in flat_w]
    for a, b in zip(flat_t, flat_w):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10, rtol=1e-9)

    # and it solves the assembled condensed system
    Kd, Ksub, Ka, Kc = (k[0].numpy() for k in tms._assemble_blocks(t, tks))
    D, n = t.D, t.n
    K = np.zeros((n, n))
    for s in range(T):
        a = slice(s * D, (s + 1) * D)
        K[a, a] = Kd[s]
        if s + 1 < T:
            b = slice((s + 1) * D, (s + 2) * D)
            K[b, a], K[a, b] = Ksub[s], Ksub[s].T
        K[T * D:, a], K[a, T * D:] = Ka[s], Ka[s].T
    K[T * D:, T * D:] = Kc
    np.testing.assert_allclose(tx, np.linalg.solve(K, rhs), rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("T", [64, 48, 41])
def test_cyclic_reduction_matches_chain(T):
    """cr_factor/cr_solve reproduce the sequential chain on a random SPD
    block-tridiagonal + arrow system of any parity, in both
    representations and with a batch of 2."""
    rng = np.random.default_rng(5)
    D, Da = 5, 3
    Kd = rng.standard_normal((2, T, D, D)) * 0.3
    Kd = 0.5 * (Kd + np.swapaxes(Kd, -1, -2)) + (2 * D + Da + 1) * np.eye(D)
    Ksub = rng.standard_normal((2, T, D, D)) * 0.3
    Ksub[:, -1] = 0.0
    Ka = rng.standard_normal((2, T, Da, D)) * 0.3
    Kc = rng.standard_normal((2, Da, Da)) * 0.3
    Kc = 0.5 * (Kc + np.swapaxes(Kc, -1, -2)) + (2 * D + Da + 1) * np.eye(Da)
    vs, vg = rng.standard_normal((2, T, D)), rng.standard_normal((2, Da))
    Kd, Ksub, Ka, Kc, vs, vg = map(torch.as_tensor, (Kd, Ksub, Ka, Kc, vs, vg))

    Ls, Cs, Fs, acc = tms.chain_factor(Kd, Ksub, Ka)
    Lc = tms._chol(Kc - acc)
    ws, gacc = tms.chain_fwd(Ls, Cs, Fs, vs)
    xg_ref = tms._tsolve(Lc, tms._tsolve(Lc, vg - gacc), transpose=True)
    xs_ref = tms.chain_bwd(Ls, Cs, Fs, ws, xg_ref)
    for inverse in (False, True):
        factors, ok = tms.cr_factor(Kd, Ksub, Ka, Kc, inverse)
        assert ok.tolist() == [True, True]
        assert all(len(lev) == (5 if inverse else 4) for lev in factors[0])
        xs, xg = tms.cr_solve(factors, vs, vg)
        np.testing.assert_allclose(xg.numpy(), xg_ref.numpy(), rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(xs.numpy(), xs_ref.numpy(), rtol=1e-9, atol=1e-10)


def test_scheme_selection_matches_jax():
    for T in range(1, 300):
        assert tms._use_cr(T) == jms._use_cr(T), T
        assert tms._chunk_count(T) == jms._chunk_count(T), T
        assert tms._next_chunkable(T) == jms._next_chunkable(T), T
    assert not tms._use_cr(15) and tms._use_cr(16) and tms._use_cr(256)
    assert not tms._use_cr(257) and tms._chunk_count(300) is not None


@pytest.mark.parametrize("scale_cost", [False, True])
def test_stage_ruiz_matches_jax(scale_cost):
    cases = [dict(T=5, D=3, Da=2, ra=2, rg=2, seed=s) for s in (40, 41)]
    t = concat([tms.random_multistage_qp(**c, device="cpu") for c in cases])
    # problem 1 badly scaled so the two stop after different passes
    t = dataclasses.replace(t, Pd=t.Pd * torch.tensor([1.0, 300.0])[:, None, None, None])
    jd = convert_back(t)
    jscaled, jsc = _np(jax.vmap(lambda d: jruiz.equilibrate(
        d, max_iter=10, scale_cost=scale_cost))(jd))
    tscaled, tsc = truiz.equilibrate(t, max_iter=10, scale_cost=scale_cost)
    _assert_data_equal(tscaled, jscaled, atol=1e-12)
    for name in ("c", "d_x", "d_y", "d_z", "d_b"):
        np.testing.assert_allclose(getattr(tsc, name).numpy(), getattr(jsc, name),
                                   atol=1e-12, rtol=1e-12, err_msg=name)
    # apply_scaling of the same scaling reproduces the scaled data
    again = truiz.apply_scaling(t, tsc)
    _assert_data_equal(again, jscaled, atol=1e-12)


def convert_back(t):
    """A port StageQPData as the JAX package's stacked StageQPData."""
    return jms.StageQPData(**{f.name: jnp.asarray(getattr(t, f.name).numpy())
                              for f in dataclasses.fields(t)})


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} x {scale:.3e}"


def _solve_both(case, seeds, pallas, mixed=False, warm=None):
    cases = [dict(case, seed=s) for s in seeds]
    jdata = _stack([jms.random_multistage_qp(**c) for c in cases])
    tdata = concat([tms.random_multistage_qp(**c, device="cpu") for c in cases])
    js = piqp_tpu.Settings(pallas_kernels=pallas, mixed_precision=mixed)
    ts = piqp_tpu_torch.Settings(pallas_kernels=pallas, mixed_precision=mixed)
    jres = _np(jbatch.solve_batch(jdata, js))
    tres = solve_batch(tdata, ts)
    return jres, tres


E2E = [
    ("chain", dict(T=6, D=3, Da=2, ra=2, rg=2), True, None),
    ("cr", dict(T=17, D=3, Da=2, ra=2, rg=2), True, None),
    ("cr-library", dict(T=17, D=3, Da=2, ra=2, rg=2), False, None),
    ("chunked", dict(T=36, D=3, Da=2, ra=2, rg=2), True, 20),
    ("chunked-cr", dict(T=34, D=3, Da=2, ra=2, rg=2), True, 20),
    # a stage wider than 32: on the card K2 takes its resident route here
    ("cr-wide", dict(T=17, D=33, Da=2, ra=2, rg=2), True, None),
]


@pytest.mark.parametrize("name,case,pallas,cap", E2E, ids=[e[0] for e in E2E])
def test_solve_batch_matches_jax(name, case, pallas, cap, cr_max):
    if cap is not None:
        cr_max(cap)
    jres, tres = _solve_both(case, (1, 2), pallas)
    assert tres.info.status.tolist() == jres.info.status.tolist() == [SOLVED] * 2
    assert tres.info.iter.tolist() == jres.info.iter.tolist()
    for i in range(2):
        _close(tres.x[i].numpy(), jres.x[i], 1e-8, f"x[{i}]")
        _close(tres.y[i].numpy(), jres.y[i], 1e-6, f"y[{i}]")


def test_mixed_precision_cr_matches_jax():
    jres, tres = _solve_both(dict(T=17, D=3, Da=2, ra=2, rg=2), (1, 2), True, mixed=True)
    assert tres.info.status.tolist() == jres.info.status.tolist() == [SOLVED] * 2
    np.testing.assert_allclose(tres.x.numpy(), jres.x, atol=1e-4)


def test_batched_scenarios_and_warm_start_match_jax():
    """A fleet of perturbed scenarios over one stage structure (test_batch's
    multistage case), cold and then warm-started after moving c."""
    base_t = tms.random_multistage_qp(T=16, D=4, Da=2, ra=2, rg=2, seed=0, device="cpu")
    base_j = jms.random_multistage_qp(T=16, D=4, Da=2, ra=2, rg=2, seed=0)
    rng = np.random.default_rng(1)
    cs = [base_j.c + 0.01 * rng.standard_normal(base_j.n) for _ in range(3)]
    jdata = _stack([base_j.replace(c=jnp.asarray(c)) for c in cs])
    tdata = concat([dataclasses.replace(base_t, c=torch.as_tensor(np.asarray(c))[None])
                    for c in cs])
    js, ts = piqp_tpu.Settings(pallas_kernels=True), piqp_tpu_torch.Settings()
    jres = jbatch.solve_batch(jdata, js)
    tres = solve_batch(tdata, ts)
    jn = _np(jres)
    assert tres.info.status.tolist() == jn.info.status.tolist() == [SOLVED] * 3
    assert tres.info.iter.tolist() == jn.info.iter.tolist()
    np.testing.assert_allclose(tres.x.numpy(), jn.x, atol=1e-8)

    moved = rng.standard_normal((3, base_j.n)) * 1e-3
    jw = _np(jbatch.solve_batch(jdata.replace(c=jdata.c + moved), js,
                                warm=jbatch.warm_from_result(jres)))
    tw = solve_batch(dataclasses.replace(tdata, c=tdata.c + torch.as_tensor(moved)), ts,
                     warm=warm_from_result(tres))
    assert tw.info.status.tolist() == jw.info.status.tolist() == [SOLVED] * 3
    assert tw.info.iter.tolist() == jw.info.iter.tolist()
    assert int(tw.info.iter.sum()) < int(tres.info.iter.sum())
    np.testing.assert_allclose(tw.x.numpy(), jw.x, atol=1e-8)


@pytest.mark.parametrize("case", CASES)
def test_stage_solve_matches_dense_backend(case):
    """The cross-backend gate of multistage_kkt_test.cpp: the same QP
    through the stage and the dense backends of the port."""
    t = tms.random_multistage_qp(**case, device="cpu")
    res_s, res_d = solve_prepared(t), solve_prepared(tms.to_dense(t))
    assert res_s.info.status.tolist() == res_d.info.status.tolist() == [SOLVED]
    np.testing.assert_allclose(res_s.x.numpy(), res_d.x.numpy(), atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(res_s.y.numpy(), res_d.y.numpy(), atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("T", [8, 64])
def test_mixed_precision_matches_float64(T):
    t = tms.random_multistage_qp(T=T, D=4, Da=2, ra=2, rg=2, seed=13, device="cpu")
    res = solve_prepared(t, piqp_tpu_torch.Settings(mixed_precision=True))
    res64 = solve_prepared(t)
    assert res.info.status.tolist() == res64.info.status.tolist() == [SOLVED]
    np.testing.assert_allclose(res.x.numpy(), res64.x.numpy(), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# sparse input: structure detection, scatter, updates
# ---------------------------------------------------------------------------

def _user_problem(case):
    """A multistage QP as the user would give it: scipy CSC in dense
    order, with infinite bounds."""
    d = jms.to_dense(jms.random_multistage_qp(**case))
    hl, hu = np.asarray(d.hl_mask), np.asarray(d.hu_mask)
    return dict(
        P=sp.csc_matrix(np.asarray(d.P)), c=np.asarray(d.c),
        A=sp.csc_matrix(np.asarray(d.A)), b=np.asarray(d.b),
        G=sp.csc_matrix(np.asarray(d.G)),
        h_l=np.where(hl, np.asarray(d.h_l), -np.inf),
        h_u=np.where(hu, np.asarray(d.h_u), np.inf),
    )


def test_native_library_matches_numpy():
    """The C++ structure detection and scatters against their numpy plain
    versions, on a problem whose variables are shuffled."""
    prob = _user_problem(dict(T=16, D=3, Da=2, ra=2, rg=2, seed=21))
    n = prob["P"].shape[0]
    perm = np.random.default_rng(0).permutation(n)
    P = prob["P"][perm][:, perm].tocsc()
    G = prob["G"][:, perm].tocsr()
    S = sp.csc_matrix((abs(P) + abs(P).T + sp.eye(n)).astype(bool))
    got = _native.detect_structure(S.indptr, S.indices, n)
    want = _native._detect_structure_np(S.indptr, S.indices, n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert _native.LIB_PATH.exists()

    rng = np.random.default_rng(1)
    T, D, Da = 6, 4, 3
    var_stage = np.where(rng.uniform(size=n) < 0.1, -1, np.arange(n) * T // n)
    var_off = rng.integers(0, min(D, Da), n)
    P = sp.csc_matrix(sp.diags(rng.standard_normal(n)) + sp.diags(rng.standard_normal(n - 1), 1))
    args = (P.indptr, P.indices, P.data, var_stage, var_off, T, D, Da)
    try:
        want = _native._scatter_P_np(*args)
    except ValueError:
        with pytest.raises(ValueError):
            _native.scatter_P(*args)
    else:
        for a, b in zip(_native.scatter_P(*args), want):
            np.testing.assert_array_equal(a, b)
    rows = G.shape[0]
    bucket = np.clip(rng.integers(0, T, rows), 0, T - 1)
    slot = np.arange(rows) % 5
    cargs = (G.indptr, G.indices, G.data, var_stage, var_off, bucket, slot, T, 5, D, Da)
    try:
        want = _native._scatter_constr_np(*cargs)
    except ValueError:
        with pytest.raises(ValueError):
            _native.scatter_constr(*cargs)
    else:
        for a, b in zip(_native.scatter_constr(*cargs), want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("T,cap", [(16, None), (17, None), (17, 16)])
def test_from_sparse_matches_jax(T, cap, cr_max):
    """Detection, reblocking, bucketing, scatter and (with the chunked
    scheme selected) horizon padding give the JAX package's data and
    layout."""
    if cap is not None:
        cr_max(cap)
    prob = _user_problem(dict(T=T, D=3, Da=2, ra=2, rg=2, seed=T + 10))
    tdata, tlay = tms.from_sparse(**prob, device="cpu")
    jdata, jlay = jms.from_sparse(**prob)
    _assert_data_equal(tdata, _stack([jdata]))
    for name in ("var_map", "a_row_map", "g_row_map"):
        np.testing.assert_array_equal(getattr(tlay, name), getattr(jlay, name))
    assert tlay.waste == jlay.waste
    assert (tdata.T == T) == (cap is None), "pads only for the chunked scheme"


def test_detect_rejects_unstructured():
    rng = np.random.default_rng(5)
    Q = rng.standard_normal((40, 40))
    with pytest.raises(ValueError):
        tms.from_sparse(sp.csc_matrix(Q @ Q.T + 40 * np.eye(40)), np.zeros(40), device="cpu")


@pytest.mark.parametrize("T,cap", [(16, None), (17, 16)], ids=["cr", "padded"])
def test_update_values_and_vectors_match_jax(T, cap, cr_max):
    if cap is not None:
        cr_max(cap)
    prob = _user_problem(dict(T=T, D=3, Da=2, ra=2, rg=2, seed=22))
    tdata, tlay = tms.from_sparse(**prob, device="cpu")
    jdata, jlay = jms.from_sparse(**prob)
    prob2 = dict(prob, c=prob["c"] * 1.25, P=prob["P"] * 1.5)
    up_t, _ = tms.update_values(tlay, **prob2, device="cpu")
    fresh_t, _ = tms.from_sparse(**prob2, device="cpu")
    _assert_data_equal(up_t, fresh_t)
    _assert_data_equal(up_t, _stack([jms.update_values(jlay, **prob2)[0]]))

    vec = dict(c=prob["c"] * 1.1, b=prob["b"] * 0.9, h_l=prob["h_l"], h_u=prob["h_u"] + 0.5)
    vt = tms.update_vectors(tlay, tdata, **vec)
    vj = jms.update_vectors(jlay, jdata, **vec)
    _assert_data_equal(vt, _stack([vj]))
    for k in BLOCKS:
        assert getattr(vt, k) is getattr(tdata, k), k
    # a changed dead-row pattern needs the full path in both packages
    kill = int(np.nonzero(np.isfinite(prob["h_l"]) | np.isfinite(prob["h_u"]))[0][0])
    dead = dict(vec, h_l=prob["h_l"].copy(), h_u=vec["h_u"].copy())
    dead["h_l"][kill], dead["h_u"][kill] = -np.inf, np.inf
    assert tms.update_vectors(tlay, tdata, **dead) is None
    assert jms.update_vectors(jlay, jdata, **dead) is None
