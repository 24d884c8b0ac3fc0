"""The chain-of-masses fleet on the multistage path, on the CPU: the plain
reference (``references/chain_mass.py``) against its own equations, the
benchmark's frozen copy of it (``gpubench/generators/chainmass5.py``)
against the reference, the stage layout against the reference's
natural-order QP, and ``solve_batch(kkt_solver=multistage)`` through the
stage entry ``prepare_stage_batch`` against the benchmark's plain float64
IPM (``gpubench/reference.py``).  Also the entry's stacking, K2's
launch-shape counter and the cyclic reduction's spans."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import piqp_tpu_torch as pt
from gpubench import byname, check, reference
from gpubench.entries import stage_batch
from piqp_tpu_torch import graphs, multistage
from piqp_tpu_torch.ops import chol_inv
from references import chain_mass as cm

GEN = byname.load("generators", "chainmass5")
# the benchmark's size and its CPU size (the configuration's ``tiny``: the
# cyclic reduction's smallest horizon, T = 16)
FULL = (5, 40)
TINY = (3, 16)
SEEDS = [0, 17, 100000 * 2 * 2147483701 + 3]
SOLVED = int(pt.Status.SOLVED)

# x against the reference IPM, |x - x_ref|_inf / max(1, |x_ref|_inf): the
# program stops at PIQP's eps_abs 1e-8, and on these well-scaled problems
# its x lies within 6e-10 of the reference's in both modes; the reference
# in float32 lies 3.5e-7 off, 35 times this limit
X_TOL = 1e-8
# the widest scaled primal violation on the original data: the program's
# is ~3e-11, float32's 6.3e-8, 63 times this limit
PRIMAL_TOL = 1e-9


def _stage_kw(problem: dict) -> dict:
    return {k: problem[k] for k in stage_batch.STAGE_KEYS if k in problem}


def _problems(size, count, first=0):
    return [GEN.generate(*size, seed=s) for s in range(first, first + count)]


def _dense(problems, with_cost=True) -> dict:
    forms = [GEN.dense(p, with_cost) for p in problems]
    return {k: np.stack([f[k] for f in forms]) for k in forms[0]}


# -- the reference against its equations --------------------------------------

@pytest.mark.parametrize("n_mass", [3, 5])
def test_rest_state_balances_the_forces(n_mass):
    x = cm.rest_state(n_mass)
    M = cm.free_masses(n_mass)
    p = x[:3 * (M + 1)].reshape(M + 1, 3)
    assert torch.equal(p[-1], cm.end_position(n_mass))
    assert float(cm.accelerations(p).abs().max()) <= 1e-12
    assert float(cm.dynamics(x, torch.zeros(3, dtype=cm.DTYPE), n_mass).abs().max()) <= 1e-12
    # the chain hangs in the x-z plane, below its ends
    assert float(p[:, 1].abs().max()) == 0.0 and float(p[:-1, 2].max()) < 0


@pytest.mark.parametrize("n_mass", [3, 5])
def test_jacobians_are_central_differences(n_mass):
    A_c, B_c = cm.linearised(n_mass)
    x0, u0 = cm.rest_state(n_mass), torch.zeros(3, dtype=cm.DTYPE)
    h = 1e-6

    def column(i, wrt_x):
        e = torch.zeros(x0.shape[0] if wrt_x else 3, dtype=cm.DTYPE)
        e[i] = h
        if wrt_x:
            return (cm.dynamics(x0 + e, u0, n_mass) - cm.dynamics(x0 - e, u0, n_mass)) / (2 * h)
        return (cm.dynamics(x0, u0 + e, n_mass) - cm.dynamics(x0, u0 - e, n_mass)) / (2 * h)

    fd_A = torch.stack([column(i, True) for i in range(x0.shape[0])], 1)
    fd_B = torch.stack([column(i, False) for i in range(3)], 1)
    # truncation O(h^2 f''') and rounding O(eps |f| / h): both far below 1e-6
    # of the entries (up to D/m ~ 30)
    assert float((fd_A - A_c).abs().max()) <= 1e-6 * float(A_c.abs().max())
    assert torch.equal(fd_B, B_c)


@pytest.mark.parametrize("n_mass", [3, 5])
def test_hold_is_a_fine_rk4(n_mass):
    A_c, B_c = cm.linearised(n_mass)
    A, B = cm.zero_order_hold(A_c, B_c)
    g = torch.Generator().manual_seed(n_mass)
    x = torch.randn(A.shape[0], generator=g, dtype=cm.DTYPE)
    u = torch.rand(3, generator=g, dtype=cm.DTYPE) * 2 - 1
    steps = 4000
    h = cm.TS / steps

    def f(y):
        return A_c @ y + B_c @ u

    y = x.clone()
    for _ in range(steps):
        k1 = f(y)
        k2 = f(y + 0.5 * h * k1)
        k3 = f(y + 0.5 * h * k2)
        k4 = f(y + h * k3)
        y = y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    # RK4's error at h = 5e-5 on eigenvalues up to ~12 i: ~1e-14 a step
    assert float((A @ x + B @ u - y).abs().max()) <= 1e-9 * float(y.abs().max())


@pytest.mark.parametrize("n_mass", [3, 5])
def test_the_lqr_gain_solves_riccati(n_mass):
    mdl = cm.model(n_mass)
    A, B, Q, R, K = (torch.as_tensor(mdl[k]) for k in "ABQRK")
    # the undamped chain: every mode on the unit circle; the gain damps them
    assert np.abs(np.linalg.eigvals(mdl["A"])).max() == pytest.approx(1.0, abs=1e-9)
    assert np.abs(np.linalg.eigvals(mdl["A"] + mdl["B"] @ mdl["K"])).max() < 0.9
    # P of the gain's closed loop satisfies the Riccati equation
    Acl = A + B @ K
    n = A.shape[0]
    P = torch.linalg.solve(torch.eye(n * n, dtype=cm.DTYPE) - torch.kron(Acl.T, Acl.T),
                           (Q + K.T @ R @ K).reshape(-1)).reshape(n, n)
    K_star = -torch.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
    assert float((K_star - K).abs().max()) <= 1e-8 * float(K.abs().max())


@pytest.mark.parametrize("size", [TINY, FULL], ids=["tiny", "full"])
def test_initial_states_keep_the_wall(size):
    n_mass, N = size
    mdl = cm.model(n_mass)
    rows, low = cm.wall_rows(n_mass), cm.WALL - mdl["rest"][cm.wall_rows(n_mass)]
    for seed in SEEDS:
        x = cm.initial_state(n_mass, N, seed)
        assert np.abs(x).max() > 0
        for _ in range(N):
            u = np.clip(mdl["K"] @ x, -1.0, 1.0)
            x = mdl["A"] @ x + mdl["B"] @ u
            assert (x[rows] >= low).all()


# -- the frozen generator and the layout --------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_frozen_generator_is_the_reference(seed):
    n_mass, N = FULL
    ours, theirs = GEN.model(n_mass), cm.model(n_mass)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].tobytes() == theirs[k].tobytes(), k
    x0 = cm.initial_state(n_mass, N, seed)
    problem = GEN.generate(n_mass, N, seed)
    assert problem["x0"].tobytes() == x0.tobytes()
    nat, ref = GEN.natural_qp(n_mass, N, x0), cm.natural_qp(n_mass, N, x0)
    assert sorted(nat) == sorted(ref)
    for k in ref:
        assert nat[k].tobytes() == ref[k].tobytes(), k


@pytest.mark.parametrize("size,count", [(TINY, 4), (FULL, 1)], ids=["tiny", "full"])
def test_stage_layout_is_the_natural_qp(size, count):
    problems = _problems(size, count)
    data = multistage.to_dense(pt.prepare_stage_batch([_stage_kw(p) for p in problems],
                                                      device="cpu"))
    n_mass, N = size
    nx = cm.state_size(n_mass)
    assert (data.P.shape[-1], data.A.shape[-2], data.G.shape[-2]) == (N * (nx + 3), N * nx, 0)
    dense = _dense(problems)
    for k in ("P", "c", "A", "b", "G"):
        np.testing.assert_array_equal(getattr(data, k).numpy(), dense[k], err_msg=k)
    for k, mask, inf in (("x_l", "xl_mask", -np.inf), ("x_u", "xu_mask", np.inf)):
        np.testing.assert_array_equal(
            torch.where(getattr(data, mask), getattr(data, k), inf).numpy(), dense[k], err_msg=k)


@pytest.mark.parametrize("source", ["chain", "random"])
def test_stage_entry_is_the_stacked_arrays(source):
    if source == "chain":
        problems = [_stage_kw(p) for p in _problems(TINY, 3)]
    else:
        problems = [multistage.random_multistage_arrays(16, 3, 1, 2, 2, seed=s) for s in range(3)]
    for dtype in (torch.float64, torch.float32):
        np_dtype = np.dtype(str(dtype).removeprefix("torch."))
        ours = pt.prepare_stage_batch(problems, dtype=dtype, device="cpu")
        theirs = multistage.stage_data_from_arrays(
            [multistage._stage_arrays(**p, np_dtype=np_dtype) for p in problems], dtype, "cpu")
        for f in dataclasses.fields(multistage.StageQPData):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            assert a.dtype == b.dtype and torch.equal(a, b), f.name


# -- the system against the reference -----------------------------------------

def _gaps(problems, x) -> tuple:
    dense = _dense(problems)
    x_ref = reference.solve(dense)[0]
    gap = float((np.abs(x - x_ref).max(-1) / np.maximum(1.0, np.abs(x_ref).max(-1))).max())
    viol = check.primal_violation(_dense(problems, with_cost=False), x[None], "cpu")
    return gap, viol


@pytest.mark.parametrize("mixed", [False, True], ids=["float64", "mixed"])
def test_the_fleet_matches_the_reference(mixed):
    problems = _problems(TINY, 4)
    data = stage_batch.enter(problems, "cpu")
    assert multistage._use_cr(data.T)
    res = pt.solve_batch(data, pt.Settings(kkt_solver=pt.KKTBackend.multistage,
                                           mixed_precision=mixed))
    assert res.info.status.tolist() == [SOLVED] * 4
    gap, viol = _gaps(problems, res.x.numpy())
    assert gap <= X_TOL and viol <= PRIMAL_TOL, (gap, viol)


def test_float32_misses_a_tolerance():
    problems = _problems(TINY, 4)
    x32 = reference.solve(_dense(problems), dtype=torch.float32)[0]
    gap, viol = _gaps(problems, x32)
    assert gap > X_TOL or viol > PRIMAL_TOL, (gap, viol)


# -- counters and spans -------------------------------------------------------

def test_the_shape_counter_is_a_counter_and_stays_empty_here():
    assert chol_inv.apply_launches_by_shape in chol_inv.COUNTERS
    before = dict(chol_inv.apply_launches_by_shape)
    data = stage_batch.enter(_problems(TINY, 2), "cpu")
    pt.solve_batch(data, pt.Settings(kkt_solver=pt.KKTBackend.multistage, mixed_precision=True))
    # the plain version on the CPU launches no kernel
    assert chol_inv.apply_launches_by_shape == before == {}


def test_a_capture_takes_back_a_key_it_made():
    counter = {"float32:64x8x20": 2}
    before = [dict(counter)]
    counter["float32:64x8x20"] += 1
    counter["float64:32x8x20"] = 4
    held = graphs.take_back((counter,), before)
    assert counter == {"float32:64x8x20": 2}
    graphs.add_held(held)
    graphs.add_held(held)
    assert counter == {"float32:64x8x20": 4, "float64:32x8x20": 8}


def _span_counts(fn) -> dict:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = [e.name for e in prof.events() if e.name.startswith("piqp.")]
    return {n: names.count(n) for n in set(names)}


def test_cyclic_reduction_spans():
    data = stage_batch.enter(_problems(TINY, 2), "cpu")
    T, D = data.T, data.D
    g = torch.Generator().manual_seed(0)
    M = torch.randn(2, T, D, D, generator=g, dtype=torch.float64)
    Kd = M @ M.mT + D * torch.eye(D, dtype=torch.float64)
    Ksub = 0.1 * torch.randn(2, T, D, D, generator=g, dtype=torch.float64)
    Ka, Kc = Kd.new_zeros(2, T, 0, D), Kd.new_zeros(2, 0, 0)
    box = {}
    counts = _span_counts(lambda: box.update(f=multistage.cr_factor(Kd, Ksub, Ka, Kc, True)[0]))
    # T = 16: levels of 8, 4, 2 and 1 odd blocks
    assert counts == {"piqp.ms.cr_level": 4}
    vs = torch.randn(2, T, D, generator=g, dtype=torch.float64)
    counts = _span_counts(lambda: multistage.cr_solve(box["f"], vs, vs.new_zeros(2, 0)))
    assert counts == {"piqp.ms.cr_sweep": 2}
    # in a whole solve: four levels a factorization, two sweeps a solve
    counts = _span_counts(lambda: pt.solve_batch(
        data, pt.Settings(kkt_solver=pt.KKTBackend.multistage)))
    assert counts["piqp.ms.cr_level"] == 4 * counts["piqp.kkt.factor"]
    assert counts["piqp.ms.cr_sweep"] % 2 == 0
    assert counts["piqp.ms.cr_sweep"] >= 2 * counts["piqp.kkt.solve"]
