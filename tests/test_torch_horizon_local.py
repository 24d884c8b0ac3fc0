"""The rank-local layout of the horizon-sharded backend (``parallel/``) in
one process: one horizon cut into 2 and 4 simulated ranks, each holding
only its own stages of the nine block fields (``parallel.horizon._take_stages``),
and every owned-stage function joined over the ranks held to the
whole-horizon function, float64 to 1e-13.

The ranks are threads of this process.  ``comm``'s all-gather, on which
every collective of the layout rests, is replaced for them by a barrier
over shared slots (``SimGroup``), so the halos and the gathered pieces
pass between the ranks by hand, with no process group and no spawned
process.  Each function runs on every rank at once; every rank's whole
result (the flat vectors, Kc, the scalings) must equal every other
rank's bit for bit, as the replicated IPM loop needs.

Also here: ``pad_stages`` on the device against the JAX package's,
exactly.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import piqp_tpu_torch
from piqp_tpu_torch import convert, kkt, ruiz, solve_horizon_sharded
from piqp_tpu_torch import multistage as tms
from piqp_tpu_torch.ops import matvec as mv
from piqp_tpu_torch.parallel import ShardedStageQPData, comm, pad_stages
from piqp_tpu_torch.parallel.horizon import _take_stages

# test_torch_horizon.py's CASES at T = 68 (4 chunks of Qi = 16, cyclic
# reduction interiors) and T = 8 (4 chunks of Qi = 1, chain interiors)
CASES = {"T68": dict(T=68, D=3, Da=2, ra=2, rg=2, seed=3),
         "T8": dict(T=8, D=3, Da=2, ra=2, rg=2, seed=0)}
CHUNKS = 4
TOL = 1e-13
GRID = [(name, world) for name in CASES for world in (2, 4)]
IDS = [f"{name}-{world}ranks" for name, world in GRID]


class SimGroup:
    """``world`` simulated ranks, one thread each; ``comm``'s all-gather
    runs through a barrier over shared slots."""

    def __init__(self, world: int):
        self.world = world
        self.barrier = threading.Barrier(world)
        self.slots = [None] * world
        self.local = threading.local()


@pytest.fixture
def sim(monkeypatch):
    """Route ``comm``'s primitives to a ``SimGroup`` when one is the group."""
    real = comm._all_gather, comm.rank, comm.world_size

    def all_gather(t, group):
        if not isinstance(group, SimGroup):
            return real[0](t, group)
        group.slots[group.local.rank] = t.clone()
        group.barrier.wait()
        parts = list(group.slots)
        group.barrier.wait()  # every rank has read the slots before any refills them
        return parts

    monkeypatch.setattr(comm, "_all_gather", all_gather)
    monkeypatch.setattr(comm, "rank", lambda group=None: group.local.rank
                        if isinstance(group, SimGroup) else real[1](group))
    monkeypatch.setattr(comm, "world_size", lambda group=None: group.world
                        if isinstance(group, SimGroup) else real[2](group))


def on_ranks(world: int, fn) -> list:
    """``fn(rank, group)`` on ``world`` simulated ranks at once; each rank's
    result, in rank order."""
    group = SimGroup(world)
    results, errors = [None] * world, []

    def run(r):
        group.local.rank = r
        try:
            results[r] = fn(r, group)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads), "a simulated rank hung"
    return results


def rank_view(data, world, r, group):
    """Rank r's part of ``data`` for ``world`` ranks (shard_horizon's
    layout)."""
    per = data.T // world
    return _take_stages(data, (r * per, (r + 1) * per), group, CHUNKS)


def close(a, b, what):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL, err_msg=what)


def same_everywhere(results, what):
    for r, got in enumerate(results[1:], 1):
        assert torch.equal(got, results[0]), f"{what}: rank {r} differs from rank 0"


def _data(name, B=2):
    kw = dict(CASES[name])
    seed = kw.pop("seed")
    return tms.random_multistage_batch([seed + 10 * i for i in range(B)], **kw, device="cpu")


def _vectors(data, seed=7):
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.standard_normal((data.B, n)))
            for k, n in (("x", data.n), ("y", data.p), ("z", data.m))}


MATVECS = {
    "P_x": lambda d, v: mv.P_x(d, v["x"]),
    "A_x": lambda d, v: mv.A_x(d, v["x"]),
    "G_x": lambda d, v: mv.G_x(d, v["x"]),
    "AT_y": lambda d, v: mv.AT_y(d, v["y"]),
    "GT_z": lambda d, v: mv.GT_z(d, v["z"]),
    "P_diag": lambda d, v: mv.P_diag(d),
}


@pytest.mark.parametrize("op", list(MATVECS))
@pytest.mark.parametrize("name,world", GRID, ids=IDS)
def test_matvecs_join_to_the_whole_horizon(name, world, op, sim):
    data = _data(name)
    v = _vectors(data)
    want = MATVECS[op](data, v)
    got = on_ranks(world, lambda r, g: MATVECS[op](rank_view(data, world, r, g), v))
    same_everywhere(got, op)
    close(got[0], want, op)


@pytest.mark.parametrize("name,world", GRID, ids=IDS)
def test_ruiz_norms_join_to_the_whole_horizon(name, world, sim):
    data = _data(name)

    def blocks(d):
        xb_s, xb_g = tms._split_x(d, d.x_b_scaling)
        return tuple(getattr(d, k) for k in tms._BLOCKS) + (xb_s, xb_g)

    def norms(d):
        return tms._stage_col_norms(d, blocks(d)) + (tms._cost_col_norms(d, d.Pd, d.Psub, d.Pa),)

    want = norms(data)
    got = on_ranks(world, lambda r, g: norms(rank_view(data, world, r, g)))
    for i, what in enumerate(("norm_x", "norm_g", "norm_y", "norm_z", "cost norm_x")):
        same_everywhere([n[i] for n in got], what)
        close(got[0][i], want[i], what)


@pytest.mark.parametrize("scale_cost", [False, True], ids=["plain", "scale_cost"])
@pytest.mark.parametrize("name,world", GRID, ids=IDS)
def test_equilibrate_joins_to_the_whole_horizon(name, world, scale_cost, sim):
    data = _data(name)
    want, want_s = ruiz.equilibrate(data, scale_cost=scale_cost)
    got = on_ranks(world, lambda r, g: ruiz.equilibrate(rank_view(data, world, r, g),
                                                        scale_cost=scale_cost))
    for r, (scaled, s) in enumerate(got):
        assert type(scaled) is ShardedStageQPData and scaled.stages == rank_view(
            data, world, r, None).stages
        own = scaled.owned
        for f in dataclasses.fields(tms.StageQPData):
            w = getattr(want, f.name)
            w = w[:, own] if f.name in tms.STAGE_BLOCKS else w
            close(getattr(scaled, f.name).double(), w.double(), f"rank {r} {f.name}")
        for k in ("c", "d_x", "d_y", "d_z", "d_b"):
            assert torch.equal(getattr(s, k), getattr(got[0][1], k)), f"rank {r} {k}"
            close(getattr(s, k), getattr(want_s, k), f"rank {r} {k}")


def _scalings(data, seed=50):
    """KKT scalings of random interior iterates (B problems)."""
    rng = np.random.default_rng(seed)

    def pos(mask):
        return np.where(mask.numpy(), rng.uniform(0.5, 2.0, mask.shape), 0.0)

    v = dict(x=rng.standard_normal((data.B, data.n)), y=rng.standard_normal((data.B, data.p)))
    for k, mask in (("z_l", data.hl_mask), ("z_u", data.hu_mask), ("z_bl", data.xl_mask),
                    ("z_bu", data.xu_mask), ("s_l", data.hl_mask), ("s_u", data.hu_mask),
                    ("s_bl", data.xl_mask), ("s_bu", data.xu_mask)):
        v[k] = pos(mask)
    import types
    B = data.B
    return kkt.compute_scalings(
        data, piqp_tpu_torch.Settings(), convert.vars_(types.SimpleNamespace(**v), batched=True),
        torch.full((B,), 1e-6, dtype=torch.float64), torch.full((B,), 1e-4, dtype=torch.float64),
        torch.zeros(B, dtype=torch.bool), mv.P_diag(data))


@pytest.mark.parametrize("name,world", GRID, ids=IDS)
def test_assembly_joins_to_the_whole_horizon(name, world, sim):
    data = _data(name)
    ks = _scalings(data)
    Kd, Ksub, Ka, Kc = tms._assemble_blocks(data, ks)
    got = on_ranks(world, lambda r, g: tms._assemble_owned(rank_view(data, world, r, g), ks))
    per = data.T // world
    for r, (kd, ksub, ka, kc, e_first) in enumerate(got):
        own = slice(r * per, (r + 1) * per)
        close(kd, Kd[:, own], f"rank {r} Kd")
        close(ksub, Ksub[:, own], f"rank {r} Ksub")
        close(ka, Ka[:, own], f"rank {r} Ka")
        assert torch.equal(kc, got[0][3]), f"rank {r} Kc"
        close(kc, Kc, f"rank {r} Kc")
        close(e_first, Ksub[:, own.start - 1] if r else torch.zeros_like(e_first),
              f"rank {r} E_first")


@pytest.mark.parametrize("name,world", GRID, ids=IDS)
def test_chunked_factor_and_solve_join_to_the_whole_horizon(name, world, sim):
    """The sharded factor and solve on each rank's own stages against the
    single-process chunked scheme over the whole horizon (own=None), both
    in the library representation so that every factor compares."""
    data = _data(name)
    ks = _scalings(data)
    Kd, Ksub, Ka, Kc = tms._assemble_blocks(data, ks)
    want, want_ok = tms._chunked_factor(Kd, Ksub, Ka, Kc, CHUNKS)
    rhs = torch.as_tensor(np.random.default_rng(11).standard_normal((data.B, data.n)))
    vs, vg = tms._split_x(data, rhs)
    want_x = tms._join_x(*tms._chunked_solve(want, vs, vg, data.T, data.D, data.Da))

    def run(r, g):
        view = rank_view(data, world, r, g)
        fks, ok = kkt.factor(view, ks, inverse=False)
        return fks.factor, ok, kkt.condensed_solve_x(view, fks, rhs)

    got = on_ranks(world, run)
    per = CHUNKS // world
    for r, (factor, ok, x) in enumerate(got):
        assert ok.tolist() == want_ok.tolist() == [True] * data.B
        assert torch.equal(x, got[0][2]), f"rank {r} x"
        close(x, want_x, f"rank {r} x")
        local, want_local = factor[0], want[0]
        for a, b in zip(_leaves(local), _leaves(want_local)):
            close(a, b[:, r * per:(r + 1) * per], f"rank {r} interior factor")
        for a, b in zip(factor[1:], want[1:]):
            close(a, b, f"rank {r} separator factor")


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("mixed", [False, True], ids=["float64", "mixed"])
@pytest.mark.parametrize("world", [2, 4])
def test_simulated_ranks_solve_like_one_rank(world, mixed, sim):
    """The whole sharded solve (T = 8, 4 chunks, two problems) on simulated
    ranks: every rank's x identical and equal to one rank's bit for bit
    (the joins keep the whole horizon's order, the products are
    batch-invariant), same iterations."""
    data = _data("T8")
    settings = piqp_tpu_torch.Settings(mixed_precision=mixed)

    def solve(w):
        return on_ranks(w, lambda r, g: solve_horizon_sharded(rank_view(data, w, r, g),
                                                              settings=settings))

    one, = solve(1)
    got = solve(world)
    for r, res in enumerate(got):
        assert res.info.status.tolist() == [1, 1]
        assert res.info.iter.tolist() == one.info.iter.tolist()
        assert torch.equal(res.x, got[0].x), f"rank {r}"
        assert torch.equal(res.x, one.x), f"rank {r}"


def test_collectives_count_and_reduce(sim):
    """``comm``'s collectives on simulated ranks: the exchange hands rank r
    rank r - 1's pieces (zeros on rank 0), the all-reduce sums every
    rank's terms joined along dim 1 in rank order, and
    ``collective_calls`` counts each by kind."""
    def run(r, g):
        t = torch.full((2, 3), float(r + 1), dtype=torch.float64)
        prev, = comm.exchange_prev((t,), g)
        joined, = comm.all_reduce((t,), g)
        return prev, joined

    for r, (prev, joined) in enumerate(on_ranks(3, run)):
        assert torch.equal(prev, torch.full((2, 3), float(r)))
        assert torch.equal(joined, torch.full((2,), 18.0))
    before = dict(comm.collective_calls)
    on_ranks(1, run)
    grew = {k: comm.collective_calls[k] - before[k] for k in before}
    assert grew == {"all_gather": 0, "exchange": 1, "all_reduce": 1}


@pytest.mark.parametrize("T,T_pad", [(5, 8), (8, 12)])
def test_pad_stages_is_the_jax_padding(T, T_pad):
    """``pad_stages`` of a batch of two, with torch ops on the data's
    device, gives each problem the JAX package's ``pad_stages`` exactly
    (signs of zero included); no process group is involved."""
    from piqp_tpu import multistage as jms
    from piqp_tpu.parallel import pad_stages as jpad_stages

    seeds = [4, 5]
    got = pad_stages(tms.random_multistage_batch(seeds, T=T, D=3, Da=2, ra=2, rg=2,
                                                 device="cpu"), T_pad)
    assert got.T == T_pad
    for i, seed in enumerate(seeds):
        want = jpad_stages(jms.random_multistage_qp(T=T, D=3, Da=2, ra=2, rg=2, seed=seed),
                           T_pad)
        for f in dataclasses.fields(tms.StageQPData):
            a = getattr(got, f.name)[i]
            b = torch.from_numpy(np.array(getattr(want, f.name)))
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert torch.equal(a, b), f.name
            if a.is_floating_point():
                assert torch.equal(a.signbit(), b.signbit()), f.name
