"""The IPM loop as CUDA graphs of its segments (``solver._solve_loop``,
``piqp_tpu_torch/graphs.py``).

On the CPU the segments run through the stand-in capture
(``graphs._standin``), whose replay calls the segment on the same
persistent buffers (``graphs.Slots``), as a graph would run its kernels:
the result must be bitwise the eager loop's (``solver._solve_eager``: the
same loop on ``graphs.Names``, each segment run at once).  Then the rule
for where the graphs engage, the buffers' copy discipline, the cache's
memory rule and the spans.  The
tests marked ``card`` hold the graphed loop against the eager one on a
CUDA device and skip without one:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs.py -m card

(``--noconftest``: this file imports no JAX, the suite's conftest does).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from piqp_tpu_torch import Settings, graphs, prepare_batch, ruiz, solver
from piqp_tpu_torch.api import _warm_vars, has_cone
from piqp_tpu_torch.multistage import random_multistage_batch
from piqp_tpu_torch.ops import chol_inv
from piqp_tpu_torch.parallel.horizon import _take_stages
from piqp_tpu_torch.types import BasicVars, FullKKTQPData, LDLTKKTQPData
from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

SOLVED = 1
PRIMAL_INFEASIBLE = -2
MIXED = Settings(mixed_precision=True)
VARS = ("x", "y", "z_l", "z_u", "z_bl", "z_bu", "s_l", "s_u", "s_bl", "s_bu")
INFO = ("status", "iter", "rho", "delta")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _fleet(count, n=12, p=3, m=6, seed=0):
    return [dense_strongly_convex_qp(n, p, m, seed=seed + i) for i in range(count)]


def _bitwise(a, b, what):
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    assert a.shape == b.shape and a.dtype == b.dtype and bool(same.all()), what


def _assert_same(eager, graphed):
    for f in VARS:
        _bitwise(getattr(eager, f), getattr(graphed, f), f)
    for f in INFO:
        _bitwise(getattr(eager.info, f), getattr(graphed.info, f), f)


class _Both:
    """Solves each request twice, through the eager loop and through the
    segmented loop with ``cache``'s entry for its key, and checks the two
    results bitwise equal."""

    def __init__(self, settings, cache=None):
        self.settings = settings
        self.cache = cache or graphs.Cache(graphs._standin)
        self.entries = []

    def solve(self, data, warm=None):
        sdata, sc = ruiz.equilibrate(data, max_iter=self.settings.preconditioner_iter)
        cone = has_cone(sdata)
        warm = _warm_vars(warm)
        eager = solver._solve_eager(sdata, sc, self.settings, cone, warm)
        with self.cache.entry(graphs.key(sdata, self.settings, cone)) as entry:
            graphed = solver._solve_loop(sdata, sc, self.settings, cone, warm, entry.slots,
                                         entry.segments.run)
        self.entries.append(entry)
        _assert_same(eager, graphed)
        return graphed


def _cold_twice(settings):
    both = _Both(settings)
    res = both.solve(prepare_batch(_fleet(6), device="cpu"))
    assert res.info.status.tolist() == [SOLVED] * 6
    # a second fleet of the same shape: inputs copied into the buffers,
    # every segment replayed
    both.solve(prepare_batch(_fleet(6, seed=20), device="cpu"))
    assert both.entries[0] is both.entries[1] and both.entries[0].segments._replays


def _warm_moved_costs(settings):
    both = _Both(settings)
    data = prepare_batch(_fleet(6), device="cpu")
    last = both.solve(data)
    rng = np.random.default_rng(5)
    for _ in range(3):
        c = data.c + torch.as_tensor(1e-3 * rng.standard_normal(tuple(data.c.shape)))
        last = both.solve(dataclasses.replace(data, c=c), warm=last)
        assert last.info.status.tolist() == [SOLVED] * 6
    assert len(both.cache) == 1 and all(e is both.entries[0] for e in both.entries)


def _second_batch_size(settings):
    both = _Both(settings)
    both.solve(prepare_batch(_fleet(6), device="cpu"))
    both.solve(prepare_batch(_fleet(4, seed=30), device="cpu"))
    assert len(both.cache) == 2 and both.entries[1] is not both.entries[0]
    both.solve(prepare_batch(_fleet(6, seed=40), device="cpu"))
    assert both.entries[2] is both.entries[0]


def _ladder_retry(settings, monkeypatch):
    """Problem 1 has P = -I/2: from a zero warm start (no init factor) its
    first factorizations fail, and the ladder climbs inside the trips."""
    climbs = []
    climb = solver._ladder_climb

    def counted(*args):
        climbs.append(1)
        return climb(*args)

    monkeypatch.setattr(solver, "_ladder_climb", counted)
    probs = _fleet(4, n=10, p=2, m=6, seed=40)
    probs[1] = dict(probs[1], P=-0.5 * np.eye(10))
    data = prepare_batch(probs, device="cpu")
    zeros = [torch.zeros((4, k), dtype=torch.float64) for k in (10, 2, 6, 6, 10, 10)]
    both = _Both(settings)
    both.solve(data, warm=BasicVars(*zeros))
    # the eager loop's climbs, then the segmented loop's as many
    assert climbs and len(climbs) % 2 == 0


def _primal_infeasible(settings):
    """A primal-infeasible problem (PIQP's test) beside feasible ones of its
    shape, with the certificate checks on (the default)."""
    assert settings.verify_certificates
    P, c = np.diag([6.0, 4.0]), np.array([-1.0, -4.0])
    G = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    base = dict(P=P, c=c, A=np.array([[1.0, -2.0]]), b=np.array([0.0]), G=G)
    probs = [dict(base, h_u=np.array([0.0, 2.0, 1.0, -1.0]))]
    probs += [dict(base, h_u=np.array([1.0, 2.0, 1.0 + k, 1.0])) for k in range(3)]
    res = _Both(settings).solve(prepare_batch(probs, device="cpu"))
    assert res.info.status.tolist() == [PRIMAL_INFEASIBLE, SOLVED, SOLVED, SOLVED]


def _equality_only(settings):
    rng = np.random.default_rng(0)
    probs = []
    for _ in range(3):
        Q = rng.standard_normal((8, 8))
        probs.append(dict(P=Q @ Q.T + np.eye(8), c=rng.standard_normal(8),
                          A=rng.standard_normal((3, 8)), b=rng.standard_normal(3)))
    both = _Both(settings)
    data = prepare_batch(probs, device="cpu")
    assert not has_cone(data)
    both.solve(data)
    both.solve(data)


def _stage_fleet(seed, T=16):
    """Stage data at T = 16, the cyclic reduction's smallest horizon, with
    an arrow, equality and inequality rows a stage."""
    return random_multistage_batch([seed + i for i in range(4)], T=T, D=3, Da=1, ra=1, rg=1,
                                   device="cpu")


def _stage_cold_twice(settings):
    both = _Both(settings)
    res = both.solve(_stage_fleet(0))
    assert res.info.status.tolist() == [SOLVED] * 4
    both.solve(_stage_fleet(10))
    assert both.entries[0] is both.entries[1] and both.entries[0].segments._replays


def _stage_warm_moved_costs(settings):
    both = _Both(settings)
    data = _stage_fleet(0)
    last = both.solve(data)
    rng = np.random.default_rng(5)
    for _ in range(3):
        c = data.c + torch.as_tensor(1e-3 * rng.standard_normal(tuple(data.c.shape)))
        last = both.solve(dataclasses.replace(data, c=c), warm=last)
        assert last.info.status.tolist() == [SOLVED] * 4
    # another horizon of the same n is another entry
    both.solve(_stage_fleet(0, T=8))
    assert len(both.cache) == 2


CASES = {
    "cold_twice": _cold_twice,
    "warm_moved_costs": _warm_moved_costs,
    "second_batch_size": _second_batch_size,
    "ladder_retry": _ladder_retry,
    "primal_infeasible": _primal_infeasible,
    "equality_only": _equality_only,
    "centrality_correctors": lambda s: _cold_twice(dataclasses.replace(
        s, centrality_correctors=2)),
    "stage_cold_twice": _stage_cold_twice,
    "stage_warm_moved_costs": _stage_warm_moved_costs,
}


@pytest.mark.parametrize("mode", ["mixed", "float64"])
@pytest.mark.parametrize("case", CASES)
def test_segmented_loop_is_the_eager_loop(case, mode, monkeypatch):
    settings = MIXED if mode == "mixed" else Settings()
    fn = CASES[case]
    if case == "ladder_retry":
        fn(settings, monkeypatch)
    else:
        fn(settings)


def _on(data, device_type="cuda"):
    """``data`` as the rule sees a copy on ``device_type``: its cost vector
    reports that device."""
    fake = types.SimpleNamespace(device=torch.device(device_type), requires_grad=False)
    return dataclasses.replace(data, c=fake)


def _dense():
    return prepare_batch(_fleet(2), device="cpu")


REFUSED = {
    "cpu_tensors": lambda: (_dense(), Settings()),
    "dense_lu": lambda: (_on(FullKKTQPData(**vars(_dense()))), Settings()),
    "dense_ldlt": lambda: (_on(LDLTKKTQPData(**vars(_dense()))), Settings()),
    "horizon_sharded": lambda: (_on(_take_stages(random_multistage_batch(
        [0, 1], T=4, D=2, Da=1, ra=1, rg=1, device="cpu"), (0, 4))), Settings()),
    "verbose": lambda: (_on(_dense()), Settings(verbose=True)),
}


@pytest.mark.parametrize("case", REFUSED)
def test_graphs_engage_only_on_condensed_cuda_data(case):
    data, settings = REFUSED[case]()
    assert not graphs.engages(data, settings)
    # the same settings on condensed data on the card engage (the control)
    if not settings.verbose:
        assert graphs.engages(_on(_dense()), settings)


def test_graphs_engage_on_whole_horizon_stage_data():
    data = random_multistage_batch([0, 1], T=3, D=2, Da=1, ra=1, rg=1, device="cpu")
    assert graphs.engages(_on(data), Settings())
    assert not graphs.engages(data, Settings())
    # a stage layout and a dense one of the same sizes get their own entries
    dense = _dense()
    assert graphs.key(data, MIXED, True) != graphs.key(dense, MIXED, True)
    assert graphs.key(data, MIXED, True) == graphs.key(
        random_multistage_batch([2, 3], T=3, D=2, Da=1, ra=1, rg=1, device="cpu"), MIXED, True)


def test_graphs_refuse_a_solve_autograd_records():
    data = _dense()
    data = dataclasses.replace(data, P=data.P.clone().requires_grad_())
    fake = types.SimpleNamespace(device=torch.device("cuda"), requires_grad=False)
    data = dataclasses.replace(data, c=fake)
    assert not graphs.engages(data, Settings())
    with torch.no_grad():
        assert graphs.engages(data, Settings())


def test_slots_copy_in_place_and_read_before_overwriting():
    slots = graphs.Slots()
    a, b = torch.arange(3.0), torch.arange(3.0) + 10
    slots.put(pair=(a, b))
    first = slots.pair[0]
    assert first is not a and torch.equal(first, a)
    # the two buffers swapped: each read before either is written
    slots.put(pair=(slots.pair[1], slots.pair[0]))
    assert slots.pair[0] is first
    assert slots.pair[0].tolist() == [10.0, 11.0, 12.0]
    assert slots.pair[1].tolist() == [0.0, 1.0, 2.0]
    with pytest.raises(ValueError):
        slots.put(pair=(a, b.to(torch.float64)))


def test_cache_keeps_the_newest_entries():
    cache = graphs.Cache(graphs._standin, size=2)
    kept = {}
    for k in ("a", "b", "a", "c"):
        with cache.entry(k) as e:
            kept.setdefault(k, e)
            assert e is kept[k]
    assert len(cache) == 2
    with cache.entry("b") as e:
        assert e is not kept["b"]  # "b" was the least recently used
    with pytest.raises(RuntimeError), cache.entry("a"):
        raise RuntimeError("a solve that raises drops its entry")
    assert len(cache) == 2
    with cache.entry("a") as e:
        assert e is not kept["a"]


def test_cache_makes_an_entry_only_where_it_fits():
    """A new entry asks ``free()`` for its bytes: the least recently used
    entries go, one at a time with their memory handed back, until they
    fit; where none is left to go, no entry (the solve runs eagerly)."""
    free, released = [100], []
    cache = graphs.Cache(graphs._standin, free=lambda: free[0],
                         release=lambda: released.append(1))
    kept = {}
    for k in ("a", "b", "c"):
        with cache.entry(k, need=60) as e:
            kept[k] = e
            assert e is not None
    assert len(cache) == 3 and not released
    free[0] = 50
    with cache.entry("b", need=60) as e:
        assert e is kept["b"]  # an entry kept holds its memory already
    with cache.entry("d", need=60) as e:
        assert e is None
    # every entry went, one release each, and none was made
    assert len(cache) == 0 and len(released) == 3
    with cache.entry("d", need=40) as e:
        assert e is not None
    assert len(cache) == 1


def test_cache_room_counts_the_data():
    data = _dense()
    assert graphs.room(data) == graphs.ROOM_PER_DATA_BYTE * sum(
        getattr(data, f.name).nbytes for f in dataclasses.fields(data)
        if isinstance(getattr(data, f.name), torch.Tensor))


def _profiled(fn):
    """``fn()`` under the CPU profiler: its result, the ``piqp.*`` spans
    and the host reads of a tensor (``bool()`` of one), each (name, start,
    end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    return (out, [e for e in events if e[0].startswith("piqp.")],
            [e for e in events if e[0] == "aten::_local_scalar_dense"])


def _inside(s, parents):
    return any(p[1] <= s[1] and s[2] <= p[2] for p in parents)


def test_spans_and_decisions_of_the_segmented_loop():
    """Replays sit in ``piqp.ipm.graph`` spans inside the trips, the eager
    loop's KKT spans are kept around them, and each trip makes the eager
    loop's host reads."""
    cache = graphs.Cache(graphs._standin)
    sdata, sc = ruiz.equilibrate(prepare_batch(_fleet(4), device="cpu"))
    key = graphs.key(sdata, MIXED, True)
    def segmented():
        with cache.entry(key) as entry:
            return solver._solve_loop(sdata, sc, MIXED, True, None, entry.slots,
                                      entry.segments.run)

    segmented()

    res, spans, reads = _profiled(segmented)
    assert res.info.status.tolist() == [SOLVED] * 4
    trips = [s for s in spans if s[0] == "piqp.ipm.iter"]
    replays = [s for s in spans if s[0] == "piqp.ipm.graph"]
    # the key's second solve: every trip replays; outside the trips only
    # the exit test that opens each phase's loop
    assert trips and all(any(_inside(r, [t]) for r in replays) for t in trips)
    assert len([r for r in replays if not _inside(r, trips)]) == 2
    # (the cold start's factor and solve run before the loop, and a ladder
    # rung's refactorization in the trip, eagerly)
    solves = [s for s in spans if s[0] == "piqp.kkt.solve" and _inside(s, trips)]
    assert solves and all(any(_inside(r, [s]) for r in replays) for s in solves)
    factors = [s for s in spans if s[0] == "piqp.kkt.factor"
               and any(_inside(r, [s]) for r in replays)]
    assert all(_inside(s, trips) for s in factors)
    assert len(factors) == len(solves) // 2

    _, eager_spans, eager_reads = _profiled(
        lambda: solver._solve_eager(sdata, sc, MIXED, True))
    eager_trips = [s for s in eager_spans if s[0] == "piqp.ipm.iter"]
    assert len(eager_trips) == len(trips)
    for t, e in zip(trips, eager_trips):
        assert (len([r for r in reads if _inside(r, [t])])
                == len([r for r in eager_reads if _inside(r, [e])]))
    assert len(reads) == len(eager_reads)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda_fleet(count, n, seed):
    probs = [dense_strongly_convex_qp(n, n // 2, n // 2, seed=seed + i) for i in range(count)]
    return prepare_batch(probs, device="cuda")


def _launches():
    """K1's launches by dtype and by route, and K2's by shape (a shape's
    key appears at its first launch)."""
    return (dict(chol_inv.launches_by_dtype), dict(chol_inv.launches_by_route),
            dict(chol_inv.apply_launches_by_shape))


def _advance(before, after):
    return [{k: a[k] - b.get(k, 0) for k in a} for b, a in zip(before, after)]


# each card fleet and the counter of ``_launches`` its kernel moves
CARD_FLEETS = {
    # condensed n = 32: K1
    "dense": (lambda: _cuda_fleet(64, 32, seed=100), 0),
    # stage data at T = 40: cyclic reduction, K2 at every level
    "stage": (lambda: random_multistage_batch(list(range(300, 364)), T=40, D=6, Da=0, ra=3,
                                              rg=2, device="cuda"), 2),
}


@pytest.mark.card
@pytest.mark.parametrize("fleet", CARD_FLEETS)
def test_graphed_loop_is_the_eager_loop_on_the_card(fleet, card):
    """B = 64, mixed: a cold solve, then 3 warm re-solves with moved
    costs, graphed (``solve_scaled``) and eager; status, iterations and x
    bitwise equal, and the hand-written kernels' launches counted alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    make, counter = CARD_FLEETS[fleet]
    data = make()
    assert graphs.engages(data, MIXED)
    rng = np.random.default_rng(7)
    costs = [data.c] + [data.c + torch.as_tensor(1e-3 * rng.standard_normal(
        tuple(data.c.shape)), device="cuda") for _ in range(3)]

    def rounds(solve):
        out, warm = [], None
        before = _launches()
        for c in costs:
            sdata, sc = ruiz.equilibrate(dataclasses.replace(data, c=c))
            warm = solve(sdata, sc, MIXED, True, _warm_vars(warm))
            out.append(warm)
        torch.cuda.synchronize()
        return out, _advance(before, _launches())

    eager, eager_k = rounds(solver._solve_eager)
    graphed, graphed_k = rounds(solver.solve_scaled)
    for e, g in zip(eager, graphed):
        _bitwise(e.info.status, g.info.status, "status")
        _bitwise(e.info.iter, g.info.iter, "iter")
        _bitwise(e.x, g.x, "x")
    assert eager[0].info.status.tolist() == [SOLVED] * 64
    assert graphed_k == eager_k and sum(eager_k[counter].values()) > 0
    # a second pass replays every segment captured in the first
    again, again_k = rounds(solver.solve_scaled)
    for e, g in zip(eager, again):
        _bitwise(e.x, g.x, "x")
    assert again_k == eager_k
