"""The port's horizon-sharded multistage backend (``parallel/horizon.py``)
against the JAX package, in one process on a gloo group of one rank
(several chunks a rank reproduce a larger mesh's partition), float64
unless stated.

Oracles, none of which runs a JAX collective in this process (JAX's
shard_map collectives on the forced-host CPU mesh can make a later
in-process compile segfault, tests/test_zz_horizon.py:8-13):
- factor and solve: JAX's single-device chunked partition
  (``piqp_tpu.multistage._chunked_factor`` / ``_chunked_solve``) at
  C = chunks, the same Q, Qi and interior scheme as a mesh of that many
  devices: rtol 1e-9 / atol 1e-10;
- whole IPM: JAX ``solve_prepared`` (sequential): same status, x and y
  within rtol 1e-6 / atol 1e-7 (tests/test_zz_horizon.py:88-93);
- exactly one test runs JAX ``solve_horizon_sharded`` on a 4-device CPU
  mesh, in a child process: same status and iterations, x within 1e-9;
- mixed precision: same status, x within 1e-4 (ROADMAP Queue 3).
The sharded-call counter must grow in every solve, so the sharded
registrations (not the sequential StageQPData ones) are what ran.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import piqp_tpu
from piqp_tpu import kkt as jkkt
from piqp_tpu import multistage as jms
from piqp_tpu import ops as jops
from piqp_tpu.parallel import pad_stages as jpad_stages
from piqp_tpu.types import Vars as JVars

import piqp_tpu_torch
from piqp_tpu_torch import convert, solve_batch, solve_horizon_sharded
from piqp_tpu_torch import kkt as tkkt
from piqp_tpu_torch import multistage as tms
from piqp_tpu_torch.ops import matvec as tops
from piqp_tpu_torch.parallel import (
    ShardedStageQPData, pad_stages, shard_horizon, sharded_calls,
)
from piqp_tpu_torch.types import BasicVars, concat, index, index_put, select, to_device

from test_torch_horizon_ranks import gloo  # noqa: F401  (fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOLVED = int(piqp_tpu_torch.Status.SOLVED)

# tests/test_zz_horizon.py:38-45; T = 68 over 4 chunks gives Qi = 16, so
# the chunk interiors factor by cyclic reduction (K2 on the card)
CASES = [
    dict(T=8, D=3, Da=2, ra=2, rg=2, seed=0),
    dict(T=16, D=4, Da=0, ra=2, rg=3, seed=1),
    dict(T=8, D=2, Da=1, ra=0, rg=2, seed=2),
    dict(T=68, D=3, Da=2, ra=2, rg=2, seed=3),
]


def _rand_vars(data, seed):
    """Random interior iterates of a B = 1 problem, as numpy arrays."""
    rng = np.random.default_rng(seed)

    def pos(mask):
        m = mask[0].numpy()
        return np.where(m, rng.uniform(0.5, 2.0, m.shape), 0.0)

    return dict(x=rng.standard_normal(data.n), y=rng.standard_normal(data.p),
                z_l=pos(data.hl_mask), z_u=pos(data.hu_mask),
                z_bl=pos(data.xl_mask), z_bu=pos(data.xu_mask),
                s_l=pos(data.hl_mask), s_u=pos(data.hu_mask),
                s_bl=pos(data.xl_mask), s_bu=pos(data.xu_mask))


def _leaves(tree):
    out, stack = [], [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, tuple):
            stack.extend(reversed(node))
        else:
            out.append(node)
    return out


def _calls():
    return dict(sharded_calls)


def _grew(before, what=("factor", "solve")) -> bool:
    return all(sharded_calls[k] > before[k] for k in what)


# (case, chunks, inverse): the short cases' interiors are sequential chains,
# where ``inverse`` changes nothing; T = 68 has cyclic-reduction interiors
# at both chunk counts (Qi = 16 and 33), in both representations
PARTITIONS = ([(c, k, True) for c in CASES[:3] for k in (2, 4)]
              + [(CASES[3], k, inv) for k in (2, 4) for inv in (True, False)])


@pytest.mark.parametrize("case,chunks,inverse", PARTITIONS,
                         ids=[f"T{c['T']}D{c['D']}-{k}-{'inv' if i else 'lib'}"
                              for c, k, i in PARTITIONS])
def test_factor_solve_match_jax_partition(case, chunks, inverse, gloo):  # noqa: F811
    """From the same scalings, the sharded factor and solve agree with the
    JAX package's chunked partition at C = chunks: the separator chain's
    factors and x always, every interior factor too when both keep the
    library representation (with ``inverse`` the port's cyclic-reduction
    levels also hold Lo^-1, which the JAX library route does not)."""
    assert tms._use_cr(case["T"] // chunks - 1) == (case["T"] == 68)
    t = tms.random_multistage_qp(**case, device="cpu")
    j = jms.random_multistage_qp(**case)
    sdata = shard_horizon(t, chunks=chunks)
    assert sdata.T == t.T  # these cases need no padding
    v = _rand_vars(t, case["seed"] + 50)

    jks = jkkt.compute_scalings(j, piqp_tpu.Settings(), JVars(**{k: jnp.asarray(a) for k, a in v.items()}),
                                1e-6, 1e-4, jnp.asarray(False), jops.P_diag(j))
    jfac, jok = jms._chunked_factor(*jms._assemble_blocks(j, jks), chunks, pallas=False)
    rhs = np.random.default_rng(10).standard_normal(t.n)
    js_, jg = jnp.asarray(rhs[:t.T * t.D]), jnp.asarray(rhs[t.T * t.D:])
    jxs, jxg = jms._chunked_solve(jfac, js_, jg, t.T, t.D, t.Da)
    jx = np.concatenate([np.asarray(jxs).reshape(-1), np.asarray(jxg)])

    tks = tkkt.compute_scalings(
        sdata, piqp_tpu_torch.Settings(), convert.vars_(types.SimpleNamespace(**v)),
        torch.full((1,), 1e-6, dtype=torch.float64), torch.full((1,), 1e-4, dtype=torch.float64),
        torch.zeros(1, dtype=torch.bool), tops.P_diag(sdata))
    before = _calls()
    tks, tok = tkkt.factor(sdata, tks, inverse=inverse)
    tx = tkkt.condensed_solve_x(sdata, tks, torch.as_tensor(rhs)[None])[0].numpy()
    assert _grew(before)
    assert bool(jok) and tok.tolist() == [True]
    np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-10)

    got, want = tks.factor, jfac
    pairs = list(zip(got[1:], want[1:]))
    if not inverse:
        pairs += list(zip(_leaves(got[0]), _leaves(want[0])))
    for a, b in pairs:
        b = np.asarray(b)
        assert a.shape[1:] == b.shape
        np.testing.assert_allclose(a[0].numpy(), b, rtol=1e-9, atol=1e-10)


def _jax_solve(case, **settings):
    return piqp_tpu.solve_prepared(jms.random_multistage_qp(**case), piqp_tpu.Settings(**settings))


@pytest.mark.parametrize("case", CASES[:2], ids=["T8D3", "T16D4"])
def test_full_solve_matches_jax_sequential(case, gloo):  # noqa: F811
    jres = _jax_solve(case)
    before = _calls()
    tres = solve_horizon_sharded(tms.random_multistage_qp(**case, device="cpu"), chunks=4)
    assert _grew(before)
    assert tres.info.status.tolist() == [int(jres.info.status)] == [SOLVED]
    np.testing.assert_allclose(tres.x[0].numpy(), np.asarray(jres.x), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tres.y[0].numpy(), np.asarray(jres.y), rtol=1e-6, atol=1e-7)


def test_padding_preserves_solution(gloo):  # noqa: F811
    """T = 5 over 4 chunks pads to T = 8 with the JAX package's identity
    stages; the original coordinates solve the unpadded problem and the
    padded stages come out 0."""
    case = dict(T=5, D=3, Da=2, ra=2, rg=2, seed=4)
    t = tms.random_multistage_qp(**case, device="cpu")
    tpad = pad_stages(t, 8)
    jpad = jpad_stages(jms.random_multistage_qp(**case), 8)
    for f in dataclasses.fields(tms.StageQPData):
        np.testing.assert_array_equal(getattr(tpad, f.name)[0].numpy(),
                                      np.asarray(getattr(jpad, f.name)), err_msg=f.name)
    sdata = shard_horizon(t, chunks=4)
    assert (sdata.T, sdata.chunks) == (8, 4)

    before = _calls()
    res = solve_horizon_sharded(t, chunks=4)
    assert _grew(before)
    seq = solve_batch(t, piqp_tpu_torch.Settings())
    assert res.info.status.tolist() == seq.info.status.tolist() == [SOLVED]
    T, D, Da = 5, 3, 2
    x = res.x[0].numpy()
    assert x.shape == (8 * D + Da,)
    np.testing.assert_allclose(np.concatenate([x[:T * D], x[8 * D:]]), seq.x[0].numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x[T * D:8 * D], 0.0, atol=1e-9)


def test_pad_false_raises_and_chunks_must_split_over_ranks(gloo):  # noqa: F811
    t = tms.random_multistage_qp(T=5, D=3, Da=2, ra=2, rg=2, seed=4, device="cpu")
    with pytest.raises(ValueError, match="not shardable"):
        shard_horizon(t, chunks=4, pad=False)
    with pytest.raises(ValueError, match="not shardable"):
        shard_horizon(tms.random_multistage_qp(T=6, D=3, seed=4, device="cpu"), chunks=4,
                      pad=False)
    with pytest.raises(ValueError, match="multiple"):
        shard_horizon(t, chunks=0)
    assert shard_horizon(t).chunks == 1  # the group's size
    assert shard_horizon(t).T == 5


def test_no_group_raises():
    import torch.distributed as dist

    assert not dist.is_initialized()
    t = tms.random_multistage_qp(T=8, D=3, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        solve_horizon_sharded(t, chunks=4)


def test_warm_restart_mpc_loop(gloo):  # noqa: F811
    """Solve, move c, warm re-solve: the same solution as a cold re-solve
    in no more iterations; a warm start in the unpadded layout raises."""
    t = tms.random_multistage_qp(T=8, D=3, Da=2, ra=2, rg=2, seed=11, device="cpu")
    res0 = solve_horizon_sharded(t, chunks=4)
    assert res0.info.status.tolist() == [SOLVED]
    bumped = dataclasses.replace(t, c=t.c * 1.02)
    cold = solve_horizon_sharded(bumped, chunks=4)
    before = _calls()
    warm = solve_horizon_sharded(bumped, chunks=4, warm=res0)
    assert _grew(before)
    assert warm.info.status.tolist() == [SOLVED]
    np.testing.assert_allclose(warm.x.numpy(), cold.x.numpy(), rtol=1e-6, atol=1e-7)
    assert int(warm.info.iter) <= int(cold.info.iter)

    short = BasicVars(x=res0.x[:, :-1], y=res0.y, z_l=res0.z_l, z_u=res0.z_u,
                      z_bl=res0.z_bl[:, :-1], z_bu=res0.z_bu[:, :-1])
    with pytest.raises(ValueError, match="padded stage layout"):
        solve_horizon_sharded(bumped, chunks=4, warm=short)


def test_mixed_precision_matches_jax(gloo):  # noqa: F811
    """Mixed precision on the cyclic-reduction interiors (T = 68, 4 chunks)
    takes the sharded registrations in both phases and reaches the JAX
    package's mixed solution."""
    case = CASES[3]
    jres = _jax_solve(case, mixed_precision=True)
    t = tms.random_multistage_qp(**case, device="cpu")
    before = _calls()
    res = solve_horizon_sharded(t, chunks=4, settings=piqp_tpu_torch.Settings(mixed_precision=True))
    assert _grew(before)
    assert res.info.status.tolist() == [int(jres.info.status)] == [SOLVED]
    np.testing.assert_allclose(res.x[0].numpy(), np.asarray(jres.x), atol=1e-4)


@pytest.mark.parametrize("mixed", [False, True])
def test_sharded_registrations_run_inside_the_solver(mixed, gloo):  # noqa: F811
    """Ruiz scaling and the float32 copy keep the sharded type, so the
    solver's factor and solve dispatch to the sharded registrations, with
    and without mixed precision; the sequential ones are not reached."""
    from piqp_tpu_torch import kkt, ruiz, solver

    sdata = shard_horizon(tms.random_multistage_qp(**CASES[0], device="cpu"), chunks=2)
    scaled, sc = ruiz.equilibrate(sdata)
    assert type(scaled) is ShardedStageQPData and scaled.chunks == 2
    pre = kkt.precompute(scaled, mixed)
    if mixed:
        assert type(pre["data32"]) is ShardedStageQPData
        assert pre["data32"].Pd.dtype == torch.float32
    seq = {t: kkt.factor.dispatch(t) for t in (tms.StageQPData, ShardedStageQPData)}
    assert seq[ShardedStageQPData] is not seq[tms.StageQPData]
    before = _calls()
    res = solver.solve_scaled(scaled, sc, piqp_tpu_torch.Settings(mixed_precision=mixed), True)
    assert _grew(before)
    assert res.info.status.tolist() == [SOLVED]


def test_tree_helpers_keep_group_and_chunks(gloo):  # noqa: F811
    base = concat([tms.random_multistage_qp(T=8, D=3, Da=2, ra=2, rg=2, seed=s, device="cpu")
                   for s in (0, 1)])
    sdata = shard_horizon(base, group=gloo, chunks=4)
    keep = (ShardedStageQPData, gloo, 4)

    def meta(d):
        return type(d), d.group, d.chunks

    one = index(sdata, slice(1, 2))
    assert meta(one) == keep and one.B == 1
    np.testing.assert_array_equal(one.Pd.numpy(), base.Pd[1:].numpy())
    both = concat([index(sdata, slice(0, 1)), one])
    assert meta(both) == keep
    np.testing.assert_array_equal(both.c.numpy(), base.c.numpy())
    moved = to_device(sdata, "cpu")
    assert meta(moved) == keep
    flipped = dataclasses.replace(sdata, c=sdata.c.flip(0))
    picked = select(torch.tensor([False, True]), flipped, sdata)
    assert meta(picked) == keep
    np.testing.assert_array_equal(picked.c.numpy(), base.c.numpy()[[0, 0]])
    put = index_put(sdata, torch.tensor([0]), one)
    assert meta(put) == keep
    np.testing.assert_array_equal(put.c.numpy(), base.c.numpy()[[1, 1]])


def test_matches_jax_solve_horizon_sharded_on_four_devices(gloo, tmp_path):  # noqa: F811
    """The one comparison with JAX's own sharded solve (a 4-device CPU
    mesh, shard_map collectives): in a child process, so that a jaxlib
    fault fails this test and cannot take down the test worker."""
    case = CASES[0]
    code = (
        "import json, sys, numpy as np, jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "jax.config.update('jax_compilation_cache_dir', sys.argv[1])\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)\n"
        "from jax.sharding import Mesh\n"
        "from piqp_tpu import multistage as ms\n"
        "from piqp_tpu.parallel import solve_horizon_sharded\n"
        f"d = ms.random_multistage_qp(**{case!r})\n"
        "mesh = Mesh(np.array(jax.devices()[:4]), axis_names=('sp',))\n"
        "r = solve_horizon_sharded(d, mesh)\n"
        "print(json.dumps(dict(status=int(r.info.status), iter=int(r.info.iter),"
        " x=np.asarray(r.x).tolist())))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=8").strip())
    out = subprocess.run([sys.executable, "-c", code, str(ROOT / "tests" / ".jax_cache")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])

    before = _calls()
    res = solve_horizon_sharded(tms.random_multistage_qp(**case, device="cpu"), chunks=4)
    assert _grew(before)
    assert res.info.status.tolist() == [want["status"]] == [SOLVED]
    assert res.info.iter.tolist() == [want["iter"]]
    np.testing.assert_allclose(res.x[0].numpy(), np.asarray(want["x"]), rtol=0, atol=1e-9)
