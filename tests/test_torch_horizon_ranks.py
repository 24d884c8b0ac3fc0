"""The port's sharded solves across processes: gloo process groups of 2 and
4 spawned CPU ranks.

- ``solve_horizon_sharded`` on the T = 68 case with 4 chunks in all (2
  ranks x 2 chunks, 4 ranks x 1 chunk) against the one-rank 4-chunk run:
  every rank holds only its T/world stages of the nine block fields (Pc
  and the flat vectors whole), every rank's x identical to the others',
  iterations equal, x within 1e-12 of the one-rank run, and a mixed
  solve in the same processes within 1e-4 of the one-rank mixed run; the
  end-of-solve check raises on every rank when one rank reports other
  iterations;
- ``solve_batch(sharding=group)`` on 2 ranks, 8 dense problems (cold, and
  warm after moving c, the warm start split with the batch) and a stacked
  stage fleet of 4, against the unsharded solve: status and iterations
  equal, x within 1e-12; a batch of 3 raises on 2 ranks.

The spawned ranks import this module, so its top level imports only
torch, numpy, pytest and the port (never JAX).  Each rank writes its
result to an .npz file under the test's tmp_path; the ranks meet through a
FileStore there, never a fixed port.  The one-rank reference runs in the
test process on a gloo group of one (``gloo_group``, which
``test_torch_horizon.py`` and ``test_torch_utils.py`` use too).
"""

import contextlib
import dataclasses
import pathlib
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from piqp_tpu_torch import Settings, prepare_batch, solve_batch, solve_horizon_sharded
from piqp_tpu_torch import multistage as tms
from piqp_tpu_torch.types import index
from piqp_tpu_torch.parallel import horizon
from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

T68 = dict(T=68, D=3, Da=2, ra=2, rg=2, seed=3)
DENSE = [dict(dim=12, n_eq=4, n_ineq=6, seed=200 + i) for i in range(8)]
FLEET = dict(seeds=[30, 31, 32, 33], T=8, D=3, Da=2, ra=2, rg=2)
SPAWN_TIMEOUT_S = 180
FIELDS = [f.name for f in dataclasses.fields(tms.StageQPData)]


@contextlib.contextmanager
def gloo_group(store: pathlib.Path, rank: int = 0, world: int = 1):
    """The default process group on gloo, met through a FileStore at
    ``store``, destroyed on exit."""
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.fixture
def gloo(tmp_path):
    with gloo_group(tmp_path / "gloo_store") as group:
        yield group


def _horizon_rank(rank, world, store, out, chunks):
    torch.set_num_threads(1)
    with gloo_group(store, rank, world):
        before = horizon.sharded_calls["factor"]
        sdata = horizon.shard_horizon(tms.random_multistage_qp(**T68, device="cpu"),
                                      chunks=chunks)
        res = solve_horizon_sharded(sdata)
        mixed = solve_horizon_sharded(sdata, settings=Settings(mixed_precision=True))
        # a rank that ended elsewhere is caught by the end-of-solve check
        off = dataclasses.replace(res, info=dataclasses.replace(
            res.info, iter=res.info.iter + (rank == world - 1)))
        try:
            horizon._check_ranks_agree(off, None)
            disagreement_raised = False
        except RuntimeError:
            disagreement_raised = True
        np.savez(out / f"rank{rank}.npz", x=res.x.numpy(), iter=res.info.iter.numpy(),
                 status=res.info.status.numpy(),
                 factors=horizon.sharded_calls["factor"] - before,
                 disagreement_raised=disagreement_raised,
                 mixed_x=mixed.x.numpy(), mixed_status=mixed.info.status.numpy(),
                 stages=np.array(sdata.stages), horizon=sdata.T,
                 **{f"shape_{k}": np.array(getattr(sdata, k).shape) for k in FIELDS})


def _batch_rank(rank, world, store, out):
    torch.set_num_threads(1)
    dense = prepare_batch([dense_strongly_convex_qp(**kw) for kw in DENSE], device="cpu")
    fleet = tms.random_multistage_batch(**FLEET, device="cpu")
    with gloo_group(store, rank, world) as group:
        rd = solve_batch(dense, Settings(), sharding=group)
        rw = solve_batch(_moved(dense), Settings(), sharding=group, warm=rd)
        rs = solve_batch(fleet, Settings(), sharding=group)
        try:
            solve_batch(index(dense, slice(0, 3)), Settings(), sharding=group)
            odd_raised = False
        except ValueError:
            odd_raised = True
    np.savez(out / f"rank{rank}.npz", dense_x=rd.x.numpy(), dense_iter=rd.info.iter.numpy(),
             dense_status=rd.info.status.numpy(), warm_x=rw.x.numpy(),
             warm_iter=rw.info.iter.numpy(), warm_status=rw.info.status.numpy(),
             stage_x=rs.x.numpy(),
             stage_iter=rs.info.iter.numpy(), stage_status=rs.info.status.numpy(),
             odd_raised=odd_raised)


def _moved(data):
    """The data with c moved, for a warm re-solve."""
    return dataclasses.replace(data, c=data.c * 1.01)


def _spawn(fn, world, tmp_path, *args) -> list:
    """Run ``fn(rank, world, store, out, *args)`` on ``world`` spawned ranks
    and return each rank's .npz contents."""
    out = tmp_path / "ranks"
    out.mkdir()
    ctx = mp.start_processes(fn, args=(world, tmp_path / "rank_store", out) + args,
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_horizon_ranks_match_one_rank(world, tmp_path, gloo):
    """Also: each rank holds only its T/world stages of the nine block
    fields, and Pc and the flat vectors whole; its mixed-precision solve
    reaches the one-rank mixed solution (same status, x within 1e-4, the
    tests' mixed tolerance, ROADMAP Queue 3)."""
    base = tms.random_multistage_qp(**T68, device="cpu")
    ref = solve_horizon_sharded(base, chunks=4)
    ref_mixed = solve_horizon_sharded(base, chunks=4, settings=Settings(mixed_precision=True))
    assert ref.info.status.tolist() == ref_mixed.info.status.tolist() == [1]
    ranks = _spawn(_horizon_rank, world, tmp_path, 4)
    per = T68["T"] // world
    for r, got in enumerate(ranks):
        assert got["factors"] > 0, f"rank {r} ran no sharded factor"
        assert bool(got["disagreement_raised"]), f"rank {r} missed a disagreeing rank"
        np.testing.assert_array_equal(got["x"], ranks[0]["x"], err_msg=f"rank {r}")
        assert got["status"].tolist() == [1]
        assert got["iter"].tolist() == ref.info.iter.tolist()
        np.testing.assert_allclose(got["x"], ref.x.numpy(), rtol=0, atol=1e-12)

        assert got["stages"].tolist() == [r * per, (r + 1) * per] and int(got["horizon"]) == 68
        for k in FIELDS:
            shape = tuple(got[f"shape_{k}"].tolist())
            whole = tuple(getattr(base, k).shape)
            if k in tms.STAGE_BLOCKS:
                assert shape == (whole[0], per) + whole[2:], f"rank {r} {k} {shape}"
            else:
                assert shape == whole, f"rank {r} {k} {shape}"

        assert got["mixed_status"].tolist() == [1]
        np.testing.assert_array_equal(got["mixed_x"], ranks[0]["mixed_x"], err_msg=f"rank {r}")
        np.testing.assert_allclose(got["mixed_x"], ref_mixed.x.numpy(), rtol=0, atol=1e-4)


def test_solve_batch_sharding_matches_unsharded(tmp_path):
    dense = prepare_batch([dense_strongly_convex_qp(**kw) for kw in DENSE], device="cpu")
    fleet = tms.random_multistage_batch(**FLEET, device="cpu")
    want = {"dense": solve_batch(dense, Settings()), "stage": solve_batch(fleet, Settings())}
    want["warm"] = solve_batch(_moved(dense), Settings(), warm=want["dense"])
    for got in _spawn(_batch_rank, 2, tmp_path):
        assert bool(got["odd_raised"]), "a batch of 3 over 2 ranks did not raise"
        for name, ref in want.items():
            assert got[f"{name}_status"].tolist() == ref.info.status.tolist() == \
                [1] * ref.info.status.shape[0]
            assert got[f"{name}_iter"].tolist() == ref.info.iter.tolist()
            np.testing.assert_allclose(got[f"{name}_x"], ref.x.numpy(), rtol=0, atol=1e-12)


def test_solve_batch_sharding_on_one_rank_is_the_plain_solve(gloo):
    dense = prepare_batch([dense_strongly_convex_qp(**kw) for kw in DENSE[:3]], device="cpu")
    got = solve_batch(dense, Settings(), sharding=gloo)
    want = solve_batch(dense, Settings())
    np.testing.assert_array_equal(got.x.numpy(), want.x.numpy())
    assert got.info.iter.tolist() == want.info.iter.tolist()
