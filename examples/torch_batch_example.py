"""Batched scenario solving with the PyTorch/CUDA port: a fleet of
perturbed QPs solved as one batch, a warm round after a small data move,
and straggler compaction; split over the ranks of a torch.distributed
process group when one is initialised (the scenario-MPC / portfolio-sweep
usage pattern; examples/batch_example.py with JAX).

Run: python examples/torch_batch_example.py [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch
import torch.distributed as dist

from piqp_tpu_torch import (
    Settings,
    prepare_batch,
    solve_batch,
    solve_batch_compact,
    warm_from_result,
)
from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

B = 64


def scenarios(seed: int, scale: float = 0.1) -> list:
    """B copies of one QP with the linear cost moved by scale * N(0, 1)."""
    base = dense_strongly_convex_qp(32, 8, 16, seed=0)
    rng = np.random.default_rng(seed)
    return [dict(base, c=base["c"] + scale * rng.standard_normal(base["c"].shape))
            for _ in range(B)]


def main(device=None) -> dict:
    """Cold batch, warm round, compaction (and the batch over the default
    process group's ranks when there is one).  Returns the statuses and
    iterations of each, on the host."""
    problems = scenarios(seed=1)
    data = prepare_batch(problems, device=device)
    settings = Settings()

    res = solve_batch(data, settings)
    status = res.info.status.cpu().numpy()
    iters = res.info.iter.cpu().numpy()
    objs = res.info.primal_obj.cpu().numpy()
    print(f"{int((status == 1).sum())}/{B} solved on {data.P.device}; "
          f"iters: mean {iters.mean():.1f} max {iters.max()}")
    print(f"objective spread: [{objs.min():.4f}, {objs.max():.4f}]")
    assert (status == 1).all(), status

    # the next control step: costs move a little, warm-started from the
    # previous iterates
    moved = [dict(p, c=p["c"] + 1e-3 * np.random.default_rng(i).standard_normal(32))
             for i, p in enumerate(problems)]
    data_w = prepare_batch(moved, device=device)
    warm = solve_batch(data_w, settings, warm=warm_from_result(res))
    warm_status = warm.info.status.cpu().numpy()
    warm_iters = warm.info.iter.cpu().numpy()
    print(f"warm round: {int((warm_status == 1).sum())}/{B} solved, iters mean "
          f"{warm_iters.mean():.1f} max {warm_iters.max()}")
    assert (warm_status == 1).all(), warm_status

    # lockstep batches pay the max iteration count; two-phase straggler
    # compaction removes the waste at identical tolerances
    depth = int(np.median(iters)) + 1
    res_c = solve_batch_compact(data, settings, phase1_iters=depth)
    compact_status = res_c.info.status.cpu().numpy()
    assert np.array_equal(compact_status, status)
    print(f"compacted: {int((compact_status == 1).sum())}/{B} solved, same "
          f"tolerances, max lockstep depth {depth} instead of {iters.max()}")

    out = dict(status=status, iters=iters, x=res.x.cpu().numpy(),
               warm_status=warm_status, warm_iters=warm_iters,
               compact_status=compact_status,
               compact_iters=res_c.info.iter.cpu().numpy())
    if dist.is_available() and dist.is_initialized():
        # every rank passes the whole batch, solves B/world problems and
        # gets the whole result back
        res_s = solve_batch(data, settings, sharding=dist.group.WORLD)
        out["sharded_status"] = res_s.info.status.cpu().numpy()
        print(f"over {dist.get_world_size()} rank(s): "
              f"{int((out['sharded_status'] == 1).sum())}/{B} solved")
        assert (out["sharded_status"] == 1).all()
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; pass cpu without a GPU)")
    main(parser.parse_args().device)
