"""Host-clock round times of the port's multistage fleets on one CUDA card,
to compare trees of the port within one machine:

    python3 scripts/ms_rounds.py [--root DIR] [--repeats N]

It imports ``piqp_tpu_torch`` from DIR (default: this checkout), builds its
kernels, and times each round ``repeats`` times (3 by default) after a
warm-up on two problems: ``chip_smoke.py``'s multistage fleets in mixed
precision, phase 7's (256 problems of T = 100, D = 8, Da = ra = rg = 4,
seeds 4-259), phase 17's (128 of T = 41, D = 48, seeds 4000-4127) and
phase 18's (64 of T = 41, D = 144, seeds 5000-5063), cold and then warm
from the cold result after c += 1e-3 N(0, 1); and phase 14's
horizon-sharded solves at 4 chunks on a NCCL group of one rank: config 4
(T = 100, D = 8, seed 4) in float64, cold and warm after c *= 1.01, and
phase 7's fleet in mixed precision, cold and warm.  Prints one JSON line
a round: the tree, the ms of each repeat, their median, the iterations'
maximum and the card.  Exits nonzero without a
card or when a round leaves a problem unsolved.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ms_rounds: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch.distributed as dist

    from piqp_tpu_torch import Settings, multistage as ms, solve_batch, solve_horizon_sharded
    from piqp_tpu_torch import warm_from_result
    from piqp_tpu_torch.ops import _build
    from piqp_tpu_torch.types import index

    torch.cuda.set_device(0)
    _build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    tree = dict(root=Path(args.root).resolve().name, card=smi)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def rounds(label, solve, data, data_w, warm_of=warm_from_result):
        """``repeats`` cold rounds, then ``repeats`` warm ones from the
        last cold result, one JSON line each kind."""
        solve(index(data, slice(0, 2)), None)  # warm-up at this problem size
        cold = []
        for _ in range(args.repeats):
            res, ms_ = timed(lambda: solve(data, None))
            cold.append((res, ms_))
        warm_pt = warm_of(cold[-1][0])
        warm = [timed(lambda: solve(data_w, warm_pt)) for _ in range(args.repeats)]
        for kind, runs in (("cold", cold), ("warm", warm)):
            status = torch.cat([r.info.status.reshape(-1) for r, _ in runs])
            if not bool((status == 1).all()):
                raise AssertionError(f"{label} {kind}: a problem was not solved")
            times = [round(t, 1) for _, t in runs]
            print(json.dumps(dict(tree, round=f"{label} {kind}", ms=times,
                                  median_ms=float(np.median(times)),
                                  iter_max=int(max(r.info.iter.max() for r, _ in runs)))),
                  flush=True)

    mixed, f64 = Settings(mixed_precision=True), Settings()

    def fleet(T, D, seed0, B, noise_seed):
        data = ms.random_multistage_batch([seed0 + i for i in range(B)], T=T, D=D, Da=4, ra=4,
                                          rg=4, device="cuda")
        dc = np.random.default_rng(noise_seed).standard_normal((B, data.n)) * 1e-3
        return data, dataclasses.replace(data, c=data.c + torch.as_tensor(dc, device="cuda"))

    def batch(settings):
        return lambda d, w: solve_batch(d, settings, warm=w)

    d7, d7w = fleet(100, 8, 4, 256, 2025)
    rounds("phase 7 fleet", batch(mixed), d7, d7w)
    rounds("phase 17 fleet", batch(mixed), *fleet(41, 48, 4000, 128, 2027))
    rounds("phase 18 fleet", batch(mixed), *fleet(41, 144, 5000, 64, 2028))

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "store"),
                                rank=0, world_size=1)
        try:
            dist.all_reduce(torch.zeros(1, device="cuda"))

            def sharded(settings):
                return lambda d, w: solve_horizon_sharded(d, chunks=4, settings=settings,
                                                          warm=w)

            base = ms.random_multistage_qp(T=100, D=8, Da=4, ra=4, rg=4, seed=4, device="cuda")
            moved = dataclasses.replace(base, c=base.c * 1.01)
            rounds("phase 14 config 4 float64", sharded(f64), base, moved, lambda r: r)
            rounds("phase 14 fleet", sharded(mixed), d7, d7w, lambda r: r)
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
