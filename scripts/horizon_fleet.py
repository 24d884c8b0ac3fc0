"""Iterations and accuracy of chip_smoke.py's multistage fleet (phase 7's
256 problems of BASELINE config 4's shape: T = 100, D = 8, Da = 4, ra = 4,
rg = 4, seeds 4-259) solved sequentially and horizon-sharded at 4 chunks,
on one device:

    python3 scripts/horizon_fleet.py cpu|cuda [B]

It solves the fleet (the first B problems, 256 by default) sequentially in
float64, sequentially with ``mixed_precision``, and through
``solve_horizon_sharded(chunks=4)`` with ``mixed_precision`` on a process
group of one rank (gloo on the CPU, NCCL on the card), and prints one JSON
line per solve: iterations (max, median, the five slowest problems, and
every problem's) and each mixed solve's largest |x - x_float64| with its
problem.  On ``cuda``
it then solves the sharded solve's three slowest problems alone (B = 1)
with ``mixed_precision`` six ways, one JSON line each: sharded and
sequential on the card, the same two with K2 (``cholesky_inverse_apply``)
replaced by its plain version on the card, and sharded and sequential on
the CPU.  It exits nonzero if a solve is not SOLVED.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from contextlib import contextmanager
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

DIMS = dict(T=100, D=8, Da=4, ra=4, rg=4)
FIRST_SEED = 4


@contextmanager
def _plain_k2():
    """The multistage factor's K2 launches replaced by the plain version."""
    from piqp_tpu_torch import multistage
    from piqp_tpu_torch.ops import chol_inv

    kernel = multistage.cholesky_inverse_apply
    multistage.cholesky_inverse_apply = chol_inv.chol_inv_apply_reference
    try:
        yield
    finally:
        multistage.cholesky_inverse_apply = kernel


def _summary(label, res, x64=None, problems=None) -> dict:
    it = res.info.iter.cpu().numpy()
    status = res.info.status.cpu().numpy()
    out = dict(solve=label, solved=int((status == 1).sum()), B=int(it.size),
               iter_max=int(it.max()), iter_median=float(np.median(it)),
               slowest={int(i): int(it[i]) for i in np.argsort(-it, kind="stable")[:5]},
               iters=it.tolist())
    if problems is not None:
        out = dict(out, problems=problems)
    if x64 is not None:
        dx = (res.x.double().cpu() - x64).abs().amax(dim=-1).numpy()
        out.update(dx_f64_max=float(dx.max()), dx_f64_problem=int(dx.argmax()))
    print(json.dumps(out), flush=True)
    if out["solved"] != out["B"]:
        raise SystemExit(f"{label}: {out['B'] - out['solved']} problems not SOLVED")
    return out


def main() -> int:
    import torch
    import torch.distributed as dist

    from piqp_tpu_torch import Settings, multistage, solve_batch, solve_horizon_sharded
    from piqp_tpu_torch.types import index, to_device

    dev = sys.argv[1] if len(sys.argv) > 1 else "cpu"
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    if dev == "cuda" and not torch.cuda.is_available():
        print("horizon_fleet: no CUDA device available", file=sys.stderr)
        return 2
    f64, mixed = Settings(), Settings(mixed_precision=True)
    data = multistage.random_multistage_batch(range(FIRST_SEED, FIRST_SEED + B), **DIMS,
                                              device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                                init_method=f"file://{os.path.join(tmp, 'store')}",
                                rank=0, world_size=1)
        try:
            gloo = dist.new_group(backend="gloo") if dev == "cuda" else None
            r64 = solve_batch(data, f64)
            x64 = r64.x.double().cpu()
            _summary(f"{dev} sequential float64", r64)
            _summary(f"{dev} sequential mixed", solve_batch(data, mixed), x64)
            sharded = _summary(f"{dev} sharded mixed, 4 chunks",
                               solve_horizon_sharded(data, chunks=4, settings=mixed), x64)
            if dev == "cuda":
                with _plain_k2():
                    _summary("cuda sharded mixed, 4 chunks, plain K2",
                             solve_horizon_sharded(data, chunks=4, settings=mixed), x64)
                for i in list(sharded["slowest"])[:3]:
                    one = index(data, slice(i, i + 1))
                    one_cpu = to_device(one, "cpu")
                    ref = x64[i:i + 1]
                    _summary("cuda sharded", solve_horizon_sharded(
                        one, chunks=4, settings=mixed), ref, [i])
                    _summary("cuda sequential", solve_batch(one, mixed), ref, [i])
                    with _plain_k2():
                        _summary("cuda sharded, plain K2", solve_horizon_sharded(
                            one, chunks=4, settings=mixed), ref, [i])
                        _summary("cuda sequential, plain K2", solve_batch(one, mixed), ref, [i])
                    _summary("cpu sharded", solve_horizon_sharded(
                        one_cpu, group=gloo, chunks=4, settings=mixed), ref, [i])
                    _summary("cpu sequential", solve_batch(one_cpu, mixed), ref, [i])
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
