"""Phase 14's multi-rank part of chip_smoke.py alone, on one CUDA card:

    python3 scripts/horizon_ranks.py

Builds the port's kernels, runs the horizon-sharded runs of
``chip_smoke._hz_runs`` (BASELINE config 4 at 4 chunks, float64 and mixed,
cold and warm; the phase-17 fleet, 128 problems at T = 41 and D = 48,
float64 cold) on a NCCL group of one rank, checks them on the host, then
runs them again on 2 and 4 gloo ranks spawned on the same card and holds
every rank to the one-rank runs (``chip_smoke._hz_ranks_phase``: identical
x on every rank, float64 iterations and x, mixed status, KKT and x, each
rank's exact share of the stage-block bytes, K2's small kernel in every
config-4 run, the fleet's peak memory falling with the group's size).
Prints each rank's stage-block bytes, peak memory, host-clock round time
and collectives.  Exits nonzero without a card or on any failure.  The
ranks share one card: no speed-up across GPUs is shown.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("horizon_ranks: no CUDA device available", file=sys.stderr)
        return 2
    import torch.distributed as dist

    import chip_smoke as cs
    from piqp_tpu_torch.ops import _build

    smi = cs._smi()
    print(f"[device] {smi}")
    print(f"[device] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] nvcc {_build.BuildInfo.seconds:.2f} s (load incl. "
          f"{time.perf_counter() - t0:.2f} s)")
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
                                rank=0, world_size=1)
        try:
            ref = cs._hz_runs(torch, dist.group.WORLD)
            cs._hz_check_reference(ref, smi)
        finally:
            dist.destroy_process_group()
    print(f"[horizon ranks] one rank: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k2 = cs._hz_ranks_phase(torch, smi, ref)
    print(f"[horizon ranks] K2 launches by dtype per rank in the config-4 runs {k2}; "
          f"2 and 4 ranks: {time.perf_counter() - t0:.1f} s")
    print(f"[device] {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
