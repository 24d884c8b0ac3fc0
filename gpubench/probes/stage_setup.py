"""Set-up of a stage-structured configuration on the card, through the
harness: the test-only configuration of ``tests/stage_parts.py`` (it
stands for no deployment) at a given shape on the ``warm`` traffic, run
as one cell of a temporary copy of ``BENCHMARK.json``.

    python3 gpubench/probes/stage_setup.py --seed N --seconds S [--trace 0|1]
        [--T 41 --D 24 --Da 4 --ra 4 --rg 4 --batch 256]

from the root of a checkout; one process a run, as the benchmark runs
its cells.  Prints the result's line (``setup_s`` among its metrics, its
parts in ``setup_parts``: seconds since process start at the end of the
import, the problems and the mix's set-up) as the last line of standard
output.  Without a CUDA device it exits with 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    for k, v in dict(T=41, D=24, Da=4, ra=4, rg=4, batch=256, block=64).items():
        ap.add_argument(f"--{k}", type=int, default=v)
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from gpubench import harness
    from gpubench.tests import stage_parts

    if not torch.cuda.is_available():
        print("stage_setup: needs a CUDA device", file=sys.stderr)
        return 2
    stage_parts.register(lambda d, k, v: d.__setitem__(k, v))
    cfg = stage_parts.config(T=args.T, D=args.D, Da=args.Da, ra=args.ra, rg=args.rg,
                             batch=args.batch, problems=args.batch, block=args.block)
    with tempfile.TemporaryDirectory() as folder:
        bench = stage_parts.write_bench(Path(folder), harness.ROOT / "BENCHMARK.json", cfg)
        result, numbers = harness.run(stage_parts.CELL, args.seed, args.seconds,
                                      bool(args.trace), T0, bench_file=bench)
    for k, (value, limit) in numbers.items():
        print(f"check {k} {float(value)!r} limit {float(limit)!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
