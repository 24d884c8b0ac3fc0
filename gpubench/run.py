"""The benchmark's one command:

    python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  It runs the cell NAME of ``BENCHMARK.json``
on the CUDA device: set-up (import, the kernel library, the problems
from the seed, one warm-up round), then rounds for S seconds, then the
check against the plain reference.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` the per-layer metrics and ``breakdown``,
without it the end-to-end ones; ``check`` last, each number compared with
its limit), and the numbers compared are the last lines of standard
error.  Without a CUDA device it exits with 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from gpubench import harness

    chips = harness.load_cell(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result, numbers = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    sys.stdout.flush()
    for k, (value, limit) in numbers.items():
        print(f"check {k} {float(value)!r} limit {float(limit)!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
