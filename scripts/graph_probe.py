"""The IPM loop graphed (``solve_scaled``, ``graphs.py``) against the same
loop launched from Python (``solver._solve_eager``) on the CUDA device:

    python3 scripts/graph_probe.py [--batch B] [--n N] [--rounds K] [--cases ...]

For each case, a fleet of B ``dense_strongly_convex_qp(n, n/2, n/2)``
problems: a cold solve, then K warm re-solves with costs moved by 1e-3
N(0, 1), first eager, then graphed twice (the first pass captures, the
second replays only).  One JSON line a case: whether status, iterations
and x are bitwise equal on both passes, K1's launches by dtype on each
side, host ms of the cold solve and the median warm round on each side
(Ruiz, the solve and x on the host), the graphs the entry holds, and the
device's peak memory on each side.  Cases: ``mixed`` (the benchmark's
settings), ``float64``, ``library`` (``pallas_kernels=False``: library
factorizations), ``gondzio`` (two centrality correctors) and ``n``
values after a colon (``mixed:200``, the cluster route; ``mixed:300``,
the library route above the kernels)."""

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from piqp_tpu_torch import Settings, graphs, prepare_batch, ruiz, solver  # noqa: E402
from piqp_tpu_torch.api import _warm_vars, has_cone  # noqa: E402
from piqp_tpu_torch.ops import _build, chol_inv  # noqa: E402
from piqp_tpu_torch.utils.random import dense_strongly_convex_qp  # noqa: E402

SETTINGS = {
    "mixed": Settings(mixed_precision=True),
    "float64": Settings(),
    "library": Settings(mixed_precision=True, pallas_kernels=False),
    "gondzio": Settings(mixed_precision=True, centrality_correctors=2),
}


def _rounds(solve, data, settings, costs):
    out, times, warm = [], [], None
    for c in costs:
        torch.cuda.synchronize()
        t = time.perf_counter()
        sdata, sc = ruiz.equilibrate(dataclasses.replace(data, c=c),
                                     max_iter=settings.preconditioner_iter)
        warm = solve(sdata, sc, settings, has_cone(sdata), _warm_vars(warm))
        x = warm.x.cpu()
        times.append(1e3 * (time.perf_counter() - t))
        out.append((warm.info.status.cpu(), warm.info.iter.cpu(), x))
    return out, times


def _same(a, b) -> bool:
    return all(torch.equal(p, q) for ra, rb in zip(a, b) for p, q in zip(ra, rb))


def case(name, batch, n, rounds):
    base, _, size = name.partition(":")
    n = int(size) if size else n
    settings = SETTINGS[base]
    probs = [dense_strongly_convex_qp(n, n // 2, n // 2, seed=i) for i in range(batch)]
    data = prepare_batch(probs, device="cuda")
    rng = np.random.default_rng(1)
    costs = [data.c] + [data.c + torch.as_tensor(1e-3 * rng.standard_normal(
        tuple(data.c.shape)), device="cuda") for _ in range(rounds)]
    out = dict(case=name, batch=batch, n=n, engages=graphs.engages(data, settings))
    sides = {}
    for side, solve in (("eager", solver._solve_eager), ("graphed", solver.solve_scaled),
                        ("replayed", solver.solve_scaled)):
        torch.cuda.reset_peak_memory_stats()
        before = dict(chol_inv.launches_by_dtype)
        try:
            res, times = _rounds(solve, data, settings, costs)
        except Exception as e:  # a capture the runtime refuses: report it, go on
            out[side] = f"{type(e).__name__}: {str(e)[:300]}"
            torch.cuda.synchronize()
            continue
        sides[side] = res
        out[side] = dict(
            cold_ms=times[0], warm_ms=statistics.median(times[1:]),
            iters=[int(r[1].max()) for r in res],
            solved=int(sum((r[0] == 1).sum() for r in res)),
            k1={k: chol_inv.launches_by_dtype[k] - before[k] for k in before},
            memory_peak_bytes=torch.cuda.max_memory_allocated())
    for side in ("graphed", "replayed"):
        if side in sides and "eager" in sides:
            out[f"{side}_bitwise"] = _same(sides["eager"], sides[side])
    out["entries"] = len(graphs.CACHE)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--cases", nargs="+", default=["mixed"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("graph_probe: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    for name in args.cases:
        print(json.dumps(dict(case(name, args.batch, args.n, args.rounds), card=card.strip())),
              flush=True)


if __name__ == "__main__":
    main()
