"""Device memory and host time of the port's batched dense solve at a few
fleet sizes, for the checkout at ``--root``:

    python3 scripts/fleet_memory.py [--root DIR] [--batches 1024 16384]
        [--rounds K] [--compact K]

For each B, the 1024 problems ``dense_strongly_convex_qp(128, 64, 64,
seed=i)`` tiled on the device to B, with ``Settings(mixed_precision=True)``
(the benchmark's dense128 fleet): a cold ``solve_batch``, then K warm
re-solves with costs moved by 1e-3 N(0, 1).  Then, at the first B, K
calls of ``solve_batch_compact`` (phase 1 of 4 iterations) on the moved
fleet from the cold result: each call's second pass solves the
stragglers, a batch size of its own.  One JSON line a fleet: the data's
bytes, the device's free memory before, the growth of the allocated and
of the reserved peak over what was allocated and reserved before, host
ms of the cold solve and of each warm round (x on the host), the solved
count, the largest iteration count a round, and the CUDA graph cache's
entries where the checkout has one; a fleet that runs out of device
memory reports that and the next goes on."""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]


def _tile(data, batch):
    reps = -(-batch // data.B)

    def tile(t):
        return t.repeat(reps, *([1] * (t.dim() - 1)))[:batch].contiguous()

    return dataclasses.replace(data, **{f.name: tile(getattr(data, f.name))
                                        for f in dataclasses.fields(data)})


def _graph_entries():
    try:
        from piqp_tpu_torch import graphs
    except ImportError:
        return None
    return len(graphs.CACHE)


def _measure(fn):
    """fn() with the device's memory around it: (result, seconds, fields)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    free = torch.cuda.mem_get_info()[0]
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    return out, secs, dict(
        free_before_bytes=free,
        peak_allocated_growth_bytes=torch.cuda.max_memory_allocated() - alloc,
        peak_reserved_growth_bytes=torch.cuda.max_memory_reserved() - reserved)


def fleet(batch, rounds, base, settings, compact):
    from piqp_tpu_torch import solve_batch, solve_batch_compact, warm_from_result

    data = _tile(base, batch)
    nbytes = sum(getattr(data, f.name).nbytes for f in dataclasses.fields(data))
    rng = np.random.default_rng(batch)
    moved = [dataclasses.replace(data, c=data.c + torch.as_tensor(
        1e-3 * rng.standard_normal(tuple(data.c.shape)), device=data.c.device))
        for _ in range(max(rounds, 1))]

    def rounds_():
        res = solve_batch(data, settings)
        res.x.cpu()
        out, times = [res], []
        for d in moved[:rounds]:
            t = time.perf_counter()
            res = solve_batch(d, settings, warm=warm_from_result(res))
            res.x.cpu()
            times.append(1e3 * (time.perf_counter() - t))
            out.append(res)
        return out, times

    (results, warm_ms), secs, mem = _measure(rounds_)
    line = dict(batch=batch, data_bytes=nbytes, **mem, total_ms=1e3 * secs,
                warm_ms=warm_ms, cold_ms=1e3 * secs - sum(warm_ms),
                solved=[int((r.info.status == 1).sum()) for r in results],
                iters=[int(r.info.iter.max()) for r in results],
                graph_entries=_graph_entries())
    if compact:
        calls = []
        for _ in range(compact):
            res, secs, mem = _measure(lambda: solve_batch_compact(
                moved[0], settings, warm=results[0], phase1_iters=4))
            calls.append(dict(ms=1e3 * secs, **mem,
                              stragglers=int((res.info.iter > 4).sum()),
                              solved=int((res.info.status == 1).sum()),
                              graph_entries=_graph_entries()))
        line["compact"] = calls
    return line


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--batches", type=int, nargs="+", default=[1024, 16384])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--compact", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fleet_memory: needs a CUDA device")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import piqp_tpu_torch
    from piqp_tpu_torch import Settings, prepare_batch
    from piqp_tpu_torch.ops import _build
    from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

    assert Path(piqp_tpu_torch.__file__).resolve().is_relative_to(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    settings = Settings(mixed_precision=True)
    base = prepare_batch([dense_strongly_convex_qp(128, 64, 64, seed=i) for i in range(1024)],
                         device="cuda")
    for i, batch in enumerate(args.batches):
        try:
            line = fleet(batch, args.rounds, base, settings, args.compact if i == 0 else 0)
        except torch.cuda.OutOfMemoryError as e:
            line = dict(batch=batch, out_of_memory=str(e)[:300])
            torch.cuda.empty_cache()
        print(json.dumps(dict(line, root=str(root.relative_to(HERE)) or ".",
                              card=card.strip())), flush=True)


if __name__ == "__main__":
    main()
