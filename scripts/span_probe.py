"""Readings of the program's spans (``piqp.*``, ``utils/profiling.py``)
that the benchmark's metrics do not make, for one cell of
``BENCHMARK.json`` on the CUDA device:

    python3 scripts/span_probe.py --workload dense128.warm --seed N
        [--root DIR] [--rounds K] [--loop N]

``--root`` names the checkout whose program and benchmark run (default:
this one), e.g. a parent commit unpacked with ``git archive`` into
``build/ab/parent``; the span metrics of *this* checkout's
``gpubench/metrics`` read the trace, so a program without the spans reads
None.  After the harness's set-up (``gpubench/harness.py``: the kernel
library, the pool, the warm-up rounds), K untraced rounds, K rounds under
``torch.profiler`` and K untraced rounds again, each timed on the host
clock as the harness times a round.  One JSON line:

- ``round_ms_off`` / ``round_ms_on``: host ms of the untraced / traced
  rounds (the tracing's cost on a round);
- ``metrics``: this checkout's span metrics on the traced rounds;
- ``idle_by_layer`` / ``host_by_layer``: ms a round of the device's idle
  time / the host's time under each innermost ``piqp.*`` span (a span's
  own time, not its children's), ``none`` outside every span, and
  ``uncovered``: ``none``'s share of the idle time;
- ``spans_per_round``: ``piqp.*`` spans a traced round opens;
- ``launches``: launch calls in the window by name, kernels in the window,
  and the kernels whose launch call the trace lacks (by correlation id);
- ``syncs``: sync calls and ``aten::_local_scalar_dense`` (the copy that
  ``bool()`` of a CUDA tensor makes) inside trips, outside them, and per
  trip;
- ``off_us_per_span``: µs a ``with annotate(...)`` costs with no profiler
  recording, over a loop of N less the empty loop;
- ``device``: the card's name and power limit.
"""

import argparse
import collections
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
HERE = Path(__file__).resolve().parents[1]
SPAN_METRICS = ("ipm_idle_ms.warm", "syncs_per_iter.warm", "launches_per_iter.warm",
                "kkt_factor_ms.warm", "kkt_solve_ms.warm", "ruiz_ms.warm",
                "entry_canonical_ms.cold", "entry_copy_ms.cold")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
SCALAR = "aten::_local_scalar_dense"
TRIP = "piqp.ipm.iter"


def _reader(name):
    path = HERE / "gpubench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"probe_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def segments(spans, lo, hi):
    """[(a, b, name)] covering [lo, hi): the innermost of the nested
    ``spans`` (name, start, end) over each piece, None outside them all."""
    out, stack, pos = [], [], lo

    def close_until(t):
        nonlocal pos
        while stack and stack[-1][1] <= t:
            name, end = stack.pop()
            if end > pos:
                out.append((pos, end, name))
                pos = end

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        close_until(s)
        if s > pos:
            out.append((pos, s, stack[-1][0] if stack else None))
            pos = s
        stack.append((name, e))
    close_until(hi)
    if hi > pos:
        out.append((pos, hi, None))
    return out


def by_label(segs, intervals=None):
    """ns under each label: of the segments' length, or of their overlap
    with the sorted, disjoint ``intervals``."""
    total = collections.Counter()
    j = 0
    for a, b, name in segs:
        if intervals is None:
            total[name] += b - a
            continue
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < b:
            total[name] += min(b, intervals[k][1]) - max(a, intervals[k][0])
            k += 1
    return total


def off_cost(annotate, loop):
    t = time.perf_counter()
    for _ in range(loop):
        pass
    empty = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(loop):
        with annotate("piqp.probe"):
            pass
    return 1e6 * (time.perf_counter() - t - empty) / loop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--loop", type=int, default=200_000)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("span_probe: needs a CUDA device", file=sys.stderr)
        return 2
    from gpubench import byname, harness, mixes
    from gpubench import trace as tr
    from piqp_tpu_torch.ops import _build
    import piqp_tpu_torch
    from piqp_tpu_torch.utils.profiling import annotate

    assert Path(piqp_tpu_torch.__file__).resolve().is_relative_to(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    spec = harness.load_cell(args.workload, root / "BENCHMARK.json")
    config, traffic = spec["config"], spec["traffic"]
    settings = harness.settings_of(config)
    batches = mixes.pool(config, traffic, args.seed)
    enter = byname.load("entries", config["entry"]).enter
    mix = mixes.mode(traffic).Round(config, traffic, args.seed, batches, "cuda",
                                    piqp_tpu_torch.solve_batch, settings, enter)

    def one_round(r):
        t = time.perf_counter()
        res, _ = mix.round(r)
        res.x.cpu().numpy()
        res.info.status.cpu().numpy()
        int(res.info.iter.cpu().numpy().max())
        return time.perf_counter() - t

    for r in range(1 - traffic["warmup_rounds"], 1):
        one_round(r)
    torch.cuda.synchronize()
    K = args.rounds
    off = [one_round(r) for r in range(1, K + 1)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(tr.WINDOW):
            on = [one_round(r) for r in range(K + 1, 2 * K + 1)]
            torch.cuda.synchronize()
    off += [one_round(r) for r in range(2 * K + 1, 3 * K + 1)]

    raw = list(prof.profiler.kineto_results.events())
    trace = tr.Trace(tr.from_profiler(prof), K)
    run = harness.Run(config, traffic)
    run.trace = trace
    metrics = {m: _reader(m)(run) for m in SPAN_METRICS}

    lo, hi = trace.start, trace.end
    spans = [(e.name, e.start, e.end) for e in trace.host
             if e.kind == "span" and e.name.startswith("piqp.") and lo <= e.start < hi]
    segs = segments(spans, lo, hi)
    idle = by_label(segs, trace.gaps())
    host = by_label(segs)
    idle_total = sum(idle.values())

    def per_round(counter):
        return {str(k if k is not None else "none"): 1e-6 * v / K
                for k, v in sorted(counter.items(), key=lambda kv: -kv[1])}

    # launches: calls in the window against kernels, by correlation id
    inside = [e for e in raw if lo <= int(e.start_ns()) < hi]
    calls = [e for e in inside if not e.is_user_annotation() and e.name().startswith(LAUNCHES)]
    kernels = [e for e in inside if "CUDA" in str(e.device_type()) and not e.is_user_annotation()
               and not e.name().startswith(("Memcpy", "Memset"))]
    call_ids = {e.correlation_id() for e in calls}
    unlaunched = collections.Counter(e.name()[:100] for e in kernels
                                     if e.correlation_id() not in call_ids)
    launches = {"calls": dict(collections.Counter(e.name() for e in calls)),
                "kernels": len(kernels), "kernels_without_call": sum(unlaunched.values()),
                "without_call_by_name": dict(unlaunched.most_common(8))}

    # syncs and scalar reads, inside the trips and outside them
    trips = sorted((s, e) for n, s, e in spans if n == TRIP)
    per_trip = [[0, 0] for _ in trips]
    outside = [0, 0]
    for e in trace.host:
        col = 0 if e.name.startswith(SYNCS) else 1 if e.name == SCALAR else None
        if col is None or e.kind == "span":
            continue
        hit = next((i for i, (s, t) in enumerate(trips) if s <= e.start < t), None)
        (per_trip[hit] if hit is not None else outside)[col] += 1
    syncs = {"in_trips": sum(p[0] for p in per_trip),
             "scalar_reads_in_trips": sum(p[1] for p in per_trip),
             "outside_trips": outside[0], "scalar_reads_outside_trips": outside[1],
             "per_trip": per_trip}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {
        "root": os.path.relpath(root, HERE), "workload": args.workload, "seed": args.seed,
        "rounds": K, "round_ms_off": [1e3 * s for s in off], "round_ms_on": [1e3 * s for s in on],
        "metrics": metrics, "idle_ms_per_round": 1e-6 * idle_total / K,
        "uncovered": idle[None] / idle_total if idle_total else None,
        "idle_by_layer": per_round(idle), "host_by_layer": per_round(host),
        "spans_per_round": collections.Counter(n for n, _, _ in spans).total() / K,
        "span_counts": dict(collections.Counter(n for n, _, _ in spans)),
        "launches": launches, "syncs": syncs,
        "off_us_per_span": off_cost(annotate, args.loop),
        "device": {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi.strip()},
        "seconds": time.perf_counter() - T0,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
