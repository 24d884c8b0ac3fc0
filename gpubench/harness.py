"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in the file the configuration's entry names, its
traffic in ``traffic/<name>.json``, and through ``byname`` the traffic's
mode (``modes/``), the configuration's generator (``generators/``) and
entry (``entries/``: how the host problems reach the program), and each
metric (``metrics/<name>.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from pathlib import Path


from . import byname, check, mixes
from . import trace as tr

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that may not be loaded in a run: JAX and the JAX
# package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "piqp_tpu")


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> dict:
    """The cell ``name`` with its configuration, traffic and the metrics it
    reports, each metric entry of ``BENCHMARK.json`` as it stands."""
    bench = json.loads(bench_file.read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"gpubench: no workload named {name!r} in {bench_file}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    # an end-to-end metric without ``workloads`` is every cell's; a
    # per-layer metric names its cells
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return dict(cell=cell, config=config, traffic=traffic, end_to_end=end_to_end,
                per_layer=per_layer)


def metric_reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``."""
    return byname.load("metrics", name).read


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers take their numbers from it."""

    config: dict
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    round_s: list = dataclasses.field(default_factory=list)
    iters: list = dataclasses.field(default_factory=list)
    prepare_s: list = dataclasses.field(default_factory=list)
    trace: object = None
    counters: dict = dataclasses.field(default_factory=dict)

    @property
    def rounds(self) -> int:
        return len(self.round_s)

    @property
    def batch(self) -> int:
        return self.config["batch"]


def settings_of(config: dict):
    from piqp_tpu_torch import KKTBackend, Settings

    kw = dict(config["settings"])
    if "kkt_solver" in kw:
        kw["kkt_solver"] = KKTBackend[kw["kkt_solver"]]
    return Settings(**kw)


def _counters() -> dict:
    """The program's launch counters: each module-level dict of every
    module of ``piqp_tpu_torch.ops`` whose name holds ``launches_by``, under
    ``"<module>.<name>"`` (``"signed_chol_inv.launches_by_dtype"``), and
    ``chol_inv``'s whose names end in ``launches_by_dtype`` or
    ``launches_by_route`` also under their bare names, as
    ``k1_roofline.warm`` reads them."""
    import importlib
    import pkgutil

    from piqp_tpu_torch import ops

    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module(f"{ops.__name__}.{info.name}")
        out.update({f"{info.name}.{k}": dict(v) for k, v in vars(module).items()
                    if "launches_by" in k and isinstance(v, dict)})
    bare = {k.removeprefix("chol_inv."): v for k, v in out.items()
            if k.startswith("chol_inv.") and k.endswith(("launches_by_dtype", "launches_by_route"))}
    return {**out, **bare}


def window_counts(before: dict, after: dict) -> dict:
    """Each counter's launches between two ``_counters()`` readings; a key
    that appears in between (a counter keyed by launch shape) counts from
    0."""
    return {k: {d: v - before.get(k, {}).get(d, 0) for d, v in c.items()}
            for k, c in after.items()}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(name: str, seed: int, seconds: float, trace: bool, t0: float, device: str = "cuda",
        solve=None, bench_file: Path = ROOT / "BENCHMARK.json") -> tuple:
    """Run cell ``name``; returns (result, numbers): the result line's
    object and the check's {name: (value, limit)}.  ``solve`` stands in for
    ``piqp_tpu_torch.solve_batch`` (the tests' planted faults)."""
    import torch

    spec = load_cell(name, bench_file)
    config, traffic = spec["config"], spec["traffic"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from piqp_tpu_torch.ops import _build

        # float32 products in full float32 on both sides, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.library()
    import piqp_tpu_torch

    # set-up's parts, seconds since process start, so that a change in
    # setup_s shows where it lies
    parts = {"import": time.perf_counter() - t0}
    solve = piqp_tpu_torch.solve_batch if solve is None else solve
    settings = settings_of(config)
    batches = mixes.pool(config, traffic, seed)
    parts["problems"] = time.perf_counter() - t0
    enter = byname.load("entries", config["entry"]).enter
    mix = mixes.mode(traffic).Round(config, traffic, seed, batches, device, solve, settings,
                                    enter)
    parts["mix"] = time.perf_counter() - t0
    out = Run(config, traffic)
    window = {"xs": [], "statuses": []}

    def one_round(r, keep):
        t = time.perf_counter()
        res, prep = mix.round(r)
        x = res.x.cpu().numpy()
        status = res.info.status.cpu().numpy()
        it = int(res.info.iter.cpu().numpy().max())
        dt = time.perf_counter() - t
        if keep:
            out.round_s.append(dt)
            out.iters.append(it)
            if prep is not None:
                out.prepare_s.append(prep)
            window["xs"].append(x)
            window["statuses"].append(status)

    for r in range(1 - traffic["warmup_rounds"], 1):
        one_round(r, keep=False)
    if cuda:
        torch.cuda.synchronize()

    traced = int(traffic["trace_rounds"]) if trace else 0
    out.setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    r = 0
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        before = _counters()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function(tr.WINDOW):
                for r in range(1, traced + 1):
                    one_round(r, keep=True)
                if cuda:
                    torch.cuda.synchronize()
        after = _counters()
        out.counters = window_counts(before, after)
    while time.perf_counter() - start < seconds:
        r += 1
        one_round(r, keep=True)
    out.window_s = time.perf_counter() - start
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    del mix
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if traced:
        out.trace = tr.Trace(tr.from_profiler(prof), traced)
        del prof

    check_start = time.perf_counter()
    numbers = check.compare(config, traffic, seed, window, device)
    check_s = time.perf_counter() - check_start
    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        value = metric_reader(m["name"])(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": spec["cell"]["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": check.passed(numbers),
              "attempted": int(out.rounds * out.batch),
              "failed": int(numbers["not_solved"][0]),
              "metrics": metrics, "device": dev}
    if out.trace is not None:
        dev.update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
        result["breakdown"] = {"device_ops": out.trace.device_ops(),
                               "idle_gaps": out.trace.idle_gaps()}
    result["rounds"] = out.rounds
    result["setup_parts"] = parts
    result["iters_mean"] = sum(out.iters) / max(1, len(out.iters))
    result["check_s"] = check_s
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    # what the process holds once the window has closed and the check is
    # done: JAX or the JAX package there means the program loaded it
    forbidden = forbidden_modules()
    if forbidden:
        raise RuntimeError(f"modules loaded that a run may not load: {forbidden}")
    return result, numbers
