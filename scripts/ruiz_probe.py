"""Ruiz equilibration on one CUDA card at the benchmark cells' shapes:

    python3 scripts/ruiz_probe.py [--root DIR] [--repeats N]

It imports ``piqp_tpu_torch`` from DIR (default: this checkout) and prints
one JSON line per measurement, each with the card's name and power limit:

- ``kernel``, where DIR has ``ops/ruiz_norms.py``: each instance of the
  Ruiz norm and scale kernels in float64 and float32 at dense128's shape
  (B = 1024, n = 128, p = m = 64) and chainmass5's (B = 1024, T = 40,
  D = 24, ra = 21, Da = rg = 0): ms a launch (CUDA events around 20
  launches, median of ``repeats``), the bound (the blocks' bytes at 3.35
  TB/s, read once by the norms, read and written by the scaling), the
  plain version's ms, and whether the norms agree bit for bit; the step
  kernel's ms at chainmass5's widths; first the registers ``ptxas`` gave
  each instance;
- ``equilibrate``: ``ruiz.equilibrate`` on a dense128 batch (PIQP's
  ``dense_strongly_convex_qp(128, 64, 64)``, seeds 0-1023) and on a
  random stage batch of chainmass5's shape, float64, PIQP's defaults
  (10 passes, no cost scaling): host ms until the call returns (its
  launches), host ms a call ending in a synchronize and device ms (CUDA events), median of ``repeats``, and the sums of
  d_x and c, to hold two trees' scalings to each other; where DIR has the
  step kernel, a second line (``step: plain``) with each pass's step run
  as its plain version's small tensor ops instead; then ``profile``, one
  call under ``torch.profiler``: the device ms of its kernels and the
  leading ops by device time.

Compare two trees in one call: ``--root`` a ``git archive`` of the other
under ``build/``.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12


def _ms(fn, repeats: int, launches: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / launches)
    return statistics.median(out)


def _dense_batch(dev):
    import torch

    from piqp_tpu_torch import prepare_batch
    from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

    probs = [dense_strongly_convex_qp(128, 64, 64, seed=i) for i in range(1024)]
    return prepare_batch(probs, dtype=torch.float64, device=dev)


def _stage_batch(dev, B=1024, T=40, D=24, ra=21, seed=0):
    """A random stage batch of chainmass5's shape (no arrow, no G)."""
    import torch

    from piqp_tpu_torch import multistage as tms

    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = torch.float64

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=f64, device=dev)

    Pd = rnd(B, T, D, D)
    Pd = Pd @ Pd.mT + D * torch.eye(D, dtype=f64, device=dev)
    Psub, A2 = rnd(B, T, D, D), rnd(B, T, ra, D)
    Psub[:, -1], A2[:, -1] = 0.0, 0.0
    n, p = T * D, T * ra
    inf = torch.full((B, n), float("inf"), dtype=f64, device=dev)
    empty = torch.zeros((B, 0), dtype=f64, device=dev)
    nob = torch.zeros((B, n), dtype=torch.bool, device=dev)
    return tms.StageQPData(
        c=rnd(B, n), b=rnd(B, p), h_l=empty, h_u=empty, x_l=-inf, x_u=inf,
        x_b_scaling=torch.ones((B, n), dtype=f64, device=dev),
        hl_mask=empty.bool(), hu_mask=empty.bool(), xl_mask=nob, xu_mask=nob,
        Pd=Pd, Psub=Psub, Pa=rnd(B, T, 0, D), Pc=rnd(B, 0, 0), A1=rnd(B, T, ra, D), A2=A2,
        Ag=rnd(B, T, ra, 0), G1=rnd(B, T, 0, D), G2=rnd(B, T, 0, D), Gg=rnd(B, T, 0, 0))


def _kernel_lines(dev, repeats, card):
    import torch

    from piqp_tpu_torch.ops import _build, ruiz_norms

    log = _build.BuildInfo.log
    if "--- nvcc ruiz_norms.cu" in log:
        part = log.split("--- nvcc ruiz_norms.cu", 1)[1].split("--- nvcc", 1)[0]
        print(json.dumps(dict(probe="ptxas", card=card, lines=[
            s.strip() for s in part.splitlines() if "registers" in s or "Compiling" in s])))
    g = torch.Generator(device=dev).manual_seed(1)
    for dtype in (torch.float64, torch.float32):
        def rnd(*shape):
            return torch.randn(shape, generator=g, dtype=torch.float64, device=dev).to(dtype)

        def pos(*shape):
            return torch.rand(shape, generator=g, dtype=torch.float64, device=dev).add(
                0.5).to(dtype)

        B, n, p, m = 1024, 128, 64, 64
        on = torch.ones(B, dtype=torch.bool, device=dev)
        args = (rnd(B, n, n), rnd(B, p, n), rnd(B, m, n), on)
        nbytes = sum(a.numel() for a in args[:3]) * args[0].element_size()
        same = torch.equal(ruiz_norms.dense_norms(*args), ruiz_norms.dense_norms_reference(*args))
        print(json.dumps(dict(
            probe="kernel", instance="dense", dtype=str(dtype)[6:], shape=f"B{B}xn{n}xp{p}xm{m}",
            card=card, kernel_ms=_ms(lambda: ruiz_norms.dense_norms(*args), repeats),
            bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bytes=nbytes,
            plain_ms=_ms(lambda: ruiz_norms.dense_norms_reference(*args), repeats, 3),
            bitwise=same)), flush=True)
        scale = (*args[:3], pos(B, n), pos(B, p), pos(B, m), on)
        print(json.dumps(dict(
            probe="kernel", instance="dense_scale", dtype=str(dtype)[6:],
            shape=f"B{B}xn{n}xp{p}xm{m}", card=card,
            kernel_ms=_ms(lambda: ruiz_norms.dense_scale(*scale), repeats),
            bound_ms=2e3 * nbytes / HBM_BYTES_PER_S, bytes=2 * nbytes,
            plain_ms=_ms(lambda: ruiz_norms.dense_scale_reference(*scale), repeats, 3))),
            flush=True)
        del args
        B, T, D, ra = 1024, 40, 24, 21
        blocks = (rnd(B, T, D, D), rnd(B, T, D, D), rnd(B, T, 0, D), rnd(B, T, ra, D),
                  rnd(B, T, ra, D), rnd(B, T, ra, 0), rnd(B, T, 0, D), rnd(B, T, 0, D),
                  rnd(B, T, 0, 0))
        rest = (torch.ones(B, dtype=torch.bool, device=dev), 0, T)
        nbytes = sum(M.numel() for M in blocks) * blocks[0].element_size()
        got = ruiz_norms.stage_norms(blocks, *rest)
        want = ruiz_norms.stage_norms_reference(blocks, *rest)
        same = torch.equal(got, want)
        print(json.dumps(dict(
            probe="kernel", instance="stage", dtype=str(dtype)[6:],
            shape=f"B{B}xT{T}xD{D}xra{ra}xrg0xDa0", card=card,
            kernel_ms=_ms(lambda: ruiz_norms.stage_norms(blocks, *rest), repeats),
            bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bytes=nbytes,
            plain_ms=_ms(lambda: ruiz_norms.stage_norms_reference(blocks, *rest), repeats, 3),
            bitwise=same)), flush=True)
        # the scale kernel reads and writes the blocks: twice the bytes
        scale = (blocks, pos(B, T, D), pos(B, 0), pos(B, T, ra), pos(B, T, 0), rest[0])
        print(json.dumps(dict(
            probe="kernel", instance="stage_scale", dtype=str(dtype)[6:],
            shape=f"B{B}xT{T}xD{D}xra{ra}xrg0xDa0", card=card,
            kernel_ms=_ms(lambda: ruiz_norms.stage_scale(*scale), repeats),
            bound_ms=2e3 * nbytes / HBM_BYTES_PER_S, bytes=2 * nbytes,
            plain_ms=_ms(lambda: ruiz_norms.stage_scale_reference(*scale), repeats, 3))),
            flush=True)
        del blocks, rest, got, want
        # the step at chainmass5's widths: n = 960, p + m = 840
        B, n, pm = 1024, 960, 840
        norms = pos(B, n + pm)
        state = (pos(B, 2 * n + pm), pos(B, 2 * n + pm), pos(B, n), pos(B, n), pos(B))
        on = torch.ones(B, dtype=torch.bool, device=dev)
        print(json.dumps(dict(
            probe="kernel", instance="step", dtype=str(dtype)[6:], shape=f"B{B}xn{n}xpm{pm}",
            card=card, kernel_ms=_ms(lambda: ruiz_norms.ruiz_step(norms, None, *state, on),
                                     repeats),
            plain_ms=_ms(lambda: ruiz_norms.ruiz_step_reference(norms, None, *state, on),
                         repeats, 3))), flush=True)
        del norms, state
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ruiz_probe: no CUDA device available", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from piqp_tpu_torch import ruiz
    from piqp_tpu_torch.ops import _build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(probe="build", root=str(root), card=card,
                          seconds=time.perf_counter() - t0)), flush=True)
    if (root / "piqp_tpu_torch" / "ops" / "ruiz_norms.py").exists():
        _kernel_lines(dev, args.repeats, card)
    kernel_step = getattr(ruiz, "ruiz_step", None)
    steps = [("kernel", kernel_step)]
    if kernel_step is not None:
        from piqp_tpu_torch.ops import ruiz_norms

        steps.append(("plain", ruiz_norms.ruiz_step_reference))
    for kind, make in (("dense128", _dense_batch), ("chainmass5_shape", _stage_batch)):
        data = make(dev)
        for step, fn in steps:
            if fn is not None:
                ruiz.ruiz_step = fn
            scaled, s = ruiz.equilibrate(data)
            torch.cuda.synchronize()
            host, launch, device = [], [], []
            for _ in range(args.repeats):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t = time.perf_counter()
                a.record()
                ruiz.equilibrate(data)
                b.record()
                launch.append(1e3 * (time.perf_counter() - t))
                torch.cuda.synchronize()
                host.append(1e3 * (time.perf_counter() - t))
                device.append(a.elapsed_time(b))
            print(json.dumps(dict(probe="equilibrate", kind=kind, step=step, root=str(root),
                                  card=card, launch_ms=statistics.median(launch),
                                  host_ms=statistics.median(host), host_ms_all=host,
                                  device_ms=statistics.median(device),
                                  d_x_checksum=float(s.d_x.sum()), cost=float(s.c.sum()))),
                  flush=True)
        if kernel_step is not None:
            ruiz.ruiz_step = kernel_step
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ruiz.equilibrate(data)
            torch.cuda.synchronize()
        ops = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                      if e.device_time_total > 0), key=lambda r: -r[1])
        print(json.dumps(dict(probe="profile", kind=kind, root=str(root), card=card,
                              device_ms_total=sum(r[1] for r in ops if not r[0].startswith(
                                  ("aten::", "cuda"))),
                              top=[(k[:60], round(ms, 4), c) for k, ms, c in ops[:14]])),
              flush=True)
        del data, scaled, s
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
