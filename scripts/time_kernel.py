"""Time one kernel of one or more checkouts of this repository on one CUDA
card, each checkout in a fresh process, in the order given:

    python3 scripts/time_kernel.py K1|K2|K3 ROOT [ROOT ...]

K1 is ``ops/chol_inv.cholesky_with_inverse`` at B = 1024, n = 128 (the
resident route) and at B = 256, n = 256 (above the resident limit: the
cluster route; in older checkouts a one-block kernel with its workspace in
device memory, ``csrc/chol_inv.cu``), each beside
the library (``cholesky`` + ``solve_triangular``) and K3's wrapper of the
same checkout with every sign +1 (held to K1's plain version); K2 is
``ops/chol_inv.cholesky_inverse_apply`` at the multistage fleet's first
cyclic-reduction level, N = 12,800, n = 8, r = 20, at N = 5,376, n = 23,
r = 50 (256 problems of T = 43, D = 23, Da = 4), both on the small route,
at N = 2,560, n = 48, r = 100 (the D = 48 fleet's first level) and
n = 64, r = 132, which take the resident route, and at N = 1,280,
n = 144, r = 292 (the D = 144 fleet's first level), which takes the split
route: K1's factor kernel, then the product kernel (``apply_kernel_route``
names each shape's route; an older checkout sends the last to the general
kernel, csrc/chol_inv_apply.cu, so an A/B across checkouts times the
split route against it), with the ptxas lines of the small, the resident
and the product kernel; K3 is
``ops/signed_chol_inv.signed_cholesky_with_inverse`` at the dense_ldlt
fleet's B = 256, n = 256 and its float64 batch, B = 64.  Give two versions
as parent, change, change, parent to compare them within one run.  For each
ROOT the script imports ``piqp_tpu_torch`` from ROOT, builds its kernels
there (nvcc seconds, 0 when that checkout's library is up to date), reads
ptxas's registers and spills of each instance of the kernel, and, in
float32 and float64 at each shape, holds the outputs against the plain
version with chip_smoke.py's tolerances, then times the wrapper: K1 and K3
with chip_smoke.py's looped CUDA events (``ms``); K2, whose launch is
shorter than the wrapper's host work, by its device time, chip_smoke.py's
CUDA graph of launches, with the inputs warm in L2 (``ms``) and rotated
through 8 sets larger than the L2 (``ms_cold_l2``; not at a shape whose
one set already exceeds the L2), and looped (``looped_ms``).  It prints one JSON line per ROOT and exits nonzero if
any ROOT fails or no card is there.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# per kernel: its module in piqp_tpu_torch.ops, wrapper, plain version,
# chip_smoke.py's input maker, the shapes timed (its arguments after the
# dtype) and the kernels whose ptxas instances are read (the digit is the
# mangled name's length; K1 above the resident limit is chol_inv_kernel in
# older checkouts and chol_inv_cluster_kernel in newer ones)
KERNELS = {
    "K1": dict(module="chol_inv", wrapper="cholesky_with_inverse",
               reference="chol_inv_reference", batch="_spd_batch",
               shapes=[(1024, 128), (256, 256)],
               instance=r"\d(?:chol_inv_resident|chol_inv|chol_inv_cluster)_kernel"),
    "K2": dict(module="chol_inv", wrapper="cholesky_inverse_apply",
               reference="chol_inv_apply_reference", batch="_apply_batch",
               shapes=[(12800, 8, 20), (5376, 23, 50), (2560, 48, 100), (2560, 64, 132),
                       (1280, 144, 292)],
               instance=r"\dchol_inv_apply_(?:small|resident|product)_kernel"),
    "K3": dict(module="signed_chol_inv", wrapper="signed_cholesky_with_inverse",
               reference="signed_chol_inv_reference", batch="_quasidef_batch",
               shapes=[(256, 256), (64, 256)],
               instance=r"\dsigned_chol_inv_resident_kernel"),
}
# rotated input sets of K2's cold-L2 timing, taken where one set fits the
# card's 50 MB L2
COLD_SETS = 8
L2_BYTES = 50e6


def _instances(log: str, instance: str) -> list:
    """(function, registers, spill stores) of each instance of a kernel in
    an nvcc -Xptxas -v log."""
    out = []
    for m in re.finditer(
        rf"Compiling entry function '(\S*{instance}\S*)'.*?"
        r"(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S):
        out.append(dict(function=m[1], registers=int(m[3]), spill_stores=int(m[2])))
    return out


def _k1_comparators(torch, smoke, K, want, tol) -> dict:
    """K1's route at K's shape, and the library's and K3's (signs +1) ms
    there, K3's outputs held to K1's plain version ``want``."""
    from piqp_tpu_torch.ops import chol_inv, signed_chol_inv

    n = K.shape[-1]
    ones = torch.ones(n, dtype=K.dtype, device=K.device)
    eye = torch.eye(n, dtype=K.dtype, device=K.device).expand_as(K)
    k3 = lambda: signed_chol_inv.signed_cholesky_with_inverse(K, ones)
    got = k3()
    torch.cuda.synchronize()
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    if not all(e <= tol * max(1.0, w.abs().max().item()) for e, w in zip(errs, want)):
        raise AssertionError(f"K3 with signs +1 at n={n}: errors {errs} of (L, Linv) against "
                             f"K1's plain version")
    return dict(route=chol_inv.kernel_route(n, K.dtype), k3_plus_ms=smoke._time_ms(torch, k3),
                k3_plus_err=max(errs),
                library_ms=smoke._time_ms(torch, lambda: torch.linalg.solve_triangular(
                    torch.linalg.cholesky(K), eye, upper=False)))


def _child(kernel: str, root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from piqp_tpu_torch.ops import _build

    spec = KERNELS[kernel]
    mod = importlib.import_module(f"piqp_tpu_torch.ops.{spec['module']}")
    wrapper, reference = getattr(mod, spec["wrapper"]), getattr(mod, spec["reference"])
    # this repository's helpers, whichever checkout is timed
    smoke_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(smoke_spec)
    smoke_spec.loader.exec_module(smoke)
    batch = getattr(smoke, spec["batch"])

    if Path(mod.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"piqp_tpu_torch came from {mod.__file__}, not {root}")
    _build.library()
    result = dict(kernel=kernel, root=str(root), build_s=_build.BuildInfo.seconds,
                  instances=_instances(_build.BuildInfo.log, spec["instance"]),
                  card=torch.cuda.get_device_name(0), smi=smoke._smi())
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        tol = smoke.K1_TOL[name]
        for shape in spec["shapes"]:
            args = batch(torch, *shape, dtype, seed=7)
            args = args if isinstance(args, tuple) else (args,)
            got = wrapper(*args)
            torch.cuda.synchronize()
            want = reference(*args)
            errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
            scales = [max(1.0, want[0].abs().max().item()), want[1].abs().max().item()]
            rtols = [tol, tol]
            if kernel == "K2":
                scales.append(want[2].abs().max().item())
                rtols.append(smoke.K2_Y_RTOL[name])
            if not all(e <= t * s for e, t, s in zip(errs, rtols, scales)):
                raise AssertionError(f"{root} {kernel} {name} {shape}: errors {errs} of "
                                     f"(L, Linv, Y) beyond the tolerance")
            labels = ("B", "n") if len(shape) == 2 else ("N", "n", "r")
            key = f"{name} " + " ".join(f"{a}={v}" for a, v in zip(labels, shape))
            entry = dict(err_L=errs[0], err_Linv=errs[1])
            if kernel == "K2":
                entry.update(
                    err_Y=errs[2],
                    # a checkout before the small kernel has the general one alone
                    route=(mod.apply_kernel_route(shape[1], dtype, shape[2])
                           if hasattr(mod, "apply_kernel_route") else "general"),
                    ms=smoke._graph_ms(torch, [lambda: wrapper(*args)]),
                    looped_ms=smoke._time_ms(torch, lambda: wrapper(*args)))
                if sum(a.numel() * a.element_size() for a in args) < L2_BYTES:
                    sets = [batch(torch, *shape, dtype, seed=100 + i) for i in range(COLD_SETS)]
                    entry["ms_cold_l2"] = smoke._graph_ms(
                        torch, [lambda a=a: wrapper(*a) for a in sets])
                    del sets
            else:
                entry["ms"] = smoke._time_ms(torch, lambda: wrapper(*args))
            if kernel == "K1":
                entry.update(_k1_comparators(torch, smoke, args[0], want, tol))
            result[key] = entry
    return result


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--child"]:
        print(json.dumps(_child(args[1], Path(args[2]).resolve())), flush=True)
        return 0
    if len(args) < 2 or args[0] not in KERNELS:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("time_kernel: no CUDA device available", file=sys.stderr)
        return 2
    failed = 0
    for root in args[1:]:
        rc = subprocess.run([sys.executable, __file__, "--child", args[0], root],
                            timeout=900).returncode
        failed += rc != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
