"""Quick check of K2's split route on one CUDA card:

    python3 scripts/split_probe.py

Builds the port's kernels (nvcc seconds and the product kernel's ptxas
registers and spills per instance), holds ``cholesky_inverse_apply`` on
the split route (K1's factor kernel, then the product kernel) to its plain
version at shapes on each side of its limits, and the product kernel alone
to ``inv_apply_reference``, with chip_smoke.py's tolerances; then, at the
D = 144 multistage fleet's first level (N = 1,280, n = 144, r = 292), times
the route by device time (a CUDA graph of launches) and looped, each of its
two kernels alone, and the library route (looped and by device time), in
float32 and float64.  Exits nonzero without a card or on any disagreement.
It is the phase 2b subset of chip_smoke.py that a change to the product
kernel needs, in about a minute.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SHAPES = [(5, 139, 282), (5, 144, 292), (5, 98, 200), (5, 256, 516), (5, 241, 486),
          (5, 170, 344), (5, 226, 456), (5, 32, 1800), (5, 76, 308), (5, 108, 436),
          (1280, 144, 292)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("split_probe: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from piqp_tpu_torch.ops import _build, chol_inv

    _build.library()
    print(f"[build] nvcc {_build.BuildInfo.seconds:.2f} s; {cs._smi()}")
    for m in re.finditer(r"Compiling entry function '(\S*product_kernel\S*)'.*?"
                         r"(\d+) bytes spill stores.*?Used (\d+) registers",
                         _build.BuildInfo.log, re.S):
        print(f"[ptxas] {m[1]}: {m[3]} registers, {m[2]} bytes spilled")
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        for N, D, R in SHAPES:
            K, RHS = cs._apply_batch(torch, N, D, R, dtype, seed=D + R)
            route = chol_inv.apply_kernel_route(D, dtype, R)
            L, Linv, Y = chol_inv.cholesky_inverse_apply(K, RHS)
            Y_product = chol_inv._launch_product(Linv, RHS)
            torch.cuda.synchronize()
            L_ref, _, Y_ref = chol_inv.chol_inv_apply_reference(K, RHS)
            err_L = (L - L_ref).abs().max().item()
            err_Y = (Y - Y_ref).abs().max().item() / Y_ref.abs().max().item()
            want = chol_inv.inv_apply_reference(Linv, RHS)
            err_P = (Y_product - want).abs().max().item() / want.abs().max().item()
            print(f"[{name}] {route} N={N} D={D} R={R}: |L-L_ref| {err_L:.3e}, |Y-Y_ref| "
                  f"{err_Y:.3e} of max |Y_ref|, product alone {err_P:.3e} of its plain version")
            if not (err_L <= cs.K1_TOL[name] * max(1.0, L_ref.abs().max().item())
                    and max(err_Y, err_P) <= cs.K2_Y_RTOL[name]):
                raise AssertionError(f"{name} N={N} D={D} R={R} disagrees with its plain version")
        N, D, R = cs.K2_SPLIT_TIMED
        K, RHS = cs._apply_batch(torch, N, D, R, dtype, seed=7)
        _, Linv, _ = chol_inv.cholesky_inverse_apply(K, RHS)
        factor = chol_inv.kernel_route(D, dtype)
        eye = torch.eye(D, dtype=dtype, device="cuda").expand_as(K)

        def library():
            Lc = torch.linalg.cholesky_ex(K)[0]
            Li = torch.linalg.solve_triangular(Lc, eye, upper=False)
            return Li.mT @ (Li @ RHS)

        split = lambda: chol_inv.cholesky_inverse_apply(K, RHS)
        t = dict(split=cs._graph_ms(torch, [split]), split_looped=cs._time_ms(torch, split),
                 factor=cs._graph_ms(torch, [lambda: chol_inv._launch_factor(K, factor)]),
                 product=cs._graph_ms(torch, [lambda: chol_inv._launch_product(Linv, RHS)]),
                 library=cs._time_ms(torch, library),
                 library_graph=cs._graph_ms(torch, [library]))
        print(f"[{name}] N={N} D={D} R={R} ms: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
