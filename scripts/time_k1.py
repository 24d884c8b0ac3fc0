"""Time the resident K1 kernel (Cholesky with inverse) of one or more
checkouts of this repository on one CUDA card, each in a fresh process, in
the order given:

    python3 scripts/time_k1.py ROOT [ROOT ...]

Give two versions as parent, change, change, parent to compare them within
one run.  For each ROOT the script imports ``piqp_tpu_torch`` from ROOT,
builds its kernels there (nvcc seconds, 0 when that checkout's library is
up to date), reads ptxas's registers and spills of each resident kernel
instance, holds L and Linv at B = 1024, n = 128 against the plain version
with chip_smoke.py's tolerances, and times ``cholesky_with_inverse`` with
chip_smoke.py's looped CUDA events, in float32 and float64.  It prints one
JSON line per ROOT and exits nonzero if any ROOT fails or no card is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
B, N = 1024, 128


def _instances(log: str) -> list:
    """(type, chunks, registers, spill stores) of each resident instance
    in an nvcc -Xptxas -v log."""
    out = []
    for m in re.finditer(
        r"Compiling entry function '\S*chol_inv_resident_kernelI([fd])Li(\d+)E\S*'.*?"
        r"(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S):
        out.append(dict(type={"f": "float32", "d": "float64"}[m[1]], chunks=int(m[2]),
                        registers=int(m[4]), spill_stores=int(m[3])))
    return out


def _child(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from piqp_tpu_torch.ops import _build, chol_inv

    # this repository's helpers, whichever checkout is timed
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    K1_TOL, _spd_batch, _time_ms = smoke.K1_TOL, smoke._spd_batch, smoke._time_ms

    if Path(chol_inv.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"piqp_tpu_torch came from {chol_inv.__file__}, not {root}")
    _build.library()
    result = dict(root=str(root), build_s=_build.BuildInfo.seconds,
                  instances=_instances(_build.BuildInfo.log), card=torch.cuda.get_device_name(0))
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        K = _spd_batch(torch, B, N, dtype, seed=7)
        L, Linv = chol_inv.cholesky_with_inverse(K)
        torch.cuda.synchronize()
        L_ref, Linv_ref = chol_inv.chol_inv_reference(K)
        err_L = (L - L_ref).abs().max().item()
        err_Li = (Linv - Linv_ref).abs().max().item()
        tol = K1_TOL[name]
        if not (err_L <= tol * max(1.0, L_ref.abs().max().item())
                and err_Li <= tol * Linv_ref.abs().max().item()):
            raise AssertionError(f"{root} {name}: |L-L_ref| {err_L:.3e} |Linv-Linv_ref| "
                                 f"{err_Li:.3e} beyond the tolerance")
        result[name] = dict(ms=_time_ms(torch, lambda: chol_inv.cholesky_with_inverse(K)),
                            err_L=err_L, err_Linv=err_Li)
    return result


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(_child(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    roots = sys.argv[1:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("time_k1: no CUDA device available", file=sys.stderr)
        return 2
    failed = 0
    for root in roots:
        rc = subprocess.run([sys.executable, __file__, "--child", root], timeout=900).returncode
        failed += rc != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
