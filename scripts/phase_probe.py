"""Per-phase wall time of one block of K2's resident kernel under a full
launch, on one CUDA card:

    python3 scripts/phase_probe.py [ROOT]

Copies the piqp_tpu_torch package of ROOT (default: this checkout) into
build/phase_probe/ and inserts into the copy's
csrc/chol_inv_apply_resident.cu a read of the global timer (%globaltimer,
ns) by one block's thread 0 after each barrier: the loads, the first
diagonal block, then phase B and phases C + A of every panel, the store of
L and Linv, and the product (two barriers the kernel itself does not
have), with a C function that returns the stamps and picks the block.  It
builds the copy's kernels and, at N = 2,560, D = 48 and 64, R = 2D + 4,
in float32 and float64, launches the copy's ``cholesky_inverse_apply``
three times for each probed block (the grid's first, middle and last),
then times the instrumented kernel by device time.  Prints one JSON line
per dtype and D, times in microseconds; exits nonzero without a card or
when the kernel's source no longer has the anchors the probe needs.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "phase_probe"
SHAPES = [(2560, 48, 100), (2560, 64, 132)]

# (anchor, text put after it) in the kernel's source, each anchor unique
_STAMP = "  if (probe) g_probe[slot++] = now_ns();\n"
_EDITS = [
    ("namespace {\n\nconstexpr int kNb",
     None),  # replaced by _HEADER + the anchor
    ("  const size_t roffset = static_cast<size_t>(blockIdx.x) * n * r;\n",
     "  const bool probe = blockIdx.x == g_probe_block && tid == 0;\n  int slot = 0;\n" + _STAMP),
    ('  asm volatile("cp.async.wait_all;\\n" ::: "memory");\n  __syncthreads();\n', _STAMP),
    ("  if (warp == 0) factor_diagonal_block<T>(M, diag, P, 0, min(kNb, n));\n"
     "  __syncthreads();\n", _STAMP),
    ("          if (c < nbp) M[col * P + j0 + c] = z;\n        }\n      }\n    }\n"
     "    __syncthreads();\n", "  " + _STAMP),
    ("        update_tile<T>(M, P, n, r, g, j0);\n      }\n    }\n    __syncthreads();\n",
     "  " + _STAMP),
    ("  store_factors<T, kWarps>(M, diag, L_out + offset, Linv_out + offset, n, P);\n",
     "  __syncthreads();\n" + _STAMP),
    ("  apply_transpose<T, kWarps>(M, Y_out + roffset, n, r, P);\n",
     "  __syncthreads();\n" + _STAMP),
]
_HEADER = """__device__ unsigned long long g_probe[64];
__device__ int g_probe_block;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

"""
_READER = """
extern "C" int piqp_probe_read(unsigned long long* out, int block) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  if (err != cudaSuccess) return err;
  return cudaMemcpyToSymbol(g_probe_block, &block, sizeof(int));
}
"""


def _instrument(src: str) -> str:
    for anchor, after in _EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"the kernel's source has {src.count(anchor)} copies of the "
                               f"probe's anchor {anchor[:60]!r}")
        src = src.replace(anchor, _HEADER + anchor if after is None else anchor + after)
    return src + _READER


def main() -> int:
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else REPO
    import torch

    if not torch.cuda.is_available():
        print("phase_probe: no CUDA device available", file=sys.stderr)
        return 2
    shutil.rmtree(OUT, ignore_errors=True)
    shutil.copytree(root / "piqp_tpu_torch", OUT / "piqp_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    kernel = OUT / "piqp_tpu_torch" / "csrc" / "chol_inv_apply_resident.cu"
    kernel.write_text(_instrument(kernel.read_text()))
    sys.path.insert(0, str(OUT))
    from piqp_tpu_torch.ops import _build, chol_inv

    sys.path.insert(1, str(REPO))
    import chip_smoke

    lib = _build.library()
    read = lib.piqp_probe_read
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    smi = chip_smoke._smi()
    for dtype in (torch.float32, torch.float64):
        for N, D, R in SHAPES:
            K, RHS = chip_smoke._apply_batch(torch, N, D, R, dtype, seed=7)
            panels = (D + 7) // 8
            result = dict(dtype=str(dtype).removeprefix("torch."), N=N, D=D, R=R, smi=smi)
            for block in (0, N // 2, N - 1):
                stamps = (ctypes.c_ulonglong * 64)()
                if read(stamps, block):  # picks the block for the next launches
                    raise RuntimeError("reading the probe failed")
                for _ in range(3):
                    chol_inv.cholesky_inverse_apply(K, RHS)
                torch.cuda.synchronize()
                if read(stamps, block):
                    raise RuntimeError("reading the probe failed")
                t = [stamps[i] / 1e3 for i in range(5 + 2 * panels)]
                d = [b - a for a, b in zip(t, t[1:])]
                result[f"block {block}"] = dict(
                    load=d[0], first_A=d[1], B=d[2:2 + 2 * panels:2],
                    C_and_A=d[3:3 + 2 * panels:2], store=d[2 + 2 * panels],
                    product=d[3 + 2 * panels], total=t[-1] - t[0])
            result["instrumented_device_ms"] = chip_smoke._graph_ms(
                torch, [lambda: chol_inv.cholesky_inverse_apply(K, RHS)])
            print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
