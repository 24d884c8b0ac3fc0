"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package and initialises no torch.distributed process group, no source
file under piqp_tpu_torch/ imports either package, and its entry points
never fall back to the CPU on their own.  It exports every name the JAX
package does."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import piqp_tpu_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "piqp_tpu_torch"


def test_import_leaves_jax_out():
    code = (
        "import sys, piqp_tpu_torch, piqp_tpu_torch.convert, piqp_tpu_torch.ops.chol_inv,"
        " piqp_tpu_torch.parallel, piqp_tpu_torch.utils.pad, piqp_tpu_torch.utils.io,"
        " piqp_tpu_torch.utils.profiling, torch.distributed as dist;"
        "assert not dist.is_initialized(), 'importing the port initialised torch.distributed';"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'piqp_tpu' or m.startswith('piqp_tpu.')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_exports_cover_the_jax_package():
    """Every name the JAX package exports, the port exports too."""
    import piqp_tpu

    missing = sorted(set(piqp_tpu.__all__) - set(piqp_tpu_torch.__all__))
    assert missing == []
    for name in piqp_tpu.__all__:
        assert hasattr(piqp_tpu_torch, name), name


def test_no_source_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|piqp_tpu)(\.|\s|$)", re.M)
    sources = sorted(PKG.rglob("*.py"))
    assert len(sources) >= 10
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry points default to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        piqp_tpu_torch.prepare_data(np.eye(2), np.zeros(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        piqp_tpu_torch.DenseSolver()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        piqp_tpu_torch.prepare_batch([dict(P=np.eye(2), c=np.zeros(2))])
    data = piqp_tpu_torch.prepare_data(np.eye(2), np.zeros(2), device="cpu")
    assert data.P.device.type == "cpu" and data.P.shape == (1, 2, 2)
