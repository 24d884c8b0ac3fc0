"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package and initialises no torch.distributed process group, no source
file under piqp_tpu_torch/ imports either package (its C library
``capi/capi.cpp`` included), nor do the port's examples
(``examples/torch_*.py``) or ``chip_smoke.py``, and its entry points never
fall back to the CPU on their own.  It exports every name the JAX package
does."""

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


PY_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|piqp_tpu)(\.|\s|$)", re.M)
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


@pytest.mark.parametrize("path", EXAMPLES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: p.name)
def test_examples_and_chip_smoke_import_no_jax(path):
    assert not PY_IMPORT.search(path.read_text())


def test_examples_load_without_jax():
    """Importing every port example loads neither JAX nor the JAX package."""
    assert len(EXAMPLES) == 3
    code = (
        "import importlib.util, sys\n"
        "for i, path in enumerate(sys.argv[1:]):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'piqp_tpu' or m.startswith('piqp_tpu.')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code, *map(str, EXAMPLES)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_capi_imports_only_the_port():
    """The C library imports the port, numpy and scipy.sparse, and no
    module of JAX or of the JAX package."""
    src = (PKG / "capi" / "capi.cpp").read_text()
    imported = set(re.findall(r'\bimport\("([\w.]+)"\)', src))
    imported |= set(re.findall(r'PyImport_ImportModule\("([\w.]+)"\)', src))
    assert imported == {"piqp_tpu_torch", "piqp_tpu_torch.capi", "numpy", "scipy.sparse"}
    assert not re.search(r'"(jax|piqp_tpu)(\.[\w.]*)?"', src)


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
