"""No module of the benchmark loads JAX or the JAX package, and the
reference's modules load nothing of the program (top-level names of
every import, compared whole)."""

import ast
from pathlib import Path

import pytest

from gpubench import harness

HERE = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "piqp_tpu"}
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
# the modules the reference's side runs: they take nothing from the program
REFERENCE = sorted(
    [HERE / n for n in ("reference.py", "problems.py", "mixes.py", "check.py", "roofline.py",
                        "byname.py")]
    + [p for p in MODULES if p.parent.name in ("generators", "modes")])


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    assert "piqp_tpu_torch" not in top_level_imports(path)


def test_the_check_sees_prefixes_whole():
    # the port's name begins with the JAX package's: compared whole, only
    # the JAX package is refused
    assert "piqp_tpu_torch" not in FORBIDDEN
    assert set(harness.FORBIDDEN) == FORBIDDEN
