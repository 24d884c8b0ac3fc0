"""The port's typing stub (piqp_tpu_torch/__init__.pyi) stays consistent
with its runtime API, with the checks of tests/test_stubs.py: every stubbed
symbol exists, every stubbed dataclass attribute is a real field, every
stubbed method exists and every public __all__ name is stubbed.  Beyond
them: every name the JAX package's stub has is stubbed here, the stubbed
functions' parameters are the runtime's, in order, and the package ships
``py.typed``."""

import ast
import dataclasses
import inspect
import os

import pytest

import piqp_tpu
import piqp_tpu_torch

STUB = os.path.join(os.path.dirname(piqp_tpu_torch.__file__), "__init__.pyi")
JAX_STUB = os.path.join(os.path.dirname(piqp_tpu.__file__), "__init__.pyi")


def _stub_tree(path=STUB):
    with open(path) as f:
        return ast.parse(f.read())


def _stub_names(tree):
    names = {}
    for node in tree.body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
            names[node.name] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names[node.target.id] = node
    return names


def test_all_public_names_are_stubbed():
    names = _stub_names(_stub_tree())
    missing = [n for n in piqp_tpu_torch.__all__ if n not in names]
    assert not missing, f"public names missing from __init__.pyi: {missing}"


def test_stubbed_symbols_exist_at_runtime():
    names = _stub_names(_stub_tree())
    missing = [n for n in names if not hasattr(piqp_tpu_torch, n)]
    assert not missing, f"stubbed names absent at runtime: {missing}"


def test_stubbed_dataclass_attrs_are_real_fields():
    problems = []
    for node in _stub_tree().body:
        if not isinstance(node, ast.ClassDef):
            continue
        cls = getattr(piqp_tpu_torch, node.name, None)
        if cls is None or not dataclasses.is_dataclass(cls):
            continue
        fields = {f.name for f in dataclasses.fields(cls)}
        for item in node.body:
            if isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
                attr = item.target.id
                if attr not in fields and not hasattr(cls, attr):
                    problems.append(f"{node.name}.{attr}")
    assert not problems, f"stubbed attrs not present on runtime class: {problems}"


def test_stubbed_methods_exist():
    problems = []
    for node in _stub_tree().body:
        if not isinstance(node, ast.ClassDef):
            continue
        cls = getattr(piqp_tpu_torch, node.name, None)
        if cls is None or not inspect.isclass(cls):
            continue
        for item in node.body:
            if isinstance(item, ast.FunctionDef) and not hasattr(cls, item.name):
                problems.append(f"{node.name}.{item.name}")
    assert not problems, f"stubbed methods absent at runtime: {problems}"


def test_every_jax_stub_name_is_stubbed():
    ours = _stub_names(_stub_tree())
    missing = [n for n in _stub_names(_stub_tree(JAX_STUB)) if n not in ours]
    assert not missing, f"names of piqp_tpu/__init__.pyi missing here: {missing}"


def _stubbed_callables():
    """(name, stubbed parameter names, runtime callable) of every stubbed
    function and constructor (Settings takes **kwargs in the stub)."""
    out = []
    for node in _stub_tree().body:
        if isinstance(node, ast.FunctionDef):
            out.append((node.name, node, getattr(piqp_tpu_torch, node.name)))
        elif isinstance(node, ast.ClassDef) and node.name != "Settings":
            cls = getattr(piqp_tpu_torch, node.name)
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and item.name in ("__init__", "setup",
                                                                       "update", "solve"):
                    out.append((f"{node.name}.{item.name}", item, getattr(cls, item.name)))
    return out


@pytest.mark.parametrize("name,node,fn", _stubbed_callables(),
                         ids=[c[0] for c in _stubbed_callables()])
def test_stubbed_signatures_match(name, node, fn):
    stubbed = [a.arg for a in node.args.args + node.args.kwonlyargs]
    runtime = list(inspect.signature(fn).parameters)
    assert stubbed == runtime, name


@pytest.mark.parametrize("name", [
    "DenseSolver.__init__", "SparseSolver.__init__", "prepare_data", "solve_dense",
    "prepare_batch", "qp_layer", "random_multistage_qp", "random_multistage_batch",
])
def test_device_parameters_are_stubbed(name):
    """The entry points that put data on a device take ``device`` in the
    stub."""
    node = {n: node for n, node, _ in _stubbed_callables()}[name]
    assert "device" in [a.arg for a in node.args.args]


def test_package_ships_py_typed():
    assert os.path.exists(os.path.join(os.path.dirname(piqp_tpu_torch.__file__), "py.typed"))
