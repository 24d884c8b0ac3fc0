"""Shared fixtures of the benchmark's own tests: the cells at a size the
CPU holds (each configuration file's ``tiny``), and the ``card`` marker
for tests that need a CUDA device."""

import json
from pathlib import Path

import pytest

from gpubench import harness

def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def tiny_bench(tmp_path) -> Path:
    """``BENCHMARK.json`` with every configuration cut to its ``tiny`` size
    (the keys it names replace the configuration's; ``check`` is merged, so
    the limits stay)."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        config = json.loads((harness.ROOT / entry["file"]).read_text())
        tiny = config.pop("tiny")
        config["check"].update(tiny.pop("check", {}))
        config.update(tiny)
        path = tmp_path / f"{entry['name']}.json"
        path.write_text(json.dumps(config))
        entry["file"] = str(path)
    out = tmp_path / "BENCHMARK.json"
    out.write_text(json.dumps(bench))
    return out


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
