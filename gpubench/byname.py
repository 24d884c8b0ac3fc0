"""The benchmark's parts found by name: ``<folder>/<name>.py`` under this
folder, for a configuration's ``generator`` (``generators/``) and
``entry`` (``entries/``), a traffic file's ``mode`` (``modes/``) and each
metric of ``BENCHMARK.json`` (``metrics/``).  A later cell adds its parts
as new files there and edits none.  This module imports the standard
library only."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent
_LOADED: dict = {}


def load(folder: str, name: str):
    """The module ``<folder>/<name>.py``, loaded once a process."""
    key = (folder, name)
    if key not in _LOADED:
        path = HERE / folder / f"{name}.py"
        if not path.is_file():
            raise SystemExit(f"gpubench: no {folder[:-1]} named {name!r} ({path} is missing)")
        spec = importlib.util.spec_from_file_location(
            f"gpubench_{folder}_{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[key] = module
    return _LOADED[key]
