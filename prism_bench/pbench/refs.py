"""Loads a configuration's plain reference, ``reference/<name>.py``."""

from __future__ import annotations

import importlib.util
from pathlib import Path


def reference_for(root: Path, conf: dict):
    name = conf["reference"]
    spec = importlib.util.spec_from_file_location(
        "pbench_reference_" + name, root / "reference" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
