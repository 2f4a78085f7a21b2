"""Loads the modules a configuration file names: its plain reference,
``reference/<name>.py`` (key ``reference``), and the system module that
serves it, ``systems/<name>.py`` (key ``system``; ``systems/default.py``
where the file names none).

A system module holds what is particular to a model's architecture:
``sizes(conf) -> dict`` (at least ``layers``, ``d``, ``experts``,
``top_k``, ``ff``, ``vocab`` and ``dtype``), ``build_engine(conf, seed,
max_len, device)`` returning the port's ``ServingEngine``, and the
yardstick's arithmetic ``prompt_flops(s, prompt_len, skipped)``,
``decode_flops(s, prompt_len, k)`` and ``gmm_least_seconds(s, counts)``.
The loop, the traffic, the cluster and placement, the checks, the readers
and the trace are shared by every configuration.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_SYSTEM = "default"


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_for(root: Path, conf: dict):
    name = conf["reference"]
    return _load(root / "reference" / f"{name}.py",
                 "pbench_reference_" + name)


def system_path(root: Path, conf: dict) -> Path:
    return root / "systems" / f"{conf.get('system', DEFAULT_SYSTEM)}.py"


def system_for(root: Path, conf: dict):
    path = system_path(root, conf)
    return _load(path, "pbench_system_" + path.stem)
