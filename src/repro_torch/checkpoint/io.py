"""Weights across the two packages, and the reference's checkpoint format.

``params_from_numpy`` turns the reference's parameters — the nested dict of
numpy arrays that ``jax.device_get(repro.models.transformer.init_params(
...))`` returns — into the port's (tensors on a device). ``load_npz`` /
``save_npz`` read and write the flat-key ``.npz`` that
``repro.checkpoint.io.save_checkpoint`` writes (keys ``params/groups/b0/
w1`` ...); the reference's msgpack metadata sidecar is not read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch


def _to_tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cuda", dtype=None) -> Any:
    """Nested dict / list of numpy arrays -> the same structure of tensors on
    ``device``; floating arrays are cast to ``dtype`` when given."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    return _to_tensor(tree, device, dtype)


def _flatten(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        t = tree.detach().cpu() if torch.is_tensor(tree) else tree
        if torch.is_tensor(t):
            t = t.float() if t.dtype == torch.bfloat16 else t
            t = t.numpy()
        out[prefix.rstrip("/")] = np.asarray(t)
    return out


def _unflatten(flat: dict) -> Any:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def save_npz(path: str | Path, params) -> Path:
    """Write ``params`` as ``<path>.npz`` under the reference's flat keys
    (``params/...``; bf16 tensors are stored as fp32)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(str(path) + ".npz", **_flatten({"params": params}))
    return path


def load_npz(path: str | Path, device="cuda", dtype=None):
    """Read ``<path>.npz`` (the reference's or ``save_npz``'s) and return
    its ``params`` tree as tensors on ``device``."""
    with np.load(str(path) + ".npz") as data:
        tree = _unflatten({k: data[k] for k in data.files})
    return params_from_numpy(tree.get("params"), device, dtype)
