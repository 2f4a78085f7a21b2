"""Weights across the two packages, and the reference's checkpoint format
(PyTorch port of ``repro.checkpoint.io``).

``params_from_numpy`` turns the reference's parameters — the nested dict of
numpy arrays that ``jax.device_get(repro.models.transformer.init_params(
...))`` returns — into the port's (tensors on a device).
``save_checkpoint`` / ``load_checkpoint`` write and read the reference's
format: a flat-key ``<path>.npz`` (keys ``params/groups/b0/w1`` ...,
``opt/...`` for the optimizer state; a list's items as ``#0``, ``#1``
...) and a ``<path>.meta`` sidecar in msgpack (``step``, ``extra``,
``keys``), read and written by ``_pack`` / ``_unpack`` here: the subset of
msgpack the reference writes (map, array, str, int, float, bool, nil), so
the port needs no msgpack package. ``load_npz`` / ``save_npz`` read and
write the parameters alone.
"""

from __future__ import annotations

import struct
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
        elif isinstance(t, int) and not isinstance(t, bool):
            t = np.int32(t)  # a host step counter, as the reference's int32
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


# ---------------------------------------------------------------------------
# The .meta sidecar: the msgpack subset the reference writes
# ---------------------------------------------------------------------------


def _pack(obj) -> bytes:
    """``msgpack.packb(obj)`` for dicts, lists / tuples, str, int, float,
    bool and None: the same bytes (the smallest encoding of each value;
    a float as float 64)."""
    if obj is None:
        return b"\xc0"
    if obj is True or obj is False:
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        if 0 <= obj < 0x80:
            return struct.pack("B", obj)
        if -32 <= obj < 0:
            return struct.pack("b", obj)
        for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (0, 0xFFFF, 0xCD, ">H"),
                                  (0, 0xFFFFFFFF, 0xCE, ">I"),
                                  (0, 2**64 - 1, 0xCF, ">Q"),
                                  (-2**7, 2**7 - 1, 0xD0, ">b"),
                                  (-2**15, 2**15 - 1, 0xD1, ">h"),
                                  (-2**31, 2**31 - 1, 0xD2, ">i"),
                                  (-2**63, 2**63 - 1, 0xD3, ">q")):
            if lo <= obj <= hi:
                return bytes([code]) + struct.pack(fmt, obj)
        raise ValueError(f"int out of msgpack's range: {obj}")
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _header(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(obj, (list, tuple)):
        return (_header(len(obj), 0x90, 15, (None, 0xDC, 0xDD))
                + b"".join(_pack(v) for v in obj))
    if isinstance(obj, dict):
        return (_header(len(obj), 0x80, 15, (None, 0xDE, 0xDF))
                + b"".join(_pack(k) + _pack(v) for k, v in obj.items()))
    raise TypeError(f"cannot pack {type(obj).__name__}")


def _header(n: int, fix: int, fix_max: int, codes) -> bytes:
    """A str / array / map length: the fix form, else the 8-, 16- or
    32-bit one (``codes``; None where the type has no 8-bit form)."""
    if n <= fix_max:
        return bytes([fix | n])
    for code, fmt, hi in zip(codes, (">B", ">H", ">I"),
                             (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= hi:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length out of msgpack's range: {n}")


def _unpack(data: bytes):
    """``msgpack.unpackb(data)`` for what ``_pack`` writes, with every int
    and float width (strings decoded as UTF-8, arrays as lists)."""
    obj, end = _read(data, 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes")
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LENGTH = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
           0xDC: (">H", "array"), 0xDD: (">I", "array"),
           0xDE: (">H", "map"), 0xDF: (">I", "map")}


def _read(data: bytes, i: int):
    c = data[i]
    i += 1
    if c <= 0x7F:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if c == 0xC0:
        return None, i
    if c in (0xC2, 0xC3):
        return c == 0xC3, i
    if c in _FIXED:
        fmt = _FIXED[c]
        return struct.unpack_from(fmt, data, i)[0], i + struct.calcsize(fmt)
    if 0xA0 <= c <= 0xBF:
        kind, n = "str", c & 0x1F
    elif 0x90 <= c <= 0x9F:
        kind, n = "array", c & 0x0F
    elif 0x80 <= c <= 0x8F:
        kind, n = "map", c & 0x0F
    elif c in _LENGTH:
        fmt, kind = _LENGTH[c]
        n = struct.unpack_from(fmt, data, i)[0]
        i += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack type 0x{c:02x} is outside the subset")
    if kind == "str":
        return data[i:i + n].decode("utf-8"), i + n
    out = [] if kind == "array" else {}
    for _ in range(n):
        if kind == "array":
            v, i = _read(data, i)
            out.append(v)
        else:
            k, i = _read(data, i)
            out[k], i = _read(data, i)
    return out, i


def save_checkpoint(path: str | Path, params, *, step: int = 0,
                    extra: dict | None = None, opt_state=None) -> Path:
    """``repro.checkpoint.io.save_checkpoint``: ``params`` (and
    ``opt_state``, under ``opt/``) to ``<path>.npz`` (bf16 tensors as
    fp32; an int leaf, the optimizer's step counter, as int32), and
    ``{"step", "extra", "keys"}`` to ``<path>.meta``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten({"params": params})
    if opt_state is not None:
        flat.update(_flatten({"opt": opt_state}))
    np.savez(str(path) + ".npz", **flat)
    meta = {"step": step, "extra": extra or {}, "keys": sorted(flat)}
    Path(str(path) + ".meta").write_bytes(_pack(meta))
    return path


def load_checkpoint(path: str | Path, device="cuda", dtype=None):
    """``repro.checkpoint.io.load_checkpoint``: returns (params, opt_state
    or None, meta), the arrays as tensors on ``device`` (floating ones cast
    to ``dtype`` when given) and the optimizer's 0-d integer step counter
    as a Python int, as the port's optimizers keep it."""
    with np.load(str(path) + ".npz") as data:
        tree = _unflatten({k: data[k] for k in data.files})
    meta = _unpack(Path(str(path) + ".meta").read_bytes())
    opt = tree.get("opt")
    if opt is not None:
        opt = {k: (int(v) if k == "step" else params_from_numpy(v, device))
               for k, v in opt.items()}
    return params_from_numpy(tree.get("params"), device, dtype), opt, meta
