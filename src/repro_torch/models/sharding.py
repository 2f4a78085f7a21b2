"""Sharding rules (PyTorch port of ``repro.models.sharding``): which virtual
device of a mesh owns which slice of every parameter and cache leaf.

A spec is a tuple with one entry per leading dimension of its leaf (the
reference's ``PartitionSpec``): ``None`` (replicated), an axis name, or a
tuple of axis names (the dimension split over their product, the first
axis major). Missing trailing entries are ``None``. Convention: the
tensor/expert-parallel axis is named ``model``; the other axes (``pod``,
``data``) shard the batch (and the sequence for long-context decode).

On one card nothing moves: every leaf stays whole in HBM. The specs say
what one device of the reference's mesh would hold, which the dry run
records as per-device argument bytes (``device_bytes``). ``VirtualMesh``
and ``make_test_mesh`` live here, beside the rules that read a mesh, so
the model layer needs nothing of the launch tooling (``launch.mesh``
re-exports them). Not ported:
``shardings`` and ``constrain`` (they attach ``NamedSharding``s for jit).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ATTN, MAMBA1, MAMBA2, MLP, MOE, SHARED_ATTN

M = "model"


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    """Axis names and sizes of a device mesh, major axis first (the
    reference's ``Mesh.axis_names`` and ``Mesh.devices.shape``)."""

    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes "
                             f"{self.axis_sizes}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_test_mesh(data: int = 1, model: int = 1) -> VirtualMesh:
    return VirtualMesh(("data", "model"), (data, model))


def batch_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a != M)


# per-leaf specs for each block kind (unstacked; layer groups prepend None)
_ATTN = {
    "norm": (), "wq": (None, M), "wk": (None, M), "wv": (None, M),
    "wo": (M, None), "bq": (M,), "bk": (M,), "bv": (M,),
}
_MLP = {"norm": (), "w1": (None, M), "w3": (None, M), "w2": (M, None)}
_MAMBA1 = {
    "norm": (), "in_proj": (None, M), "conv_w": (M, None), "conv_b": (M,),
    "x_proj": (M, None), "dt_proj": (None, M), "dt_bias": (M,),
    "A_log": (M, None), "D": (M,), "out_proj": (M, None),
}
_MAMBA2 = {
    "norm": (), "in_zx": (None, M), "in_bc": (), "in_dt": (None, M),
    "conv_w": (M, None), "conv_b": (M,), "conv_bc_w": (), "conv_bc_b": (),
    "dt_bias": (M,), "A_log": (M,), "D": (M,), "gnorm": (M,),
    "out_proj": (M, None),
}


def _moe_specs(ep_axes) -> dict:
    e = tuple(ep_axes)
    return {"norm": (), "router": (),
            "w1": (e, None, None, None), "w3": (e, None, None, None),
            "w2": (e, None, None, None)}


def _moe_dense_specs() -> dict:
    return {"norm": (), "router": (),
            "w1": (None, None, M), "w3": (None, None, M),
            "w2": (None, M, None)}


def block_pspecs(kind: str, *, moe_impl: str = "ep",
                 ep_axes=("model",)) -> dict:
    if kind in (ATTN, SHARED_ATTN):
        return dict(_ATTN)
    if kind == MLP:
        return dict(_MLP)
    if kind == MOE:
        return _moe_specs(ep_axes) if moe_impl == "ep" else _moe_dense_specs()
    if kind == MAMBA1:
        return dict(_MAMBA1)
    if kind == MAMBA2:
        return dict(_MAMBA2)
    raise ValueError(kind)


def _replicate_all(tree):
    if isinstance(tree, dict):
        return {k: _replicate_all(v) for k, v in tree.items()}
    return ()


def param_pspecs(rt) -> dict:
    """Spec tree mirroring ``init_params`` output. Layout 'cp'
    (context-parallel) replicates every weight; layout 'fsdp' shards the
    embedding over d_model and the head over its rows."""
    cfg = rt.cfg
    pattern, _ = cfg.layer_pattern()
    groups = {}
    for i, kind in enumerate(pattern):
        if kind == SHARED_ATTN:
            continue
        blk = block_pspecs(kind, moe_impl=rt.moe_impl, ep_axes=rt.ep_axes)
        groups[f"b{i}"] = {k: (None,) + v for k, v in blk.items()}
    out = {"embed": (M, None), "final_norm": (), "groups": groups}
    if not cfg.tie_embeddings:
        out["lm_head"] = (None, M)
    if SHARED_ATTN in pattern:
        out["shared_attn"] = dict(_ATTN)
    if rt.layout == "cp":
        return _replicate_all(out)
    if rt.layout == "fsdp":
        out["embed"] = (None, M)
        if "lm_head" in out:
            out["lm_head"] = (M, None)
    return out


def _prune_to(params, specs):
    """Keep only spec entries whose param exists (e.g. optional biases)."""
    if isinstance(params, dict):
        return {k: _prune_to(params[k], specs[k]) for k in params}
    return specs


def pspecs_for(rt, params) -> dict:
    return _prune_to(params, param_pspecs(rt))


def cache_pspecs(rt, *, seq_sharded: bool = False) -> dict:
    """Spec tree mirroring ``init_cache`` output (leading group dim on
    all)."""
    cfg = rt.cfg
    pattern, _ = cfg.layer_pattern()
    b = batch_axes(rt.mesh) if rt.mesh is not None else ()
    if seq_sharded:
        # long-context, batch 1: flash-decoding over the whole mesh
        kv_spec = (None, None, b + (M,), None, None)
    else:
        # batch over the data axes, sequence over model (flash-decoding)
        kv_spec = (None, b, M, None, None)
    attn_spec = {"k": kv_spec, "v": kv_spec}
    if rt.kv_quant:
        attn_spec["k_scale"] = kv_spec
        attn_spec["v_scale"] = kv_spec
    m1 = {"conv": (None, b, None, M), "ssm": (None, b, M, None)}
    m2 = {"conv_x": (None, b, None, M), "conv_bc": (None, b, None, None),
          "ssm": (None, b, M, None, None)}
    out = {}
    for i, kind in enumerate(pattern):
        if kind in (ATTN, SHARED_ATTN):
            out[f"b{i}"] = dict(attn_spec)
        elif kind == MAMBA1:
            out[f"b{i}"] = dict(m1)
        elif kind == MAMBA2:
            out[f"b{i}"] = dict(m2)
    return out


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry (``None``, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _feasible_spec(mesh, shape, spec) -> tuple:
    """Drop sharding on any dim the array size can't evenly divide. An
    empty axis tuple is ``None``, as the reference's ``PartitionSpec``
    reads it."""
    sizes = mesh.shape
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for dim, s in zip(shape, spec):
        axes = entry_axes(s)
        n = math.prod(sizes[a] for a in axes)
        out.append(s if axes and dim % n == 0 and dim >= n else None)
    return tuple(out)


def local_shape(mesh, shape, spec) -> tuple:
    """One device's block of a leaf of ``shape`` under ``spec`` (after
    ``_feasible_spec``)."""
    sizes = mesh.shape
    return tuple(d // math.prod(sizes[a] for a in entry_axes(s))
                 for d, s in zip(shape, _feasible_spec(mesh, shape, spec)))


def _pairs(tree, specs):
    """(leaf, spec) pairs of a tree and its spec tree; a spec tree that
    stops at a dict or list of leaves gives its spec to all of them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pairs(tree[k], specs[k] if isinstance(specs, dict)
                              else specs)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _pairs(v, specs[i] if isinstance(specs, list)
                              else specs)
    else:
        yield tree, specs


def device_bytes(tree, specs, mesh) -> int:
    """Bytes one device of ``mesh`` holds of ``tree`` (tensors; other
    leaves hold none) under the spec tree ``specs`` (a feasible block of
    every leaf; the reference's ``memory_analysis()`` per-device argument
    size). A leaf whose spec is ``None`` is not counted: a step argument
    that the step never reads, which jit drops."""
    total = 0
    for t, spec in _pairs(tree, specs):
        if torch.is_tensor(t) and spec is not None:
            total += (math.prod(local_shape(mesh, tuple(t.shape), spec))
                      * t.element_size())
    return total
