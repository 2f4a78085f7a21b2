"""Optimizers over nested dicts of tensors (PyTorch port of
``repro.optim.adamw``).

* ``adamw``     — standard AdamW.
* ``adafactor`` — factored second moments (Shazeer & Stern).

Moments are fp32, as in the reference. Unlike the reference's pure
functions, ``update`` and ``clip_by_global_norm`` work in place: the
parameters, the moments and the gradients are overwritten and returned
(at Falcon-Mamba-7B width a second copy of the parameters or the gradients
would cost gigabytes). Leaves are visited in the reference's order (dict
keys sorted), so per-leaf state lists line up with ``jax.tree.leaves``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # (grads, state, params) -> (params, state), both updated in place
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def tree_leaves(tree) -> list:
    """Leaves of a nested dict / list in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every leaf; the same nesting of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_unflatten(tree, leaves: list):
    """``tree``'s nesting with its leaves replaced, in ``tree_leaves``
    order, by ``leaves``."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [fill(v) for v in node]
        return next(it)

    return fill(tree)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup then cosine decay; ``lr(step)`` is a Python float
    computed in fp32, as the reference computes it."""
    f32 = np.float32

    def lr(step):
        s = f32(step)
        warm = s / f32(max(warmup, 1))
        prog = (s - f32(warmup)) / f32(max(total - warmup, 1))
        prog = np.clip(prog, f32(0), f32(1))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * prog))
        return float(f32(base_lr) * (warm if s < warmup else cos))

    return lr


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place so that their global L2 norm is at most
    ``max_norm``. Returns (grads, norm before clipping as a 0-d fp32 tensor
    on the gradients' device)."""
    leaves = tree_leaves(grads)
    g2 = sum(torch.sum(torch.square(g.float())) for g in leaves)
    norm = torch.sqrt(g2)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale.to(g.dtype))
    return grads, norm


def adamw(
    lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01, schedule=None
) -> Optimizer:
    lr_fn = schedule if schedule is not None else (lambda s: lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
        moments = zip(tree_leaves(state["m"]), tree_leaves(state["v"]))
        for g, (m, v), p in zip(tree_leaves(grads), moments, tree_leaves(params)):
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            delta.add_(p.float(), alpha=weight_decay)
            p.copy_(p.float().sub_(delta.mul_(lr_t)))
        return params, {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer(init=init, update=update)


def adafactor(
    lr=1e-2, decay=0.8, eps=1e-30, clip_threshold=1.0, schedule=None
) -> Optimizer:
    """Factored second-moment optimizer (memory ~ O(rows + cols))."""
    lr_fn = schedule if schedule is not None else (lambda s: lr)

    def _leaf_state(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if p.ndim >= 2:
            return {
                "vr": torch.zeros(p.shape[:-1], **f32),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32),
            }
        return {"v": torch.zeros(p.shape, **f32)}

    def init(params):
        # per-leaf factored states as a flat list (leaf order of the tree)
        return {"f": [_leaf_state(p) for p in tree_leaves(params)], "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        beta = float(np.float32(1) - np.float32(step) ** np.float32(-decay))
        lr_t = lr_fn(step)
        for g, s, p in zip(tree_leaves(grads), state["f"], tree_leaves(params)):
            g = g.float()
            g2 = g * g + eps
            if p.ndim >= 2:
                s["vr"].mul_(beta).add_(g2.mean(-1), alpha=1 - beta)
                s["vc"].mul_(beta).add_(g2.mean(-2), alpha=1 - beta)
                denom = torch.clamp(s["vr"].mean(-1, keepdim=True), min=eps)
                pre = (s["vr"] / denom)[..., None] * s["vc"][..., None, :]
                u = g * torch.rsqrt(torch.clamp(pre, min=eps))
            else:
                s["v"].mul_(beta).add_(g2, alpha=1 - beta)
                u = g * torch.rsqrt(torch.clamp(s["v"], min=eps))
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p.copy_(p.float() - lr_t * u)
        return params, {"f": state["f"], "step": step}

    return Optimizer(init=init, update=update)
