"""Training step / loop (PyTorch port of ``repro.training.train_loop``):
causal-LM loss + MoE aux losses, one backward pass over the parameter
leaves, global-norm clipping, then the optimizer's in-place update."""

from __future__ import annotations

import time

import torch

from repro_torch.models import transformer as tr
from repro_torch.optim.adamw import (
    Optimizer,
    clip_by_global_norm,
    tree_leaves,
    tree_unflatten,
)


def loss_and_grads(
    rt: tr.Runtime, params, tokens, targets, placement=None, aux_weight: float = 0.01
):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: returns (loss,
    metrics, grads), the loss and metrics detached, ``grads`` shaped like
    ``params`` (zeros for a leaf the loss does not reach). Marks every
    parameter leaf as requiring a gradient."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = tr.loss_fn(
            rt, params, tokens, targets, placement=placement, aux_weight=aux_weight
        )
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(
    rt: tr.Runtime, opt: Optimizer, *, max_grad_norm: float = 1.0, aux_weight=0.01
):
    """Returns train_step(params, opt_state, tokens, targets, placement) ->
    (params, opt_state, metrics); params and opt_state are updated in
    place, the metrics are 0-d tensors on the device (no host sync)."""

    def train_step(params, opt_state, tokens, targets, placement=None):
        loss, metrics, grads = loss_and_grads(
            rt, params, tokens, targets, placement, aux_weight
        )
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        params, opt_state = opt.update(grads, opt_state, params)
        out = {"loss": loss, "grad_norm": gnorm, "ce_loss": metrics["ce_loss"]}
        if "aux_loss" in metrics:
            out["aux_loss"] = metrics["aux_loss"]
            out["local_frac"] = metrics["local_frac"]
        return params, opt_state, out

    return train_step


def train_loop(
    rt: tr.Runtime, params, opt: Optimizer, batches, *, placement=None, log_every=10
):
    """batches: iterable of (tokens, targets). Returns (params, opt_state,
    history); history holds the logged steps' metrics as floats plus
    ``step`` and ``wall``."""
    step_fn = make_train_step(rt, opt)
    opt_state = opt.init(params)
    history = []
    t0 = time.time()
    for i, (tokens, targets) in enumerate(batches):
        params, opt_state, m = step_fn(params, opt_state, tokens, targets, placement)
        if i % log_every == 0 or i < 3:
            m = {k: float(v) for k, v in m.items()}
            m["step"] = i
            m["wall"] = time.time() - t0
            history.append(m)
    return params, opt_state, history
