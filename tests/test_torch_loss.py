"""The port's ``loss_fn`` and its gradients against the reference's
(``jax.value_and_grad``) on the reduced configs of the three model
families the trainer covers — Mamba-1 (Falcon-Mamba), dense MoE
(Mixtral) and the Mamba-2 hybrid with shared attention (Zamba2) — over
the reference's weights.

Tolerances: the loss and metrics 1e-5 relative (fp32, summed in another
order); each gradient leaf relative to its largest value, 2e-5 for
Falcon-Mamba and Mixtral (the two fp32 runs differ by under 3e-6) and
3e-4 for the Zamba2 hybrid, whose gradients (global norm ~34 at init)
carry more rounding: its two fp32 runs differ by up to 1.1e-4, and each
is 2e-4 away from a port run with float64 parameters and activations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import transformer as jtr
from repro_torch.optim import adamw as topt
from repro_torch.training import train_loop as ttl
from tests._torch_parity import build_train_pair

GRAD_TOL = {"falcon-mamba-7b": 2e-5, "mixtral-8x7b": 2e-5, "zamba2-2.7b": 3e-4}


def _batch(vocab, B, T, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (B, T)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _close_scaled(got, want, rel, name=""):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * max(scale, 1e-30), (name, err, scale)


@pytest.mark.parametrize("arch", sorted(GRAD_TOL))
def test_loss_and_grads_match_reference(arch):
    jrt, jparams, trt, tparams = build_train_pair(arch)
    tok, tgt = _batch(jrt.cfg.vocab_size, 2, 24, seed=1)
    def jloss(p):
        return jtr.loss_fn(jrt, p, jnp.asarray(tok), jnp.asarray(tgt))

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    loss, metrics, grads = ttl.loss_and_grads(trt, tparams, tok, tgt)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert sorted(metrics) == sorted(jm)
    for k in jm:
        want = np.asarray(jm[k])
        np.testing.assert_allclose(metrics[k].numpy(), want, rtol=1e-5, atol=1e-6)
    jleaves = jax.tree.leaves(jg)
    tleaves = topt.tree_leaves(grads)
    assert len(jleaves) == len(tleaves)
    for i, (w, g) in enumerate(zip(jleaves, tleaves)):
        assert tuple(g.shape) == tuple(w.shape)
        _close_scaled(g.numpy(), w, GRAD_TOL[arch], name=i)
