"""Every assigned architecture through both packages at ``.reduced()`` size,
over the reference's ``init_params(PRNGKey(0))`` weights: prefill logits
(through ``embeds`` for the vlm and audio frontends, whose modality stub
feeds pre-computed embeddings) and one decode step's logits within 1e-4 of
the largest logit (fp32, the same arithmetic summed in another order),
greedy next tokens equal, and one AdamW train step's loss within 1e-5
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.dryrun import ASSIGNED_ARCHS
from repro.optim import adamw as jopt
from repro.training import train_loop as jtl
from repro_torch.launch import dryrun as tdryrun
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw as topt
from repro_torch.training import train_loop as ttl
from tests._torch_parity import build_train_pair, prompts

from repro.models import transformer as jtr

B, T = 2, 12
REL = 1e-4


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


def test_the_port_assigns_the_reference_archs():
    assert tdryrun.ASSIGNED_ARCHS == ASSIGNED_ARCHS


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_prefill_decode_and_train_step_match_the_reference(arch):
    jrt, jparams, trt, tparams = build_train_pair(arch)
    cfg = jrt.cfg
    toks = prompts(cfg.vocab_size, B, T, seed=5)
    if cfg.frontend != "none":
        emb = (np.random.default_rng(6).normal(size=(B, T, cfg.d_model))
               * 0.02).astype(np.float32)
        jl, jc, _ = jtr.prefill(jrt, jparams, embeds=jnp.asarray(emb),
                                cache_len=T + 4)
        tl, tc, _ = ttr.prefill(trt, tparams, embeds=torch.from_numpy(emb),
                                cache_len=T + 4)
    else:
        jl, jc, _ = jtr.prefill(jrt, jparams, tokens=jnp.asarray(toks),
                                cache_len=T + 4)
        tl, tc, _ = ttr.prefill(trt, tparams, toks, cache_len=T + 4)
    _close(tl.numpy(), jl)
    nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    np.testing.assert_array_equal(tl.argmax(-1).numpy()[:, None], nxt)

    jl2, _, _ = jtr.decode_step(jrt, jparams, jc, jnp.asarray(nxt),
                                jnp.int32(T))
    tl2, _, _ = ttr.decode_step(trt, tparams, tc, nxt, T)
    _close(tl2.numpy(), jl2)
    np.testing.assert_array_equal(tl2.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jl2, -1)))

    tgt = np.roll(toks, -1, 1)
    jstep = jax.jit(jtl.make_train_step(jrt, jopt.adamw(lr=1e-3)))
    _, _, jm = jstep(jparams, jopt.adamw(lr=1e-3).init(jparams),
                     jnp.asarray(toks), jnp.asarray(tgt))
    topt_ = topt.adamw(lr=1e-3)
    _, _, tm = ttl.make_train_step(trt, topt_)(tparams, topt_.init(tparams),
                                               toks, tgt)
    jloss, tloss = float(jm["loss"]), float(tm["loss"])
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss), (tloss, jloss)
