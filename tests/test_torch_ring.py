"""The port's sliding-window ring cache against the reference's: ring
decode attention, a windowed prefill past the window with decode steps
after it, and windowed serving through the dense slot pool."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import transformer as jtr
from repro.serving.api import Request as JRequest
from repro.serving.runtime import ServingRuntime as JRuntime
from repro_torch.models import attention as TA
from repro_torch.models import transformer as ttr
from repro_torch.serving.api import Request
from repro_torch.serving.runtime import ServingRuntime
from tests._torch_parity import build_pair, prompts, to_numpy, variant_pair

TOL = dict(rtol=1e-4, atol=1e-4)
WINDOW = 16


@pytest.mark.parametrize("pos", [[3, 15], [16, 40], [17, 100]])
def test_ring_decode_attention_matches_reference(pos):
    """A ring of 16 slots read at positions before, at and past one wrap,
    two rows at different positions: the reference's masking, within
    1e-4."""
    rng = np.random.default_rng(sum(pos))
    q = rng.standard_normal((2, 1, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, WINDOW, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, WINDOW, 2, 32)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(p), ring=True)
    got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(p),
                              ring=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def pair():
    return build_pair("mixtral-8x7b", "ep", max_len=64)


def test_windowed_prefill_then_decode_matches_reference(pair):
    """A 40-token prefill at window 16 into a 48-position cache (a ring of
    16, rolled by 40 % 16), then six decode steps, two rows at once: the
    logits within 1e-4 and the ring caches equal the reference's after
    every step."""
    jeng, teng = pair
    jrt = dataclasses.replace(jeng.rt, window=WINDOW)
    trt = dataclasses.replace(teng.rt, window=WINDOW)
    toks = prompts(teng.rt.cfg.vocab_size, 2, 46, seed=7)
    T = 40
    jl, jc, _ = jtr.prefill(jrt, jeng.params, tokens=jnp.asarray(toks[:, :T]),
                            placement=jeng.placement, cache_len=48)
    tl, tc, _ = ttr.prefill(trt, teng.params, toks[:, :T],
                            placement=teng.placement, cache_len=48)
    assert next(iter(tc.values()))["k"].shape[2] == WINDOW
    for step in range(7):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        want = to_numpy(jc)
        for name, leaves in tc.items():
            for leaf, val in leaves.items():
                np.testing.assert_allclose(val.numpy(), want[name][leaf],
                                           **TOL)
        if step == 6:
            break
        cur = toks[:, T + step:T + step + 1]
        jl, jc, _ = jtr.decode_step(jrt, jeng.params, jc, jnp.asarray(cur),
                                    jnp.int32(T + step), jeng.placement)
        tl, tc, _ = ttr.decode_step(trt, teng.params, tc, cur, T + step,
                                    teng.placement)


def test_windowed_runtime_tokens_equal_reference(pair):
    """Exact: the windowed runtime takes the dense slot pool (a paged pool
    refuses the window, as the reference's does) and its token streams
    equal the reference runtime's: prompts of 24 and 9 tokens at window 16,
    10 new tokens each, so the ring wraps, one request sampled."""
    jeng, teng = variant_pair(*pair, window=WINDOW)
    assert not ttr.supports_paging(teng.rt)
    with pytest.raises(ValueError, match="dense slot pool"):
        ttr.init_paged_cache(teng.rt, 4, 8)
    vocab = teng.rt.cfg.vocab_size
    reqs = [(p, 0.0, 0) for p in prompts(vocab, 2, 24, seed=8)] + [
        (prompts(vocab, 1, 9, seed=9)[0], 0.9, 5)]

    def serve(runtime_cls, request_cls, engine):
        rt = runtime_cls(engine, max_slots=2)
        hs = [rt.enqueue(request_cls(prompt=p, max_new_tokens=10,
                                     temperature=t, seed=s))
              for p, t, s in reqs]
        rt.run()
        return [h.result().tolist() for h in hs], rt

    want, _ = serve(JRuntime, JRequest, jeng)
    got, rt = serve(ServingRuntime, Request, teng)
    assert not rt.paged
    assert next(iter(rt.pool.values()))["k"].shape[2] == WINDOW
    assert got == want
