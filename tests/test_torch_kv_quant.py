"""The port's int8 KV layout against the reference's (``tests/
test_kv_quant.py``): ``quantize_kv`` codes and scales, the reference's
int8-decode cases on its own weights, and int8 serving through the paged
and the dense pool, the warmed loop included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as JA
from repro.models import transformer as jtr
from repro.serving.api import Request as JRequest
from repro.serving.runtime import ServingRuntime as JRuntime
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.models import attention as TA
from repro_torch.models import transformer as ttr
from repro_torch.serving.api import Request
from repro_torch.serving.runtime import ServingRuntime
from tests._torch_parity import build_pair, prompts, to_numpy, variant_pair

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_codes_equal_and_scales_within_one_ulp(dtype):
    """Codes exact, bf16 scales within one ulp, and the dequantized values
    equal given equal scales."""
    x = np.random.default_rng(0).standard_normal((2, 8, 4, 64)) * 3
    jx = jnp.asarray(x, jnp.float32).astype(dtype)
    j8, js = JA.quantize_kv(jx)
    t8, ts = TA.quantize_kv(torch.tensor(np.asarray(jx.astype(jnp.float32)))
                            .to(getattr(torch, dtype)))
    assert t8.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(ts.shape) == (2, 8, 4, 1)
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    jsf = np.asarray(js.astype(jnp.float32))
    np.testing.assert_allclose(ts.float().numpy(), jsf, rtol=2.0**-7, atol=0)
    back = TA.dequantize_kv(t8, ts, torch.float32).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(JA.dequantize_kv(j8, js, jnp.float32)))


@pytest.mark.parametrize("name,window", [
    ("tinyllama-1.1b", 0), ("tinyllama-1.1b", 16), ("zamba2-2.7b", 0),
])
def test_int8_decode_close_to_fp(name, window):
    """The reference's case (prefill 24 tokens into an int8 cache of 32,
    at window 16 a ring of 16, then one decode step), port against
    reference on the same weights: the full-precision prefill logits
    within 1e-4; the int8 prefill cache's codes within one step of the
    reference's and nearly all equal, its scales within one bf16 ulp (an
    fp32 difference in k of one ulp moves ``x / scale`` across a rounding
    boundary now and then, and one code step moves a logit by about
    2e-4); the port's decode step on the reference's int8 cache within
    1e-4 of the reference's; and the port's own int8 decode within the
    reference's 6 % of the full-precision logits."""
    cfg = get_config(name).reduced()
    jrt_f = jtr.Runtime(cfg=cfg, window=window)
    jrt_q = jtr.Runtime(cfg=cfg, window=window, kv_quant=True)
    key = jax.random.PRNGKey(1)
    jparams = jtr.init_params(jrt_f, key)
    B, T = 2, 24
    toks = np.asarray(jax.random.randint(key, (B, T + 1), 0, cfg.vocab_size))
    jfull, _, _ = jtr.prefill(jrt_f, jparams, tokens=jnp.asarray(toks))
    _, jcq, _ = jtr.prefill(jrt_q, jparams, tokens=jnp.asarray(toks[:, :T]),
                            cache_len=T + 8)
    jcache = to_numpy(jcq)
    jdq, _, _ = jtr.decode_step(jrt_q, jparams, jcq,
                                jnp.asarray(toks[:, T:T + 1]), jnp.int32(T))

    tcfg = tget_config(name).reduced()
    trt_f = ttr.Runtime(cfg=tcfg, window=window, device="cpu")
    trt_q = ttr.Runtime(cfg=tcfg, window=window, kv_quant=True, device="cpu")
    tparams = params_from_numpy(to_numpy(jparams), "cpu")
    tfull, _, _ = ttr.prefill(trt_f, tparams, toks)
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), **TOL)
    _, tcq, _ = ttr.prefill(trt_q, tparams, toks[:, :T], cache_len=T + 8)
    ab = next(k for k in tcq if "k" in tcq[k])
    assert tcq[ab]["k"].dtype == torch.int8 and "k_scale" in tcq[ab]
    assert tcq[ab]["k"].shape[2] == (16 if window else T + 8)
    for ln, leaves in tcq.items():
        if "k" not in leaves:        # a Mamba layer's states
            continue
        for n in ("k", "v"):
            got = leaves[n].numpy().astype(np.int32)
            want = jcache[ln][n].astype(np.int32)
            assert np.abs(got - want).max() <= 1
            assert np.mean(got == want) > 0.999
            np.testing.assert_allclose(
                leaves[n + "_scale"].float().numpy(),
                jcache[ln][n + "_scale"].astype(np.float32), rtol=2.0**-7,
                atol=0)
    on_ref = params_from_numpy(jcache, "cpu")
    tdq_ref, _, _ = ttr.decode_step(trt_q, tparams, on_ref,
                                    toks[:, T:T + 1], T)
    np.testing.assert_allclose(tdq_ref.numpy(), np.asarray(jdq), **TOL)
    tdq, tcq2, _ = ttr.decode_step(trt_q, tparams, tcq, toks[:, T:T + 1], T)
    full = tfull.numpy()
    rel = np.abs(full - tdq.numpy()).max() / np.abs(full).max()
    assert rel < 0.06, (name, window, rel)
    assert tcq2[ab]["k"].dtype == torch.int8


@pytest.fixture(scope="module")
def int8_pair():
    jeng, teng = build_pair("mixtral-8x7b", "ep", max_len=64)
    return variant_pair(jeng, teng, kv_quant=True)


def _requests(vocab):
    """Four prompts of 20 tokens (the second shares 16 with the first),
    the last one sampled."""
    ps = prompts(vocab, 4, 20, seed=3)
    ps[1][:16] = ps[0][:16]
    return [(p, 0.7 if k == 3 else 0.0, 9 * k) for k, p in enumerate(ps)]


def _serve(runtime_cls, request_cls, engine, reqs, then=(), **kw):
    """Serve ``reqs`` to the end, then ``then`` on the same runtime."""
    rt = runtime_cls(engine, max_slots=2, block_size=8, **kw)
    hs = []
    for wave in (reqs, then):
        hs += [rt.enqueue(request_cls(prompt=p, max_new_tokens=8,
                                      temperature=t, seed=s))
               for p, t, s in wave]
        rt.run()
    return [h.result().tolist() for h in hs], rt


@pytest.mark.parametrize("pool", ["paged", "dense"])
def test_int8_runtime_tokens_equal_reference(int8_pair, pool):
    """Exact: int8 serving on the reduced Mixtral gives the reference
    runtime's token streams, on the paged pool (chunked prefill over the
    int8 pages, the prefix cache) and on the dense pool; the engines force
    the serve-consistent prefill."""
    jeng, teng = int8_pair
    assert teng.rt.kv_quant_consistent and jeng.rt.kv_quant_consistent
    reqs = _requests(teng.rt.cfg.vocab_size)
    kw = {"paged": pool == "paged"}
    want, _ = _serve(JRuntime, JRequest, jeng, reqs, **kw)
    got, rt = _serve(ServingRuntime, Request, teng, reqs, **kw)
    assert got == want
    leaf = next(iter(rt.pool.values()))
    assert leaf["k"].dtype == torch.int8 and leaf["k_scale"].dtype == torch.bfloat16


def test_int8_warm_loop_equals_sync_loop(int8_pair):
    """Exact: the warmed loop on an int8 paged pool (a copy-on-write clone
    of a shared tail included) gives the synchronous loop's tokens."""
    _, teng = int8_pair
    reqs = _requests(teng.rt.cfg.vocab_size)
    again = [reqs[2]]            # a full prefix hit on a 20-token prompt
    sync, _ = _serve(ServingRuntime, Request, teng, reqs, again)
    warm, rt = _serve(ServingRuntime, Request, teng, reqs, again,
                      warmup=True)
    assert warm == sync
    assert rt.cow_copies >= 1 and rt.prefix_hits >= 1


def test_int8_pools_and_block_copy():
    """The int8 layouts' shapes and types; ``copy_pool_block`` copies the
    scales with the codes."""
    cfg = tget_config("mixtral-8x7b").reduced()
    pool = TA.init_paged_kv(cfg, 5, 8, quantized=True, device="cpu")
    assert pool["k"].dtype == torch.int8 and pool["v_scale"].shape == (
        5, 8, cfg.num_kv_heads, 1)
    for a in pool.values():
        a[3] = torch.arange(a[3].numel()).reshape(a[3].shape).to(a.dtype)
    TA.copy_pool_block(pool, 3, 1)
    for a in pool.values():
        assert torch.equal(a[1], a[3])
    dense = TA.init_attn_cache(cfg, 2, 40, window=16, quantized=True,
                               device="cpu")
    assert dense["k"].shape == (2, 16, cfg.num_kv_heads, cfg.hd)
    assert dense["k_scale"].dtype == torch.bfloat16
