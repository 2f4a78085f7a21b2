"""The port's seeded Gumbel-max sampler (``repro_torch.serving.sampling``)
against the reference's (``repro.serving.sampling``, ``jax.random``):
threefry keys, random bits and uniforms exactly equal to JAX's, the Gumbel
noise within 2 ulp (XLA's ``log`` and PyTorch's differ in the last bit),
and the sampled token ids equal; then a sampled ``WorkloadSpec`` stream
served by either package's ``EdgeCluster("runtime")``, and the port's
warmed loop against its synchronous one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import cluster as JC
from repro.serving import sampling as JS
from repro.serving import workload as JW
from repro_torch.serving import cluster as TC
from repro_torch.serving import sampling as TS
from repro_torch.serving import workload as TW
from repro_torch.serving.api import Request
from repro_torch.serving.runtime import ServingRuntime
from tests._torch_parity import build_pair, prompts

SEEDS = np.array([0, 1, 12345, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
POSITIONS = np.array([0, 7, 2**20, 3, 2**20 - 1, 65536], np.uint32)
V = 1000
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_keys():
    return jax.vmap(lambda s, p: jax.random.fold_in(jax.random.PRNGKey(s), p))(
        jnp.asarray(SEEDS), jnp.asarray(POSITIONS))


def _port_keys():
    return TS.keys(SEEDS, POSITIONS)


def test_threefry_keys_and_bits_equal_jax():
    """Exact: ``fold_in(PRNGKey(seed), position)`` for seeds 0 .. 2**32-1
    and positions up to 2**20, and ``jax.random.bits`` under those keys."""
    jk = np.asarray(_jax_keys())
    k0, k1 = _port_keys()
    np.testing.assert_array_equal(
        np.stack([k0.numpy(), k1.numpy()], 1).astype(np.uint32), jk)
    jb = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (V,), jnp.uint32))(
        jnp.asarray(jk)))
    np.testing.assert_array_equal(
        TS.random_bits(k0, k1, V).numpy().astype(np.uint32), jb)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_uniform_equal_jax(dtype):
    """Exact: ``jax.random.uniform(minval=tiny, maxval=1)``, bit for bit."""
    jdt, tdt = DTYPES[dtype]
    tiny = float(jnp.finfo(jdt).tiny)
    ju = jax.vmap(lambda k: jax.random.uniform(k, (V,), jdt, minval=tiny,
                                               maxval=1.0))(_jax_keys())
    k0, k1 = _port_keys()
    tu = TS.uniform(TS.random_bits(k0, k1, V), tdt)
    np.testing.assert_array_equal(tu.float().numpy(),
                                  np.asarray(ju.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gumbel_within_two_ulp(dtype):
    """``jax.random.gumbel`` within 2 ulp of its type at ``max(|g|, 1)``:
    ``g = -log(w)`` with ``w = -log(u)``, and a last-bit difference
    between XLA's and PyTorch's ``log`` of ``u`` (one ulp of ``w``, itself
    near 1 where ``g`` is near 0) moves ``g`` by one ``eps`` absolute."""
    jdt, tdt = DTYPES[dtype]
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,), jdt))(
        _jax_keys()).astype(jnp.float32))
    k0, k1 = _port_keys()
    tg = TS.gumbel(k0, k1, V, tdt)
    assert tg.dtype == tdt and tg.shape == (len(SEEDS), V)
    scale = np.exp2(np.floor(np.log2(np.maximum(np.abs(jg), 1.0))))
    ulp = torch.finfo(tdt).eps * scale
    assert np.all(np.abs(tg.float().numpy() - jg) <= 2 * ulp)


@pytest.mark.parametrize("temp", [0.0, 0.5, 1.0, 2.0])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sample_tokens_equal_reference(dtype, temp):
    """The same token ids as the reference's ``sample_tokens``, with host
    arrays and with tensors (seeds as the int32 of their bits, as a
    captured step holds them); row 1 stays greedy (exact argmax)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(int(temp * 10))
    logits = (rng.standard_normal((len(SEEDS), V)) * 3).astype(np.float32)
    temps = np.full((len(SEEDS),), temp, np.float32)
    temps[1] = 0.0
    want = np.asarray(JS.sample_tokens(
        jnp.asarray(logits).astype(jdt), jnp.asarray(temps),
        jnp.asarray(SEEDS), jnp.asarray(POSITIONS)))
    lt = torch.from_numpy(logits).to(tdt)
    got = TS.sample_tokens(lt, temps, SEEDS, POSITIONS)
    got_t = TS.sample_tokens(lt, torch.from_numpy(temps),
                             torch.from_numpy(SEEDS.view(np.int32)),
                             torch.from_numpy(POSITIONS.astype(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert int(got[1]) == int(torch.argmax(lt[1]))


def test_sample_token_host_equals_reference_and_the_batched_draw():
    """One host row draws what the reference's ``sample_token_host`` draws
    and what the same row draws inside a batch; the draw varies with the
    seed; temperature 0 is the argmax."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 64)).astype(np.float32)
    seeds, pos = [5, 6, 7, 2**31 - 1], [3, 3, 9, 9]
    full = TS.sample_tokens(torch.from_numpy(logits), np.full(4, 0.9), seeds,
                            pos).numpy()
    for j in range(4):
        want = JS.sample_token_host(logits[j], 0.9, seeds[j], pos[j])
        assert TS.sample_token_host(logits[j], 0.9, seeds[j], pos[j]) == want
        assert full[j] == want
    assert TS.sample_token_host(logits[0], 0.0, 1, 2) == int(np.argmax(logits[0]))
    assert len({TS.sample_token_host(logits[0], 1.5, s, 0)
                for s in range(64)}) > 1


def _stream(W, vocab):
    """A short sampled stream (temperature 0.8, a seed per request), its
    prompts folded into the reduced vocabulary."""
    spec = W.WorkloadSpec(duration=6.0, base_rate=1.0, n_origins=1,
                          diurnal_amplitude=0.0, prompt_len=(10.0, 0.3, 4, 20),
                          output_len=(5.0, 0.3, 2, 8), temperature=0.8, seed=3)
    for r in W.WorkloadStream(spec):
        yield dataclasses.replace(r, prompt=r.prompt % vocab)


def _serve_stream(W, C, engine, vocab):
    ec = C.EdgeCluster("runtime", engine=engine, n_servers=1,
                       runtime_opts=dict(max_slots=2, block_size=8))
    handles = W.drive(ec, _stream(W, vocab), max_pending=8)
    return [h.result().tolist() for h in handles], W.goodput_report(handles)


def test_sampled_workload_stream_equals_reference_and_its_rerun():
    """Exact: a ``WorkloadSpec(temperature=0.8)`` stream through the
    runtime backend gives the reference's token streams and goodput
    report, and the same again on a rerun; the sampled streams are not
    the greedy ones."""
    jeng, teng = build_pair("mixtral-8x7b", "dense", max_len=48)
    vocab = teng.rt.cfg.vocab_size
    want = _serve_stream(JW, JC, jeng, vocab)
    got = _serve_stream(TW, TC, teng, vocab)
    assert len(got[0]) >= 4
    assert got == want
    assert _serve_stream(TW, TC, teng, vocab) == got
    rt = ServingRuntime(teng, max_slots=2, block_size=8)
    greedy = [rt.enqueue(dataclasses.replace(r, temperature=0.0))
              for r in _stream(TW, vocab)]
    rt.run()
    assert [h.result().tolist() for h in greedy] != got[0]


def test_sampled_warm_loop_equals_sync_loop():
    """Exact: the warmed loop (its eager steps on the CPU, the same
    backlog) draws the synchronous loop's tokens for sampled requests of
    distinct seeds beside greedy ones."""
    _, teng = build_pair("mixtral-8x7b", "ep", max_len=48)
    ps = prompts(teng.rt.cfg.vocab_size, 4, 12, seed=6)

    def serve(warmup):
        rt = ServingRuntime(teng, max_slots=4, block_size=8, warmup=warmup)
        hs = [rt.enqueue(Request(prompt=p, max_new_tokens=8,
                                 temperature=0.8 if k else 0.0, seed=11 + k))
              for k, p in enumerate(ps)]
        rt.run()
        return [h.result().tolist() for h in hs]

    assert serve(True) == serve(False)
