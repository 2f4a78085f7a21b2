"""The port's serving entry points (``prefill``, ``decode_step`` dense and
paged, ``prefill_chunk``) against the reference's on the reduced configs,
over the reference's weights: last-token logits within fp32 tolerance
(1e-5 absolute and relative: same arithmetic, summed in another order) and
identical MoE gating statistics."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtr
from repro_torch.models import transformer as ttr
from tests._torch_parity import build_pair, prompts, to_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
CASES = [("mixtral-8x7b", "ep"), ("mixtral-8x7b", "dense"), ("yi-6b", "dense")]
_PAIRS: dict = {}


def _pair(arch, impl):
    if (arch, impl) not in _PAIRS:
        _PAIRS[arch, impl] = build_pair(arch, impl, max_len=32,
                                        capacity=64, slot_capacity=64)
    return _PAIRS[arch, impl]


def _stats_equal(js, ts):
    if js is None:
        assert ts is None
        return
    np.testing.assert_array_equal(np.asarray(js["counts_per_rank"]),
                                  ts["counts_per_rank"].numpy())


@pytest.mark.parametrize("arch,impl", CASES)
def test_prefill_and_dense_decode_logits(arch, impl):
    jeng, teng = _pair(arch, impl)
    toks = prompts(jeng.rt.cfg.vocab_size, 2, 9, seed=1)
    jl, jc, js = jeng._prefill(jeng.params, jnp.asarray(toks), jeng.placement)
    tl, tc, ts = teng._prefill(teng.params, toks, teng.placement)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _stats_equal(js, ts)
    cur = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    pos = np.array([9, 9], np.int32)
    for _ in range(2):
        jl, jc, js = jeng._decode(jeng.params, jc, jnp.asarray(cur),
                                  jnp.asarray(pos), jeng.placement)
        tl, tc, ts = teng._decode(teng.params, tc, cur, pos, teng.placement)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _stats_equal(js, ts)
        cur = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("arch,impl", CASES[:1] + CASES[2:])
def test_paged_chunk_then_decode_logits(arch, impl):
    """Two slots: slot 0 prefills 2 chunks, slot 1 one partial chunk, then
    both decode one token through their page tables."""
    jeng, teng = _pair(arch, impl)
    bs, n_blocks = 4, 8
    jpool = jtr.init_paged_cache(jeng.rt, n_blocks, bs)
    tpool = ttr.init_paged_cache(teng.rt, n_blocks, bs)
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    toks = prompts(jeng.rt.cfg.vocab_size, 2, 8, seed=2)
    rounds = [  # (tokens, write blocks, offsets, last_idx, mask)
        (toks[:, :4], [1, 4], [0, 0], [3, 2], [[1] * 4, [1, 1, 1, 0]]),
        (np.stack([toks[0, 4:], np.zeros(4, np.int32)]), [2, 0], [4, 0],
         [3, 0], [[1] * 4, [0] * 4]),
    ]
    for tk, wb, off, li, m in rounds:
        args = [np.asarray(a, dt) for a, dt in ((tk, np.int32), (table, np.int32),
                                                (wb, np.int32), (off, np.int32),
                                                (li, np.int32))]
        mask = np.asarray(m, np.float32)
        jl, jpool, js = jtr.prefill_chunk(
            jeng.rt, jeng.params, jpool, *(jnp.asarray(a) for a in args),
            jeng.placement, token_mask=jnp.asarray(mask))
        tl, tpool, ts = ttr.prefill_chunk(
            teng.rt, teng.params, tpool, *args, teng.placement,
            token_mask=mask)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _stats_equal(js, ts)
    pos = np.array([8, 3], np.int32)
    cur = np.array([[5], [7]], np.int32)
    jl, jpool, js = jtr.decode_step(
        jeng.rt, jeng.params, jpool, jnp.asarray(cur), jnp.asarray(pos),
        jeng.placement, token_mask=jnp.ones(2), page_table=jnp.asarray(table))
    tl, tpool, ts = ttr.decode_step(
        teng.rt, teng.params, tpool, cur, pos, teng.placement,
        token_mask=np.ones(2, np.float32), page_table=table)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _stats_equal(js, ts)
    for name, layer in to_numpy(jpool).items():
        for k, v in layer.items():
            np.testing.assert_allclose(tpool[name][k].numpy()[:, 1:6],
                                       v[:, 1:6], **TOL)


def test_init_params_is_seeded_and_shaped_like_the_reference():
    jeng, teng = _pair("mixtral-8x7b", "dense")
    a = ttr.init_params(teng.rt, seed=3)
    b = ttr.init_params(teng.rt, seed=3)
    ref = to_numpy(jeng.params)

    def walk(x, y, r):
        if isinstance(r, dict):
            assert set(x) == set(r)
            for k in r:
                walk(x[k], y[k], r[k])
        else:
            assert tuple(x.shape) == r.shape and torch.equal(x, y)

    walk(a, b, ref)
    assert not torch.equal(ttr.init_params(teng.rt, seed=4)["embed"],
                           a["embed"])


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    """The flat-key npz of ``repro.checkpoint.io.save_checkpoint`` loads
    into the port (no msgpack), and the port's own npz round-trips."""
    from repro.checkpoint.io import save_checkpoint
    from repro_torch.checkpoint.io import load_npz, save_npz

    jeng, teng = _pair("yi-6b", "dense")
    save_checkpoint(tmp_path / "ref", jeng.params, step=3)
    loaded = load_npz(tmp_path / "ref", device="cpu")
    save_npz(tmp_path / "port", loaded)
    again = load_npz(tmp_path / "port", device="cpu")
    ref = to_numpy(jeng.params)

    def walk(a, b, r):
        if isinstance(r, dict):
            assert set(a) == set(r) == set(b)
            for k in r:
                walk(a[k], b[k], r[k])
        else:
            np.testing.assert_array_equal(a.numpy(), r)
            np.testing.assert_array_equal(b.numpy(), r)

    walk(loaded, again, ref)
    toks = prompts(jeng.rt.cfg.vocab_size, 1, 6, seed=4)
    a = teng._prefill(loaded, toks, None)[0]
    b = teng._prefill(teng.params, toks, None)[0]
    assert torch.equal(a, b)
