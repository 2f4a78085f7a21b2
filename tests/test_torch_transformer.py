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


def _tree_equal(port, ref):
    """A port tree (tensors, a host step counter) equals a reference tree of
    numpy arrays, leaf by leaf."""
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _tree_equal(port[k], ref[k])
    elif isinstance(ref, list):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _tree_equal(a, b)
    else:
        a = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
        np.testing.assert_array_equal(a, np.asarray(ref))


META_EXTRA = {"arch": "yi-6b-smoke", "lr": 3e-4, "warm": True, "note": None,
              "mix": [1, -2, 2.5, "x" * 40], "big": 2**40}


def test_port_checkpoint_loads_into_the_reference(tmp_path):
    """``save_checkpoint`` of the port (parameters, an AdamW state after one
    step, step and extra metadata) reads back through the reference's
    ``load_checkpoint`` (msgpack): every array, the int32 step counter and
    the meta equal."""
    from repro.checkpoint.io import load_checkpoint as jload
    from repro_torch.checkpoint.io import save_checkpoint
    from repro_torch.optim.adamw import adamw
    from repro_torch.training.train_loop import make_train_step

    _, teng = _pair("yi-6b", "dense")
    params = _clone(teng.params)  # the optimizer updates in place
    opt = adamw(lr=1e-3)
    step = make_train_step(teng.rt, opt)
    toks = torch.from_numpy(prompts(teng.rt.cfg.vocab_size, 2, 16, seed=2))
    params, state, _ = step(params, opt.init(params), toks,
                            torch.roll(toks, -1, 1))
    save_checkpoint(tmp_path / "port", params, step=7, extra=META_EXTRA,
                    opt_state=state)
    p, o, meta = jload(tmp_path / "port")
    _tree_equal(params, p)
    _tree_equal({k: state[k] for k in ("m", "v")}, {k: o[k] for k in ("m", "v")})
    assert o["step"].dtype == np.int32 and int(o["step"]) == state["step"] == 1
    assert meta["step"] == 7 and meta["extra"] == META_EXTRA
    assert meta["keys"] == sorted(meta["keys"]) and "opt/step" in meta["keys"]


def test_reference_checkpoint_with_optimizer_loads_into_the_port(tmp_path):
    """The reference's ``save_checkpoint`` with an Adafactor state (a list
    of factored leaves) and metadata reads back through the port's
    ``load_checkpoint`` (no msgpack package): the same arrays, the step
    counter as an int, the same meta; the port's optimizer steps from the
    loaded state as from its own."""
    import jax

    from repro.checkpoint.io import save_checkpoint as jsave
    from repro.optim.adamw import adafactor as jadafactor
    from repro_torch.checkpoint.io import load_checkpoint
    from repro_torch.optim.adamw import adafactor

    jeng, _ = _pair("yi-6b", "dense")
    jopt = jadafactor(lr=1e-2)
    jstate = jopt.init(jeng.params)
    jstate = dict(jstate, step=jnp.int32(4))
    jsave(tmp_path / "ref", jeng.params, step=11, extra=META_EXTRA,
          opt_state=jstate)
    params, state, meta = load_checkpoint(tmp_path / "ref", device="cpu")
    _tree_equal(params, to_numpy(jeng.params))
    assert state["step"] == 4 and isinstance(state["step"], int)
    _tree_equal(state["f"], jax.tree.map(np.asarray, jstate["f"]))
    assert meta == {"step": 11, "extra": META_EXTRA,
                    "keys": meta["keys"]} and "opt/f/#0/vr" in meta["keys"]
    opt = adafactor(lr=1e-2)
    own = dict(opt.init(params), step=4)
    a, _ = opt.update(_clone(params), state, _clone(params))
    b, _ = opt.update(_clone(params), own, _clone(params))
    _tree_equal(a, to_numpy(b))


def _clone(tree):
    """A deep copy of a tree of tensors."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()
