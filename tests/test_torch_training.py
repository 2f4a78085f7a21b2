"""The port's training path against the reference on the reduced configs,
over the reference's weights: one AdamW and one Adafactor step, clipping,
the cosine schedule, a 3-step ``train_loop`` history and the
``launch.train`` command line; and the kernel wrappers' refusal of CPU
tensors, with or without autograd. (``loss_fn`` and its gradients:
``test_torch_loss.py``.)

Tolerances: optimizer steps on the same gradients 1e-6 absolute (the same
elementwise arithmetic); the training history 1e-4 relative (after a step
a parameter whose gradient is near 0 may move by up to the learning rate
in either direction, which changes the next loss in the fifth digit at
most)."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import train_batches
from repro.optim import adamw as jopt
from repro.training import train_loop as jtl
from repro_torch.checkpoint.io import load_npz
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw as topt
from repro_torch.training import train_loop as ttl
from tests._torch_parity import build_train_pair, t

ROOT = Path(__file__).resolve().parents[1]


def _batch(vocab, B, T, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (B, T)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _opt_pair(seed):
    """A parameter tree with 1-d, 2-d and stacked 3-d leaves, and seeded
    gradients for it, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (7,), "b": {"w": (5, 6), "s": (3, 4, 5)}, "c": (6, 2)}

    def draw(s, scale):
        if isinstance(s, dict):
            return {k: draw(v, scale) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return draw(shapes, 1.0), [draw(shapes, 0.1) for _ in range(3)]


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_reference(name):
    params, grads = _opt_pair(3)
    sched = jopt.cosine_schedule(1e-2, 1, 10)
    jo = getattr(jopt, name)(schedule=sched)
    to = getattr(topt, name)(schedule=topt.cosine_schedule(1e-2, 1, 10))
    jp = jax.tree.map(jnp.asarray, params)
    tp = topt.tree_map(t, params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:  # three steps: the schedule and bias corrections move
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(topt.tree_map(t, g), ts, tp)
    assert ts["step"] == int(js["step"]) == 3
    for w, p in zip(jax.tree.leaves(jp), topt.tree_leaves(tp)):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), atol=1e-6)
    jstate = jax.tree.leaves({k: v for k, v in js.items() if k != "step"})
    tstate = topt.tree_leaves({k: v for k, v in ts.items() if k != "step"})
    for w, s in zip(jstate, tstate):
        np.testing.assert_allclose(s.numpy(), np.asarray(w), rtol=1e-5, atol=1e-9)


def test_clip_and_schedule_match_reference():
    _, grads = _opt_pair(4)
    big = topt.tree_map(lambda a: a * 50, grads[0])
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, big), 1.0)
    tc, tn = topt.clip_by_global_norm(topt.tree_map(t, big), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for w, c in zip(jax.tree.leaves(jc), topt.tree_leaves(tc)):
        np.testing.assert_allclose(c.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)
    small = {"a": torch.full((4,), 0.01)}
    _, n = topt.clip_by_global_norm(small, 1.0)
    assert float(n) < 1.0 and float(small["a"][0]) == pytest.approx(0.01)
    jl = jopt.cosine_schedule(1e-3, 10, 100)
    tl = topt.cosine_schedule(1e-3, 10, 100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert tl(s) == pytest.approx(float(jl(s)), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "mixtral-8x7b"])
def test_three_step_train_loop_history_matches_reference(arch):
    jrt, jparams, trt, tparams = build_train_pair(arch)
    batches = list(train_batches(jrt.cfg.vocab_size, 2, 16, 3, seed=2))
    jbatches = [(jnp.asarray(a), jnp.asarray(b)) for a, b in batches]
    _, _, jh = jtl.train_loop(jrt, jparams, jopt.adamw(lr=1e-3), jbatches)
    _, state, th = ttl.train_loop(trt, tparams, topt.adamw(lr=1e-3), batches)
    assert state["step"] == 3 and len(th) == len(jh) == 3
    for j, h in zip(jh, th):
        assert sorted(h) == sorted(j) and h["step"] == j["step"]
        for k in j:
            if k not in ("step", "wall"):
                assert h[k] == pytest.approx(j[k], rel=1e-4), (k, h["step"])


def test_train_command_line_runs_on_the_cpu(tmp_path):
    ckpt = tmp_path / "ckpt"
    cmd = [sys.executable, "-m", "repro_torch.launch.train"]
    cmd += ["--arch", "falcon-mamba-7b", "--device", "cpu", "--steps", "2"]
    cmd += ["--batch", "2", "--seq", "16", "--ckpt", str(ckpt)]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    env["HOME"] = str(tmp_path)
    out = subprocess.run(
        cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "falcon-mamba-7b-smoke [cpu float32]" in out.stdout
    assert "step    1 loss=" in out.stdout
    params = load_npz(ckpt, "cpu")
    assert params["groups"]["b0"]["in_proj"].shape == (2, 256, 1024)


def test_kernel_wrappers_refuse_autograd_without_a_backward_kernel():
    """``moe_gmm`` and ``flash_attention`` now have backward kernels, so
    their launch functions no longer refuse autograd; what they refuse is a
    CPU tensor, with or without it — the forward, the backward and the
    autograd Functions alike (on the CPU, autograd runs through the plain
    versions, ``test_torch_flash_grad.py`` and ``test_torch_moe_train.py``).
    """
    x = torch.zeros((1, 2, 4), requires_grad=True)
    w = torch.zeros((1, 4, 4))
    fill = torch.ones((1,), dtype=torch.int32)
    q = torch.zeros((1, 3, 2, 8), requires_grad=True)
    kv = torch.zeros((1, 3, 1, 8))
    lse = torch.zeros((1, 2, 3))
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            with pytest.raises(ValueError, match="moe_gmm: x must be on"):
                tgmm.launch(x, w, w, w, fill, 2)
            with pytest.raises(ValueError, match="moe_gmm: x must be on"):
                tgmm.MoeGmm.apply(x, w, w, w, fill, 2)
            with pytest.raises(ValueError, match="moe_gmm: x must be on"):
                tgmm.launch_bwd(x, w, w, w, fill, 2, x)
            with pytest.raises(ValueError, match="flash_attention: q must"):
                tflash.launch(q, kv, kv)
            with pytest.raises(ValueError, match="flash_attention: q must"):
                tflash.FlashAttention.apply(q, kv, kv, True, 0)
            with pytest.raises(ValueError, match="flash_attention: q must"):
                tflash.launch_bwd(q, kv, kv, q, lse, q)


def test_checkpointed_train_mode_gives_one_loss_with_or_without_grad():
    """Each layer group runs under activation checkpointing: the loss is
    the same with and without grad mode, every gradient is finite and the
    hybrid's shared attention block receives one."""
    _, _, trt, tparams = build_train_pair("zamba2-2.7b")
    tok, tgt = _batch(trt.cfg.vocab_size, 2, 12, seed=3)
    with torch.no_grad():
        a, _ = ttr.loss_fn(trt, tparams, tok, tgt)
    loss, _, grads = ttl.loss_and_grads(trt, tparams, tok, tgt)
    assert float(a) == pytest.approx(float(loss), rel=1e-6)
    assert all(torch.isfinite(g).all() for g in topt.tree_leaves(grads))
    assert float(grads["shared_attn"]["wq"].abs().sum()) > 0
