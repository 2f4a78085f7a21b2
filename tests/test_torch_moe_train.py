"""Training through the EP MoE layer: the port's ``moe_gmm`` gradients and
reduced Mixtral's EP train-mode loss and gradients against the
reference's, the host side of the ``moe_gmm`` backward kernel, and the
port's ``examples/train_moe_torch.py`` at a tiny size.

The Pallas kernel has no backward and the reference trains through plain
jnp, so the kernel-level reference is ``jax.vjp`` of
``repro.kernels.ref.moe_gmm_ref`` with the fills applied (rows past a
slot's fill enter as zeros and leave as zeros); the port's side is
``moe_gmm.plain_bwd``, the function the CUDA backward kernel is held
against on the card. Tolerances: each gradient within 1e-5 of its largest
value (fp32, sums in another order); the EP train step 1e-5 relative on the
loss and 2e-5 on each gradient leaf, as ``test_torch_loss.py`` holds the
dense one (measured: within 2.6e-6)."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import moe_gmm_ref
from repro.models import transformer as jtr
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import ops as tops
from repro_torch.optim import adamw as topt
from repro_torch.training import train_loop as ttl
from tests._torch_parity import build_pair

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-5
EP_GRAD_TOL = 2e-5

# (S, C, D, F, fill, max_fill): ragged fills with an empty slot, max_fill
# below C, a full slot, and a fill past max_fill
CASES = [
    (3, 8, 16, 24, [5, 0, 8], 8),
    (4, 12, 8, 32, [3, 12, 0, 7], 6),
    (2, 6, 32, 16, [6, 6], 6),
    (1, 5, 16, 8, [0], 5),
]


def _inputs(S, C, D, F, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, C, D)).astype(np.float32)
    w1 = (rng.standard_normal((S, D, F)) * D ** -0.5).astype(np.float32)
    w3 = (rng.standard_normal((S, D, F)) * D ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((S, F, D)) * F ** -0.5).astype(np.float32)
    dy = rng.standard_normal((S, C, D)).astype(np.float32)
    return x, w1, w3, w2, dy


def _jax_gmm(x, w1, w3, w2, fill, m):
    """``moe_gmm_ref`` with the fills applied, as the kernel computes it:
    rows below ``min(fill, m)`` only, zeros elsewhere."""
    C = x.shape[1]
    keep = (jnp.arange(C)[None, :] < jnp.minimum(jnp.asarray(fill), m)[:, None]
            )[..., None]
    xs = jnp.where(keep[:, :m], x[:, :m], 0.0)
    y = jnp.where(keep[:, :m], moe_gmm_ref(xs, w1, w3, w2), 0.0)
    return jnp.zeros_like(x).at[:, :m].set(y)


def _close_scaled(got, want, rel, name):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (name, err)


@pytest.mark.parametrize("S,C,D,F,fill,m", CASES)
def test_plain_gradients_match_the_reference(S, C, D, F, fill, m):
    x, w1, w3, w2, dy = _inputs(S, C, D, F)
    y, vjp = jax.vjp(lambda *a: _jax_gmm(*a, fill, m),
                     *(jnp.asarray(a) for a in (x, w1, w3, w2)))
    want = vjp(jnp.asarray(dy))
    args = [torch.from_numpy(a) for a in (x, w1, w3, w2)]
    fl = torch.tensor(fill, dtype=torch.int32)
    _close_scaled(tgmm.plain(*args, fl, m).numpy(), y, GRAD_TOL, "y")
    got = tgmm.plain_bwd(*args, fl, m, torch.from_numpy(dy))
    for name, g, w in zip(("dx", "dw1", "dw3", "dw2"), got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close_scaled(g.numpy(), w, GRAD_TOL, name)


def test_rows_past_the_fill_reach_no_gradient():
    """The dispatcher leaves rows past a slot's fill unwritten: whatever
    they hold (NaN here) changes neither the output nor any gradient, and
    their own gradient is 0."""
    x, w1, w3, w2, dy = (torch.from_numpy(a) for a in _inputs(3, 8, 16, 24))
    fill = torch.tensor([5, 0, 8], dtype=torch.int32)
    dirty = x.clone()
    dirty[0, 5:] = float("nan")
    dirty[1] = float("nan")
    want = tgmm.plain_bwd(x, w1, w3, w2, fill, 8, dy)
    got = tgmm.plain_bwd(dirty, w1, w3, w2, fill, 8, dy)
    assert torch.equal(tgmm.plain(dirty, w1, w3, w2, fill, 8),
                       tgmm.plain(x, w1, w3, w2, fill, 8))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not got[0][0, 5:].any() and not got[0][1].any()


def test_ops_differentiates_the_plain_version_on_the_cpu():
    x, w1, w3, w2, dy = (torch.from_numpy(a) for a in _inputs(2, 6, 8, 16))
    fill = torch.tensor([4, 6], dtype=torch.int32)
    before = tgmm.launches, tgmm.bwd_launches
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, w3, w2)]
    tops.moe_gmm(*leaves, fill, 6).backward(dy)
    for leaf, w in zip(leaves, tgmm.plain_bwd(x, w1, w3, w2, fill, 6, dy)):
        assert torch.equal(leaf.grad, w)
    assert (tgmm.launches, tgmm.bwd_launches) == before


@pytest.mark.parametrize("variant", ["tc", "simt"])
@pytest.mark.parametrize("S,D,F,m", [(8, 4096, 14336, 2048), (4, 256, 512, 1)])
def test_bwd_scratch_shapes(S, D, F, m, variant):
    """Both variants keep {da, db, mid}; only the CUDA cores' products
    write the recomputed x w1 and x w3 to an fp32 scratch (the wgmma gate
    kernel keeps them in registers)."""
    want = {"g": (3, S, m, F)}
    if variant == "simt":
        want["ab"] = (2, S, m, F)
    assert tgmm.bwd_scratch_shapes(S, D, F, m, variant) == want


@pytest.mark.parametrize("S,D,F,m,sms,grids", [
    # the EP train step: every kernel fills the 132 SMs
    (8, 4096, 14336, 2048, 132, {"gate": 132, "dx": 132, "dw13": 132,
                                 "dw2": 132}),
    # a small layer: the weight-gradient kernels have fewer tiles than SMs
    (2, 128, 256, 40, 132, {"gate": 8, "dx": 132, "dw13": 4, "dw2": 4}),
    # (96, 200): ragged column tiles
    (3, 96, 200, 40, 132, {"gate": 12, "dx": 132, "dw13": 6, "dw2": 6}),
    (4, 64, 136, 512, 16, {"gate": 16, "dx": 16, "dw13": 8, "dw2": 8}),
])
def test_tensor_core_bwd_plan(S, D, F, m, sms, grids):
    """The four wgmma backward kernels: one persistent block an SM, at most
    one a tile (gate: 128 rows of max_fill x 64 columns of F per slot; dw13
    / dw2: 128 x 128 tiles of [D, F] / [F, D] per slot; dx always one an SM
    for its zero rows); each a 4-stage ring of 64-deep stages of 8 KB
    swizzled atoms (gate: x, dy, w1, w3, w2 = 7; dx: 4; dw13: 6; dw2: 4)
    plus 1 KB of alignment, within an SM's 232,448 bytes."""
    plan = tgmm.bwd_plan(S, D, F, m, "tc", sms)
    assert {k: v["grid"] for k, v in plan.items()} == grids
    atoms = {"gate": 7, "dx": 4, "dw13": 6, "dw2": 4}
    assert {k: v["smem"] for k, v in plan.items()} == {
        k: 4 * a * 8192 + 1024 for k, a in atoms.items()}
    assert max(v["smem"] for v in plan.values()) <= 232448
    with pytest.raises(ValueError):
        tgmm.bwd_plan(S, D, F, m, "simt")


def test_moe_gmm_function_wiring(monkeypatch):
    """A wiring test, not a kernel test: ``MoeGmm`` with ``launch`` /
    ``launch_bwd`` replaced by the plain versions. It keeps its inputs only
    when one needs a gradient, hands the backward the fill and max_fill,
    gives ``fill`` and ``max_fill`` no gradient, and returns the gradients
    autograd through the plain version gives."""
    calls = []

    def launch(x, w1, w3, w2, fill, max_fill):
        calls.append(("fwd", max_fill))
        return tgmm.plain(x, w1, w3, w2, fill, max_fill)

    def launch_bwd(x, w1, w3, w2, fill, max_fill, dy):
        calls.append(("bwd", fill.tolist(), max_fill))
        return tgmm.plain_bwd(x, w1, w3, w2, fill, max_fill, dy)

    monkeypatch.setattr(tgmm, "launch", launch)
    monkeypatch.setattr(tgmm, "launch_bwd", launch_bwd)
    x, w1, w3, w2, dy = (torch.from_numpy(a) for a in _inputs(3, 8, 16, 24))
    fill = torch.tensor([5, 0, 8], dtype=torch.int32)
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, w3, w2)]
    y = tgmm.MoeGmm.apply(*leaves, fill, 7)
    assert len(y.grad_fn.saved_tensors) == 5
    y.backward(dy)
    assert calls == [("fwd", 7), ("bwd", [5, 0, 8], 7)]
    for leaf, w in zip(leaves, tgmm.plain_bwd(x, w1, w3, w2, fill, 7, dy)):
        assert torch.equal(leaf.grad, w)

    calls.clear()
    y = tgmm.MoeGmm.apply(x, w1, w3, w2, fill, 7)
    assert y.grad_fn is None and calls == [("fwd", 7)]


def test_ep_train_step_matches_the_reference():
    """Reduced Mixtral with ``moe_impl="ep"`` in train mode (one rank of 4
    slots, uniform placement, the reference's weights): the port's
    ``loss_and_grads`` against the reference's ``jax.value_and_grad`` of
    ``loss_fn`` on the same 2 x 32 tokens."""
    jeng, teng = build_pair("mixtral-8x7b", "ep")
    rng = np.random.default_rng(3)
    tok = rng.integers(0, jeng.rt.cfg.vocab_size, (2, 32)).astype(np.int32)
    tgt = np.roll(tok, -1, axis=1)

    def jloss(p):
        return jtr.loss_fn(jeng.rt, p, jnp.asarray(tok), jnp.asarray(tgt),
                           placement=jeng.placement)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jeng.params)
    loss, metrics, grads = ttl.loss_and_grads(teng.rt, teng.params, tok, tgt,
                                              placement=teng.placement)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("ce_loss", "aux_loss", "local_frac"):
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=1e-6)
    jleaves = jax.tree.leaves(jg)
    tleaves = topt.tree_leaves(grads)
    assert len(jleaves) == len(tleaves)
    for i, (w, g) in enumerate(zip(jleaves, tleaves)):
        assert tuple(g.shape) == tuple(w.shape)
        _close_scaled(g.numpy(), w, EP_GRAD_TOL, i)


def test_train_moe_example_runs_on_the_cpu(tmp_path):
    """``examples/train_moe_torch.py --device cpu`` at a tiny size: the loss
    falls, and the checkpoint it writes reads back as the trained
    parameters."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_moe_torch.py"),
         "--device", "cpu", "--steps", "24", "--dmodel", "64", "--layers",
         "1", "--batch", "4", "--seq", "32", "--lr", "3e-3",
         "--ckpt", str(tmp_path / "ckpt")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("OK")
    assert (tmp_path / "ckpt.npz").exists()
