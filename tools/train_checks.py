"""Three measurements behind the training checks of ``chip_smoke.py``, on
the card:

* ``variants`` — the two backward kernels on each of their variants at the
  train shapes in bf16 (flash B = 2, T = 2048, 32/8 heads, hd 128, causal;
  ``moe_gmm`` at 8 slots of capacity 16384, 4096 routed rows, max_fill
  2048): ``tc`` (``wgmma`` at these widths, the one ``select_variant``
  picks) against ``simt`` (the CUDA cores, forced), device ms each, beside
  their error against ``plain_bwd``;
* ``grads`` — how far reduced Zamba2's and Mixtral's fp32 gradients move
  with the device and the arithmetic: over seeds and lengths, the worst
  leaf's distance (over its largest value) between the card (kernels),
  the card with the plain attention in place of the flash kernels, the
  CPU in fp32 and the CPU in float64;
* ``trajectory`` — 2 layers of Mixtral-8x7B at full width in bf16, 4 AdamW
  steps of the train phase, once with the flash kernels and once with the
  plain attention on the card: the loss and grad norm of each step.

The card runs of the plain attention replace ``kernels.ops.flash_attention``
for the measurement only; the port itself has no such route.

    python3 tools/train_checks.py [variants] [grads] [trajectory]

Prints the card's name and power limit, then one line per measurement.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.training.train_loop import loss_and_grads  # noqa: E402


def plain_attention(q, k, v, *, causal=True, window=0):
    return fa.plain(q, k, v, causal=causal, window=window)


def rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)


def variants():
    dev, dt = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    pick = {"flash": fa.select_variant, "gmm": gmm.select_variant}
    q, do = (torch.randn(2, 2048, 32, 128, generator=gen, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn(2, 2048, 8, 128, generator=gen, device=dev).to(dt)
            for _ in range(2))
    lse = torch.empty(fa.stats_shape(2, 2048, 32), device=dev)
    o = fa.launch(q, k, v, lse=lse)
    want = fa.plain_bwd(q, k, v, do)
    S, C, D, F, m = 8, 16384, 4096, 14336, 2048
    fill = [700, 420, 0, 610, 530, 480, 650, 706]
    w1, w3 = ((torch.randn(S, D, F, generator=gen, device=dev) / 64).to(dt)
              for _ in range(2))
    w2 = (torch.randn(S, F, D, generator=gen, device=dev) / F**0.5).to(dt)
    x = torch.randn(S, C, D, generator=gen, device=dev).to(dt)
    dy = torch.randn(S, C, D, generator=gen, device=dev).to(dt)
    fl = torch.tensor(fill, dtype=torch.int32, device=dev)
    gwant = gmm.plain_bwd(x, w1, w3, w2, fl, m, dy)
    for variant in ("tc", "simt"):
        fa.select_variant = (pick["flash"] if variant == "tc"
                             else lambda *a, **kw: "simt")
        gmm.select_variant = (pick["gmm"] if variant == "tc"
                              else lambda *a, **kw: "simt")
        err = max(rel(g, w) for g, w in zip(
            fa.launch_bwd(q, k, v, o, lse, do), want))
        ms = chip_smoke.time_ms(lambda: fa.launch_bwd(q, k, v, o, lse, do), 5)
        gerr = max(rel(g, w) for g, w in zip(
            gmm.launch_bwd(x, w1, w3, w2, fl, m, dy), gwant))
        gms = chip_smoke.time_ms(
            lambda: gmm.launch_bwd(x, w1, w3, w2, fl, m, dy), 3)
        print(f"variants: {variant:4s} bf16 flash_attention_bwd B=2 T=2048 "
              f"hd 128 {ms:.3f} ms (rel err {err:.2e}); moe_gmm_bwd 4096 "
              f"rows {gms:.3f} ms (rel err {gerr:.2e})", flush=True)
    fa.select_variant, gmm.select_variant = pick["flash"], pick["gmm"]


def grads():
    orig = ops.flash_attention
    for arch, seed, T in (("zamba2-2.7b", 1, 100), ("zamba2-2.7b", 3, 48),
                          ("zamba2-2.7b", 3, 100), ("zamba2-2.7b", 5, 100),
                          ("mixtral-8x7b", 3, 200)):
        cpu, card = chip_smoke.train_reference_pair(arch, 0, seed=seed)
        rng = np.random.default_rng(0)
        tok = rng.integers(0, cpu[0].cfg.vocab_size, (2, T))
        tgt = np.roll(tok, -1, 1)
        g32 = loss_and_grads(cpu[0], cpu[1], tok, tgt)[2]
        gk = loss_and_grads(card[0], card[1], tok, tgt)[2]
        ops.flash_attention = plain_attention
        try:
            gp = loss_and_grads(card[0], card[1], tok, tgt)[2]
        finally:
            ops.flash_attention = orig
        rt64 = dataclasses.replace(cpu[0], dtype=torch.float64)
        g64 = loss_and_grads(rt64, tree_map(lambda a: a.detach().double(),
                                            cpu[1]), tok, tgt)[2]
        leaves = [[t.detach().cpu().double() for t in tree_leaves(g)]
                  for g in (gk, gp, g32, g64)]

        def worst(i, j):
            return max(rel(a, b) for a, b in zip(leaves[i], leaves[j]))

        print(f"grads: {arch} seed {seed} 2x{T} fp32, worst leaf over its "
              f"max: card vs CPU {worst(0, 2):.2e}; against the CPU's "
              f"float64: card {worst(0, 3):.2e}, card with the plain "
              f"attention {worst(1, 3):.2e}, CPU fp32 {worst(2, 3):.2e}; "
              f"card vs card with the plain attention {worst(0, 1):.2e}",
              flush=True)


def trajectory():
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import train_batches
    from repro_torch.launch.train import build_trainer

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=2)
    batches = list(train_batches(cfg.vocab_size, 2, 2048, 4))
    orig = ops.flash_attention
    for name in ("kernels", "plain attention"):
        ops.flash_attention = orig if name == "kernels" else plain_attention
        try:
            _, params, state, step = build_trainer(
                cfg, device="cuda", dtype=torch.bfloat16, lr=3e-4, steps=4)
            out = []
            for tok, tgt in batches:
                params, state, m = step(params, state, tok, tgt)
                out.append(f"{float(m['loss']):.4f}/{float(m['grad_norm']):.2f}")
        finally:
            ops.flash_attention = orig
        print(f"trajectory: mixtral-8x7b x2 bf16 2x2048, {name}: loss/grad "
              f"norm per step {', '.join(out)}", flush=True)
        del params, state, step
        chip_smoke.free_device_memory()


def main() -> int:
    if not torch.cuda.is_available():
        print("train_checks: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    todo = sys.argv[1:] or ["variants", "grads", "trajectory"]
    for name in todo:
        {"variants": variants, "grads": grads, "trajectory": trajectory}[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
