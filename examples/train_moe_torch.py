"""Train a small Mixtral-family MoE language model with the PyTorch port
(counts/aux-loss/local-ratio reported), AdamW + cosine LR, checkpointing
every 50 steps: the counterpart of ``examples/train_moe.py``.

Defaults train a ~25M-param model for 200 steps; `--dmodel 768 --layers 8
--steps 300` reaches the ~100M scale for real runs. On the CUDA device
(the default) attention trains through the hand-written flash-attention
kernels, forward and backward; `--device cpu` runs their plain versions.

The checkpoint is the reference's flat-key ``.npz`` (``save_npz``); the
reference's msgpack metadata sidecar is not written, so the final check
reads the parameters back instead of the step.

Run:  PYTHONPATH=src python examples/train_moe_torch.py --steps 200
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.io import load_npz, save_npz
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import train_batches
from repro_torch.models import transformer as tr
from repro_torch.optim.adamw import adamw, cosine_schedule, tree_leaves
from repro_torch.training.train_loop import make_train_step


def small_moe(d_model: int, layers: int) -> ModelConfig:
    return ModelConfig(
        name="train-moe-example", family="moe", num_layers=layers,
        d_model=d_model, num_heads=8, num_kv_heads=4, head_dim=d_model // 8,
        d_ff=d_model * 2, vocab_size=4096,
        num_experts=8, top_k=2, moe_every=1, source="example")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dmodel", type=int, default=384)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="results/train_moe_torch/ckpt")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available (pass --device "
                 "cpu to run the plain versions on the CPU)")

    cfg = small_moe(args.dmodel, args.layers)
    rt = tr.Runtime(cfg=cfg, moe_impl="dense", device=args.device)
    params = tr.init_params(rt, 0)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {n_params/1e6:.1f}M params "
          f"({cfg.num_experts} experts, top-{cfg.top_k}) on {args.device}")

    opt = adamw(schedule=cosine_schedule(args.lr, warmup=20,
                                         total=args.steps))
    step_fn = make_train_step(rt, opt)
    opt_state = opt.init(params)
    losses = []
    t0 = time.time()
    for i, (tok, tgt) in enumerate(train_batches(
            cfg.vocab_size, args.batch, args.seq, args.steps)):
        params, opt_state, m = step_fn(params, opt_state, tok, tgt)
        losses.append(float(m["loss"]))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"ce={float(m['ce_loss']):.4f} "
                  f"aux={float(m.get('aux_loss', 0)):.4f} "
                  f"gnorm={float(m['grad_norm']):.2f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
        if i and i % 50 == 0:
            save_npz(args.ckpt, params)
    save_npz(args.ckpt, params)
    p2 = load_npz(args.ckpt, device=args.device)
    assert all(torch.equal(a.detach(), b)
               for a, b in zip(tree_leaves(params), tree_leaves(p2)))
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({(1 - last/first) * 100:.1f}% reduction)")
    assert last < first, "training must reduce loss"
    print("OK")


if __name__ == "__main__":
    main()
