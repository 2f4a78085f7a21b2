"""Training launcher of the PyTorch port: the reduced variant of the
selected architecture unless ``--full``, dense MoE, AdamW with a cosine
schedule over the synthetic task-mixture batches. Mirrors
``repro.launch.train``, plus ``--device`` and ``--dtype``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \\
      --device cpu --steps 2

On the CUDA device every architecture trains through the hand-written
kernels, forward and backward: ``flash_attention`` for attention (and the
hybrids' shared attention), ``ssm_scan`` for Mamba-1; with ``moe_impl="ep"``
the expert FFN runs on ``moe_gmm`` (this launcher trains the dense MoE, as
the reference's does).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.io import save_checkpoint
from repro_torch.configs import get_config, list_configs
from repro_torch.data.pipeline import train_batches
from repro_torch.launch.serve import DTYPES
from repro_torch.models import transformer as tr
from repro_torch.optim.adamw import adamw, cosine_schedule, tree_leaves
from repro_torch.training.train_loop import make_train_step


def build_trainer(cfg, *, device: str, dtype, lr: float, steps: int, seed: int = 0):
    """Model and optimizer at the launcher's set-up: dense-MoE runtime,
    random weights from ``seed``, AdamW with 10 linear warmup steps then a
    cosine decay over ``steps``. Returns (rt, params, opt_state, step_fn)."""
    rt = tr.Runtime(cfg=cfg, moe_impl="dense", dtype=dtype, device=device)
    params = tr.init_params(rt, seed)
    opt = adamw(schedule=cosine_schedule(lr, 10, steps))
    return rt, params, opt.init(params), make_train_step(rt, opt)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(list_configs()))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true", help="the full config")
    ap.add_argument("--ckpt", default="",
                    help="write the parameters and optimizer state here "
                         "(.npz and .meta, the reference's format)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error(
            "--device cuda: no CUDA device is available (pass "
            "--device cpu to run the plain versions on the CPU)"
        )

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    dtype = DTYPES[args.dtype]
    _, params, opt_state, step_fn = build_trainer(
        cfg, device=args.device, dtype=dtype, lr=args.lr, steps=args.steps
    )
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"{cfg.name} [{args.device} {args.dtype}]: {n_params / 1e6:.1f}M params")
    batches = train_batches(cfg.vocab_size, args.batch, args.seq, args.steps)
    t0 = time.time()
    for i, (tok, tgt) in enumerate(batches):
        params, opt_state, m = step_fn(params, opt_state, tok, tgt)
        if i % 10 == 0 or i == args.steps - 1:
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            per_step = (time.time() - t0) / (i + 1)
            print(
                f"step {i:4d} loss={loss:.4f} grad_norm={gnorm:.3f} "
                f"({per_step:.2f}s/step)"
            )
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps,
                        opt_state=opt_state)
        print(f"saved {args.ckpt}.npz and {args.ckpt}.meta")


if __name__ == "__main__":
    main()
