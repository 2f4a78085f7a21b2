"""Weights of the benchmark's models, made on the device from the seed.

Every tensor is drawn from its own generator, seeded from (seed, tensor
name), in one call, in float32 and then rounded to the served type. So the
set-up can hand the program its weights, and the reference can draw any
layer again later, on its own, with the same values. Scales follow the
program's initialisers: normal with variance 1 / fan-in for projections and
experts, 0.02 for the embedding and the output head; norm scales are ones.
"""

from __future__ import annotations

import torch

from pbench.tokens import stable_seed


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def served_dtype(conf: dict):
    """The type the configuration serves its weights in."""
    return DTYPES[conf.get("torch_dtype", "bfloat16")]


def sizes(conf: dict) -> dict:
    """The sizes the model uses, from a configuration file's keys."""
    d = conf["hidden_size"]
    h = conf["num_attention_heads"]
    return dict(
        layers=conf["num_hidden_layers"], d=d, heads=h,
        kv_heads=conf["num_key_value_heads"],
        hd=conf.get("head_dim") or d // h, ff=conf["intermediate_size"],
        experts=conf["num_local_experts"], top_k=conf["num_experts_per_tok"],
        vocab=conf["vocab_size"], theta=float(conf["rope_theta"]),
        eps=float(conf["rms_norm_eps"]), dtype=served_dtype(conf))


def shapes(s: dict) -> dict:
    """{name: (shape, std)} of one layer's drawn tensors, ``{l}`` standing
    for the layer, and of the embedding and head."""
    d, hd, e, f = s["d"], s["hd"], s["experts"], s["ff"]
    q, kv = s["heads"] * hd, s["kv_heads"] * hd
    return {
        "embed": ((s["vocab"], d), 0.02),
        "lm_head": ((d, s["vocab"]), 0.02),
        "layer{l}.wq": ((d, q), d**-0.5),
        "layer{l}.wk": ((d, kv), d**-0.5),
        "layer{l}.wv": ((d, kv), d**-0.5),
        "layer{l}.wo": ((q, d), q**-0.5),
        "layer{l}.router": ((d, e), d**-0.5),
        "layer{l}.w1": ((e, d, f), d**-0.5),
        "layer{l}.w3": ((e, d, f), d**-0.5),
        "layer{l}.w2": ((e, f, d), f**-0.5),
    }


def draw(s: dict, seed: int, name: str, device, dtype=torch.bfloat16,
         layer: int | None = None) -> torch.Tensor:
    """The tensor ``name`` (``layer{l}.wq`` with ``layer``), as served:
    float32 draws rounded to ``dtype``."""
    shape, std = shapes(s)[name]
    full = name.format(l=layer) if layer is not None else name
    gen = torch.Generator(device=device)
    gen.manual_seed(stable_seed("weight", seed, full) % 2**63)
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    w.mul_(std)
    return w.to(dtype)


def served(s: dict, seed: int, name: str, device, layer=None) -> torch.Tensor:
    """The served values of ``name`` in float32 (the reference's view)."""
    return draw(s, seed, name, device, s["dtype"], layer).float()
