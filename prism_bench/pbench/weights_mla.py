"""Weights of the benchmark's DeepSeek-V2 configurations (latent attention,
a leading dense layer, routed and shared experts), made on the device from
the seed by the rule of ``pbench.weights``: every tensor from its own
generator, seeded from (seed, tensor name), drawn in float32 and rounded
to the served type, so the reference draws any layer again on its own.
Scales: normal with variance 1 / fan-in for projections and experts, 0.02
for the embedding and the output head; norm scales are ones.

Layouts are HF's (``DeepseekV2ForCausalLM``), transposed to ``x @ w``:
``wq`` [d, H (nope + rope)] per head, ``wkva`` [d, kv_lora + rope] (the
latent, then the shared rope key), ``wkvb`` [kv_lora, H (nope + v)] per
head, ``wo`` [H v, d]. Layer ``l`` below ``dense_layers`` holds a dense
SwiGLU (``mlp_w1``, ``mlp_w3``, ``mlp_w2``); the others hold the router,
the routed experts ``w1``, ``w3``, ``w2`` [E, ...] and the shared experts
as one SwiGLU of their summed width (``shared_w1``, ``shared_w3``,
``shared_w2``).
"""

from __future__ import annotations

import torch

from pbench.tokens import stable_seed
from pbench.weights import served_dtype


def sizes(conf: dict) -> dict:
    """The sizes the model uses, from DeepSeek-V2's key names."""
    rs = conf["rope_scaling"]
    layers = conf["num_hidden_layers"]
    dense = conf["first_k_dense_replace"]
    return dict(
        layers=layers, dense_layers=dense, moe_layers=layers - dense,
        d=conf["hidden_size"], heads=conf["num_attention_heads"],
        kv_lora=conf["kv_lora_rank"], nope=conf["qk_nope_head_dim"],
        rope=conf["qk_rope_head_dim"], v=conf["v_head_dim"],
        ff=conf["moe_intermediate_size"],
        dense_ff=conf["intermediate_size"],
        experts=conf["n_routed_experts"], shared=conf["n_shared_experts"],
        top_k=conf["num_experts_per_tok"],
        norm_topk=bool(conf["norm_topk_prob"]),
        routed_scale=float(conf["routed_scaling_factor"]),
        vocab=conf["vocab_size"], theta=float(conf["rope_theta"]),
        eps=float(conf["rms_norm_eps"]),
        yarn=dict(factor=float(rs["factor"]),
                  original=int(rs["original_max_position_embeddings"]),
                  beta_fast=float(rs["beta_fast"]),
                  beta_slow=float(rs["beta_slow"]),
                  mscale=float(rs["mscale"]),
                  mscale_all_dim=float(rs["mscale_all_dim"])),
        dtype=served_dtype(conf))


def shapes(s: dict) -> dict:
    """{name: (shape, std)} of the drawn tensors, ``{l}`` standing for the
    layer."""
    d, H, r = s["d"], s["heads"], s["kv_lora"]
    qk = s["nope"] + s["rope"]
    e, f, fd, fs = s["experts"], s["ff"], s["dense_ff"], s["shared"] * s["ff"]
    return {
        "embed": ((s["vocab"], d), 0.02),
        "lm_head": ((d, s["vocab"]), 0.02),
        "layer{l}.wq": ((d, H * qk), d**-0.5),
        "layer{l}.wkva": ((d, r + s["rope"]), d**-0.5),
        "layer{l}.wkvb": ((r, H * (s["nope"] + s["v"])), r**-0.5),
        "layer{l}.wo": ((H * s["v"], d), (H * s["v"])**-0.5),
        "layer{l}.mlp_w1": ((d, fd), d**-0.5),
        "layer{l}.mlp_w3": ((d, fd), d**-0.5),
        "layer{l}.mlp_w2": ((fd, d), fd**-0.5),
        "layer{l}.router": ((d, e), d**-0.5),
        "layer{l}.w1": ((e, d, f), d**-0.5),
        "layer{l}.w3": ((e, d, f), d**-0.5),
        "layer{l}.w2": ((e, f, d), f**-0.5),
        "layer{l}.shared_w1": ((d, fs), d**-0.5),
        "layer{l}.shared_w3": ((d, fs), d**-0.5),
        "layer{l}.shared_w2": ((fs, d), fs**-0.5),
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
