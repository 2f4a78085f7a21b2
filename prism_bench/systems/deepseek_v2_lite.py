"""The system module of the DeepSeek-V2 configurations (``"system":
"deepseek_v2_lite"``): multi-head latent attention over a latent paged
pool, a leading dense layer, then MoE layers of routed experts (top-k, the
softmax weights not renormalised) and shared experts, read from
DeepSeek-V2's own key names (``pbench.weights_mla``).

The engine is the port's ``ServingEngine`` over its ``MLAConfig``
(``repro_torch.configs.mla``): EP over the deployment's
virtual ranks for the routed experts of the MoE layers only (the engine's
``n_groups``, the placement and the routing counts cover those), the
shared experts on every token of its own rank, the dense layer ahead of
them. Its EP capacities come from the configuration's ``deployment``
(``ep_capacity``, ``ep_slot_capacity``: sized so that the largest step of
the cell's mix drops no row), not the Mixtral launcher's geometry.

The yardstick's arithmetic counts the published block: 2 x the active
parameters a token multiplies by (the MLA projections; layer by layer the
dense SwiGLU, or the router, ``top_k`` routed experts and the shared
SwiGLU), plus attention's ``2 x heads x (qk_head_dim + v_head_dim)`` per
(query, key) pair and layer; ``moe_gmm``'s least time counts the routed
rows of the expert width (the shared experts do not run in ``moe_gmm``).
"""

from __future__ import annotations

import numpy as np
import torch

from pbench import model
from pbench import weights_mla as W

sizes = W.sizes
gmm_least_seconds = model.gmm_least_seconds


def model_config(conf: dict):
    """The port's ``MLAConfig`` of the configuration."""
    from repro_torch.configs.mla import MLAConfig

    s = W.sizes(conf)
    y = s["yarn"]
    if s["routed_scale"] != 1.0 or conf.get("q_lora_rank") is not None:
        raise ValueError("the port serves routed_scaling_factor 1 and no q "
                         "LoRA")
    return MLAConfig(
        name=conf["name"], family="moe", num_layers=s["layers"],
        d_model=s["d"], num_heads=s["heads"], num_kv_heads=s["heads"],
        d_ff=s["ff"], vocab_size=s["vocab"], head_dim=s["v"],
        num_experts=s["experts"], top_k=s["top_k"], moe_every=1,
        rope_theta=s["theta"], norm_eps=s["eps"], source=conf["source"],
        kv_lora_rank=s["kv_lora"], qk_nope_dim=s["nope"],
        qk_rope_dim=s["rope"], v_head_dim=s["v"], rope_factor=y["factor"],
        rope_original_max=y["original"], beta_fast=y["beta_fast"],
        beta_slow=y["beta_slow"], mscale=y["mscale"],
        mscale_all_dim=y["mscale_all_dim"], n_shared_experts=s["shared"],
        dense_prefix=s["dense_layers"], dense_d_ff=s["dense_ff"],
        norm_topk_prob=s["norm_topk"])


def _stack(s, seed, device, dtype, layers, names) -> dict:
    """``{name: [len(layers), ...]}`` of the drawn tensors."""
    out = {}
    for n in names:
        shape, _ = W.shapes(s)[f"layer{{l}}.{n}"]
        t = torch.empty((len(layers),) + shape, dtype=dtype, device=device)
        for i, layer in enumerate(layers):
            t[i] = W.draw(s, seed, f"layer{{l}}.{n}", device, dtype, layer)
        out[n] = t
    return out


def _attention(s, seed, device, dtype, layers) -> dict:
    ones = {"norm": s["d"], "kv_norm": s["kv_lora"]}
    out = {k: torch.ones((len(layers), n), dtype=dtype, device=device)
           for k, n in ones.items()}
    out.update(_stack(s, seed, device, dtype, layers,
                      ("wq", "wkva", "wkvb", "wo")))
    return out


def build_engine(conf: dict, seed: int, max_len: int, device: str):
    """The port's serving engine over the benchmark's weights: the dense
    layers as its prefix, the MoE layers as its groups with EP over
    ``servers`` virtual ranks of ``slots_per_server`` slots, booted on the
    uniform layout, and the dense master copy of the routed experts that
    live migration re-gathers slots from."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import ServingEngine

    cfg = model_config(conf)
    dep = conf["deployment"]
    s = W.sizes(conf)
    dtype = s["dtype"]
    spec = M.EPSpec.build(dep["servers"], cfg, slots=dep["slots_per_server"],
                          capacity=dep["ep_capacity"],
                          slot_capacity=dep["ep_slot_capacity"])
    rt = tr.Runtime(cfg=cfg, moe_impl="ep", ep_spec=spec, dtype=dtype,
                    device=device)
    dense_l = list(range(s["dense_layers"]))
    moe_l = list(range(s["dense_layers"], s["layers"]))
    drawn = _stack(s, seed, device, dtype, dense_l,
                   ("mlp_w1", "mlp_w3", "mlp_w2"))
    mlp = {n[len("mlp_"):]: t for n, t in drawn.items()}
    mlp["norm"] = torch.ones((len(dense_l), s["d"]), dtype=dtype,
                             device=device)
    moe = _stack(s, seed, device, dtype, moe_l,
                 ("router", "w1", "w3", "w2", "shared_w1", "shared_w3",
                  "shared_w2"))
    moe["norm"] = torch.ones((len(moe_l), s["d"]), dtype=dtype,
                             device=device)
    dense = {"b0": _attention(s, seed, device, dtype, moe_l), "b1": moe}
    pls = tr.stack_placement(M.uniform_placement(spec.n_ep, spec.slots,
                                                 s["experts"]), len(moe_l))
    params = {"embed": W.draw(s, seed, "embed", device, dtype),
              "final_norm": torch.ones((s["d"],), dtype=dtype,
                                       device=device),
              "lm_head": W.draw(s, seed, "lm_head", device, dtype),
              "prefix": {"b0": _attention(s, seed, device, dtype, dense_l),
                         "b1": mlp},
              "groups": M.regather_ep_groups(dense, pls, len(moe_l))}
    return ServingEngine(rt=rt, params=params, placement=pls,
                         dense_master=dense, max_len=max_len)


# ---------------------------------------------------------------------------
# The yardstick's arithmetic
# ---------------------------------------------------------------------------


def _attention_params(s: dict) -> int:
    d, H, r = s["d"], s["heads"], s["kv_lora"]
    return (d * H * (s["nope"] + s["rope"]) + d * (r + s["rope"])
            + r * H * (s["nope"] + s["v"]) + H * s["v"] * d)


def active_params(s: dict) -> int:
    """Parameters one token multiplies by through the whole stack (the
    output head apart)."""
    d, attn = s["d"], _attention_params(s)
    dense = attn + 3 * d * s["dense_ff"]
    moe = attn + d * s["experts"] + (s["top_k"] + s["shared"]) * 3 * d * \
        s["ff"]
    return s["dense_layers"] * dense + s["moe_layers"] * moe


def token_flops(s: dict, context: np.ndarray, logits: bool) -> float:
    """Model FLOPs of tokens that attend over ``context`` positions each
    (their own included): 2 x active parameters, plus attention's 2 x
    heads x (qk_head_dim + v_head_dim) per (query, key) pair in every
    layer; plus the output head where the token's logits are produced."""
    context = np.asarray(context, np.float64)
    pair = 2.0 * s["heads"] * (s["nope"] + s["rope"] + s["v"])
    flops = 2.0 * active_params(s) * context.size \
        + s["layers"] * pair * context.sum()
    return flops + (2.0 * s["d"] * s["vocab"] * context.size if logits
                    else 0.0)


def prompt_flops(s: dict, prompt_len: int, skipped: int) -> float:
    """A prompt's computed positions ``skipped .. prompt_len - 1``, each
    attending over the positions up to itself; its last position's logits
    give the first token."""
    ctx = np.arange(skipped + 1, prompt_len + 1)
    return token_flops(s, ctx, False) + 2.0 * s["d"] * s["vocab"]


def decode_flops(s: dict, prompt_len: int, k: int) -> float:
    """The decode step that yields output token ``k`` (k >= 1): its input
    sits at position ``prompt_len + k - 1`` and attends over
    ``prompt_len + k`` positions."""
    return token_flops(s, np.array([prompt_len + k]), True)
