"""Plain reference of DeepSeek-V2 (DeepSeek-V2-Lite, as the configuration
file describes it): float32 PyTorch, TF32 off, no kernels, no cache, no
batching; it imports nothing of the program. The weights are drawn again
from the seed by tensor name (``pbench.weights_mla``), layer by layer.

Per layer, the published equations (HF ``modeling_deepseek``):

* RMSNorm, then multi-head latent attention with no q LoRA, not absorbed:
  ``q = h W_q`` split per head into ``q_nope`` and ``q_pe``; ``[c~; k_pe]
  = h W_kva``, ``c = RMSNorm(c~)``; ``[k_nope; v] = c W_kvb`` per head;
  RoPE with YaRN frequencies on ``q_pe`` and on the one ``k_pe`` all heads
  share; causal softmax of ``(q_nope . k_nope + q_pe . k_pe) *
  qk_head_dim^-1/2 * m^2``, ``m = 0.1 * mscale_all_dim * ln(factor) + 1``;
  the values, ``W_o``; residual.
* RMSNorm, then the layers below ``first_k_dense_replace`` a dense SwiGLU;
  the others a softmax router over the routed experts, the greedy top-k
  (ties to the lower expert index) with weights the probabilities
  themselves (``norm_topk_prob`` false) times ``routed_scaling_factor``,
  each routed SwiGLU expert applied to its tokens, plus the shared experts
  (one SwiGLU of their summed width) on every token; residual.
* RMSNorm and the output head.

Departures from the published model, all fixed re-labellings of random
weights: RoPE runs in the half-split layout, where HF first permutes the
rope dims of q and k from interleaved pairs to halves (a fixed permutation
of the drawn columns of ``W_q`` and ``W_kva``); the norms' scales are ones.

``precision="fp8"`` is the control: every projection and expert takes
float8 (e4m3) weights, scaled per output channel, and float8 inputs, scaled
per row; the embedding, the router, the norms, the attention itself and
the head stay float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pbench import weights_mla as W

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with one scale along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)


class _Linear:
    """``x @ w`` in the reference's precision."""

    def __init__(self, w: torch.Tensor, fp8: bool):
        self.fp8 = fp8
        self.w = _fp8(w, 0) if fp8 else w

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (_fp8(x, -1) if self.fp8 else x) @ self.w


def yarn_mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def softmax_scale(s: dict) -> float:
    m = yarn_mscale(s["yarn"]["factor"], s["yarn"]["mscale_all_dim"])
    return (s["nope"] + s["rope"]) ** -0.5 * m * m


def yarn_inv_freq(s: dict, device) -> torch.Tensor:
    """HF's ``DeepseekV2YarnRotaryEmbedding`` frequencies, in float64: the
    correction range from ``beta_fast`` and ``beta_slow`` rotations in the
    original context, a linear ramp between the original frequencies and
    those divided by ``factor``."""
    y, dim, base = s["yarn"], s["rope"], s["theta"]

    def corr(rot):
        return (dim * math.log(y["original"] / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr(y["beta_fast"])), 0)
    high = min(math.ceil(corr(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    idx = torch.arange(0, dim, 2, dtype=torch.float64, device=device)
    extra = 1.0 / base ** (idx / dim)
    inter = extra / y["factor"]
    ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp  # 1: the original frequency
    return inter * (1 - keep) + extra * keep


def _rope(x: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """x [T, H, r] at positions 0..T-1 (half-split layout); the cos/sin
    scale ``mscale / mscale_all_dim`` is 1 for the published values."""
    T = x.shape[0]
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] \
        * inv_freq
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _mla(h, lw, s, inv_freq, q_block=1024):
    T = h.shape[0]
    H, dn, dr, dv, r = s["heads"], s["nope"], s["rope"], s["v"], s["kv_lora"]
    a = _rms(h, s["eps"])
    q = lw["wq"](a).view(T, H, dn + dr)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], inv_freq)], dim=-1)
    kva = lw["wkva"](a)
    c = _rms(kva[:, :r], s["eps"])
    k_pe = _rope(kva[:, None, r:], inv_freq)  # [T, 1, dr]
    kv = lw["wkvb"](c).view(T, H, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe.expand(T, H, dr)], dim=-1)
    v = kv[..., dn:]
    scale = softmax_scale(s)
    out = torch.empty((T, H, dv), dtype=torch.float32, device=h.device)
    kpos = torch.arange(T, device=h.device)
    for q0 in range(0, T, q_block):
        q1 = min(T, q0 + q_block)
        sc = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) * scale
        qpos = torch.arange(q0, q1, device=h.device)
        sc = sc.masked_fill(kpos[None, None, :q1] > qpos[None, :, None],
                            float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1),
                                  v[:q1])
    return h + lw["wo"](out.reshape(T, H * dv))


def _swiglu(x, w1, w3, w2):
    return w2(F.silu(w1(x)) * w3(x))


def _moe(h, router, experts, shared, s, fp8):
    a = _rms(h, s["eps"])
    probs = torch.softmax(a @ router, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :s["top_k"]], topi[:, :s["top_k"]]
    if s["norm_topk"]:
        topv = topv / topv.sum(-1, keepdim=True)
    topv = topv * s["routed_scale"]
    y = torch.zeros_like(h)
    w1, w3, w2 = experts
    for e in range(s["experts"]):
        rows, slot = torch.nonzero(topi == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        x = a[rows]
        xin = _fp8(x, -1) if fp8 else x
        mid = F.silu(xin @ w1[e]) * (xin @ w3[e])
        out = (_fp8(mid, -1) if fp8 else mid) @ w2[e]
        y.index_add_(0, rows, out * topv[rows, slot][:, None])
    return h + y + _swiglu(a, *shared)


@torch.no_grad()
def logits_at(conf: dict, seed: int, seqs, wanted, device,
              precision: str = "fp32"):
    """Logits of each sequence in ``seqs`` (token arrays) at the positions
    ``wanted[i]`` (a ``range``; position ``p`` predicts token ``p + 1``):
    a list of float32 ``[len(wanted[i]), vocab]`` tensors."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(conf, seed, seqs, wanted, device, precision == "fp8")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _logits_at(conf, seed, seqs, wanted, device, fp8):
    s = W.sizes(conf)
    lens = [len(t) for t in seqs]
    tok = torch.as_tensor(
        [int(x) for t in seqs for x in t], dtype=torch.long, device=device)
    embed = W.served(s, seed, "embed", device)
    h = embed[tok]
    del embed
    inv_freq = yarn_inv_freq(s, device)

    def linear(name, layer):
        return _Linear(W.served(s, seed, f"layer{{l}}.{name}", device, layer),
                       fp8)

    for layer in range(s["layers"]):
        lw = {n: linear(n, layer) for n in ("wq", "wkva", "wkvb", "wo")}
        h = torch.cat([_mla(p, lw, s, inv_freq)
                       for p in torch.split(h, lens)])
        del lw
        if layer < s["dense_layers"]:
            mlp = [linear(f"mlp_{n}", layer) for n in ("w1", "w3", "w2")]
            h = h + _swiglu(_rms(h, s["eps"]), *mlp)
            del mlp
            continue
        router = W.served(s, seed, "layer{l}.router", device, layer)
        experts = [W.served(s, seed, f"layer{{l}}.{n}", device, layer)
                   for n in ("w1", "w3", "w2")]
        if fp8:
            experts = [_fp8(w, 1) for w in experts]
        shared = [linear(f"shared_{n}", layer) for n in ("w1", "w3", "w2")]
        h = _moe(h, router, experts, shared, s, fp8)
        del router, experts, shared
    head = W.served(s, seed, "lm_head", device)
    out = []
    for part, want in zip(torch.split(h, lens), wanted):
        rows = part[torch.as_tensor(list(want), dtype=torch.long,
                                    device=device)]
        out.append(_rms(rows, s["eps"]) @ head)
    return out


def gaps(ref_logits: torch.Tensor, tokens) -> torch.Tensor:
    """How far each token's reference logit lies below the reference's
    best, per position."""
    tok = torch.as_tensor(tokens, dtype=torch.long, device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, tok[:, None])[:, 0]
