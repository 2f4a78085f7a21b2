"""Plain reference of the benchmark's decoder-only MoE models (Mixtral-8x7B,
Phi-3.5-MoE as the configuration files describe them): float32 PyTorch,
TF32 off, no kernels, no cache, no batching.

Per layer: RMSNorm, grouped-query attention with half-split RoPE over the
whole sequence (causal), residual; RMSNorm, softmax router whose top-k
probabilities are renormalised (ties to the lower expert index), the
SwiGLU experts each applied to the tokens routed to it, residual. Then
RMSNorm and the output head. The weights are drawn again from the seed
(``pbench.weights``), layer by layer, so nothing the program made is read.

``precision="fp8"`` is the control: the attention projections and the
experts take float8 (e4m3) weights, scaled per output channel, and float8
inputs, scaled per row; the embedding, the router, the norms and the head
stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pbench import weights as W

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with one scale along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, hd] at positions 0..T-1 (half-split layout)."""
    T, _, hd = x.shape
    exps = torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd
    ang = (torch.arange(T, dtype=torch.float64, device=x.device)[:, None]
           / theta**exps)
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class _Linear:
    """``x @ w`` in the reference's precision."""

    def __init__(self, w: torch.Tensor, fp8: bool, in_dim: int):
        self.fp8 = fp8
        self.w = _fp8(w, in_dim) if fp8 else w

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (_fp8(x, -1) if self.fp8 else x) @ self.w


def _attention(h, lw, s, fp8, q_block=1024):
    T = h.shape[0]
    hd, H, KVH = s["hd"], s["heads"], s["kv_heads"]
    a = _rms(h, s["eps"])
    q = _rope(lw["wq"](a).view(T, H, hd), s["theta"])
    k = _rope(lw["wk"](a).view(T, KVH, hd), s["theta"])
    v = lw["wv"](a).view(T, KVH, hd)
    k = k.repeat_interleave(H // KVH, dim=1)
    v = v.repeat_interleave(H // KVH, dim=1)
    out = torch.empty((T, H, hd), dtype=torch.float32, device=h.device)
    kpos = torch.arange(T, device=h.device)
    for q0 in range(0, T, q_block):
        q1 = min(T, q0 + q_block)
        sc = torch.einsum("qhd,khd->hqk", q[q0:q1] * hd**-0.5, k[:q1])
        qpos = torch.arange(q0, q1, device=h.device)
        sc = sc.masked_fill(kpos[None, None, :q1] > qpos[None, :, None],
                            float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1),
                                  v[:q1])
    return h + lw["wo"](out.reshape(T, H * hd))


def _moe(h, router, experts, s, fp8):
    a = _rms(h, s["eps"])
    probs = torch.softmax(a @ router, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :s["top_k"]], topi[:, :s["top_k"]]
    topv = topv / topv.sum(-1, keepdim=True)
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
    return h + y


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
    for layer in range(s["layers"]):
        lw = {n: _Linear(W.served(s, seed, f"layer{{l}}.{n}", device, layer),
                         fp8, 0) for n in ("wq", "wk", "wv", "wo")}
        parts = list(torch.split(h, lens))
        h = torch.cat([_attention(p, lw, s, fp8) for p in parts])
        del lw, parts
        router = W.served(s, seed, "layer{l}.router", device, layer)
        experts = [W.served(s, seed, f"layer{{l}}.{n}", device, layer)
                   for n in ("w1", "w3", "w2")]
        if fp8:
            experts = [_fp8(w, 1) for w in experts]
        h = _moe(h, router, experts, s, fp8)
        del router, experts
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
