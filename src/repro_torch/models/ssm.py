"""State-space blocks (PyTorch port of ``repro.models.ssm``): Mamba-1
(selective scan) and Mamba-2 (SSD, scalar per-head decay).

Train mode runs Mamba-1 through ``ops.ssm_scan`` (on the card the fused
forward and backward kernels, which never build the [B, T, d, N] state
trajectory; on the CPU the plain version). Prefill needs the final state,
which the kernel does not return, so it runs the chunked ``linear_scan``;
decode is one recurrent step. Mamba-2 runs ``linear_scan`` in train and
prefill. Caches passed to prefill and decode are written in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import causal_conv1d, dense_init, rms_norm

F32 = torch.float32

# ---------------------------------------------------------------------------
# Generic chunked linear scan:  h_t = a_t * h_{t-1} + b_t
# ---------------------------------------------------------------------------


def linear_scan(a, b, h0, chunk: int = 256):
    """a, b: [B, T, ...]; h0: [B, ...]. Returns (h per step [B, T, ...],
    h_T).

    Within a chunk a doubling (Hillis-Steele) scan, log2(chunk) vectorised
    steps; across chunks a sequential loop, bounding the temporaries at
    [B, chunk, ...]. Out of place, so autograd runs through it."""
    T = b.shape[1]
    h, hs = h0, []
    for s in range(0, T, chunk):
        ac, bc = a[:, s : s + chunk], b[:, s : s + chunk]
        off = 1
        while off < ac.shape[1]:
            # (a1, b1) then (a2, b2) compose to (a1 a2, a2 b1 + b2)
            tail = ac[:, off:] * bc[:, :-off] + bc[:, off:]
            bc = torch.cat([bc[:, :off], tail], 1)
            ac = torch.cat([ac[:, :off], ac[:, off:] * ac[:, :-off]], 1)
            off *= 2
        hc = ac * h[:, None] + bc
        hs.append(hc)
        h = hc[:, -1]
    return torch.cat(hs, 1), h


def _store(cache, new: dict):
    """Write a block's new cache into ``cache`` in place (or return ``new``
    when the caller passed none)."""
    if cache is None:
        return new
    for k, v in new.items():
        cache[k].copy_(v)
    return cache


def _conv_tail(x, ck):
    """Last ck-1 inputs (left-padded with zeros if T < ck-1)."""
    T = x.shape[1]
    if T >= ck - 1:
        return x[:, T - (ck - 1) :]
    return F.pad(x, (0, 0, ck - 1 - T, 0))


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------


def mamba1_params(gen, cfg, dtype=F32, device="cuda") -> dict:
    d, di, n, ck = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    dtr = max(di // 16, 1)
    a_log = torch.log(torch.arange(1, n + 1, dtype=F32, device=device))
    return {
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "in_proj": dense_init(gen, (d, 2 * di), 0, dtype, device),
        "conv_w": dense_init(gen, (di, ck), 1, dtype, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": dense_init(gen, (di, dtr + 2 * n), 0, dtype, device),
        "dt_proj": dense_init(gen, (dtr, di), 0, dtype, device),
        # softplus^-1(0.01)
        "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=device),
        "A_log": a_log.expand(di, n).to(dtype).clone(),
        "D": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (di, d), 0, dtype, device),
    }


def _mamba1_core(p, cfg, x, conv_in, h0, *, mode: str):
    """Shared math. x: [B, T, di] post-in_proj gate split; conv_in:
    [B, T', di] window including left context. Returns (y, hT); hT is None
    in train mode (the fused scan does not return the final state)."""
    di, n = cfg.d_inner, cfg.ssm_state
    dtr = max(di // 16, 1)
    xc = F.silu(causal_conv1d(conv_in, p["conv_w"], p["conv_b"]))
    xc = xc[:, -x.shape[1] :]  # drop left context
    proj = xc @ p["x_proj"]
    dt_raw, Bs, Cs = torch.split(proj, [dtr, n, n], dim=-1)
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])  # [B, T, di]
    A = -torch.exp(p["A_log"].float())  # [di, n]
    D = p["D"].float()
    if mode == "train":
        return ops.ssm_scan(xc, dt, Bs, Cs, A, D), None
    a = torch.exp(dt.float()[..., None] * A)  # [B, T, di, n]
    b = (dt * xc).float()[..., None] * Bs.float()[..., None, :]
    if mode == "decode":
        hT = a[:, 0] * h0 + b[:, 0]
        hs = hT[:, None]
    else:
        hs, hT = linear_scan(a, b, h0)
    y = torch.einsum("btdn,btn->btd", hs, Cs.float())
    y = (y + D * xc.float()).to(x.dtype)
    return y, hT


def mamba1_apply(p, cfg, x, *, mode: str, cache=None, norm_eps: float = 1e-5):
    """x: [B, T, D]. cache: {'conv': [B, ck-1, di], 'ssm': [B, di, n]}.
    Returns (out, cache)."""
    B = x.shape[0]
    di, ck, n = cfg.d_inner, cfg.ssm_conv, cfg.ssm_state
    h = rms_norm(x, p["norm"], norm_eps)
    xz = h @ p["in_proj"]
    xi, z = torch.chunk(xz, 2, dim=-1)
    if mode == "train":
        y, _ = _mamba1_core(p, cfg, xi, xi, None, mode="train")
        cache = None
    elif mode == "prefill":
        h0 = torch.zeros((B, di, n), dtype=F32, device=x.device)
        y, hT = _mamba1_core(p, cfg, xi, xi, h0, mode="prefill")
        cache = _store(cache, {"conv": _conv_tail(xi, ck), "ssm": hT})
    elif mode == "decode":
        conv_in = torch.cat([cache["conv"].to(xi.dtype), xi], dim=1)
        y, hT = _mamba1_core(p, cfg, xi, conv_in, cache["ssm"], mode="decode")
        cache = _store(cache, {"conv": conv_in[:, 1:], "ssm": hT})
    else:
        raise ValueError(mode)
    y = y * F.silu(z)
    return x + y @ p["out_proj"], cache


def init_mamba1_cache(cfg, batch: int, dtype=torch.bfloat16, device="cuda") -> dict:
    conv = (batch, cfg.ssm_conv - 1, cfg.d_inner)
    ssm = (batch, cfg.d_inner, cfg.ssm_state)
    return {
        "conv": torch.zeros(conv, dtype=dtype, device=device),
        "ssm": torch.zeros(ssm, dtype=F32, device=device),
    }


# ---------------------------------------------------------------------------
# Mamba-2 (SSD: scalar decay per head)
# ---------------------------------------------------------------------------


def mamba2_params(gen, cfg, dtype=F32, device="cuda") -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, ck = cfg.ssm_heads, cfg.ssm_conv

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "norm": ones(d),
        "in_zx": dense_init(gen, (d, 2 * di), 0, dtype, device),
        "in_bc": dense_init(gen, (d, 2 * n), 0, dtype, device),
        "in_dt": dense_init(gen, (d, nh), 0, dtype, device),
        "conv_w": dense_init(gen, (di, ck), 1, dtype, device),
        "conv_b": zeros(di),
        "conv_bc_w": dense_init(gen, (2 * n, ck), 1, dtype, device),
        "conv_bc_b": zeros(2 * n),
        "dt_bias": zeros(nh),
        "A_log": zeros(nh),
        "D": ones(nh),
        "gnorm": ones(di),
        "out_proj": dense_init(gen, (di, d), 0, dtype, device),
    }


def _mamba2_core(p, cfg, xi, bc, dt_raw, h0, *, single_step: bool):
    """xi: [B, T, di] (post conv+silu), bc: [B, T, 2n] (post conv), dt_raw
    [B, T, nh]. State h: [B, nh, hd, n]."""
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    B, T = xi.shape[:2]
    Bs, Cs = torch.chunk(bc.float(), 2, dim=-1)  # [B, T, n]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())  # [nh]
    a = torch.exp(dt * A)  # [B, T, nh]
    xh = xi.float().reshape(B, T, nh, hd)
    b = (dt[..., None, None] * xh[..., None]) * Bs[:, :, None, None, :]
    a_b = a[..., None, None]  # [B, T, nh, 1, 1]
    if single_step:
        hT = a_b[:, 0] * h0 + b[:, 0]
        hs = hT[:, None]
    else:
        hs, hT = linear_scan(a_b.expand(b.shape), b, h0)
    y = torch.einsum("bthdn,btn->bthd", hs, Cs)
    y = y + p["D"].float()[:, None] * xh
    return y.reshape(B, T, nh * hd).to(xi.dtype), hT


def mamba2_apply(p, cfg, x, *, mode: str, cache=None, norm_eps: float = 1e-5):
    """x: [B, T, D]. cache: {'conv_x', 'conv_bc', 'ssm'} (see
    ``init_mamba2_cache``). Returns (out, cache)."""
    B, T = x.shape[:2]
    n, nh, hd = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    ck = cfg.ssm_conv
    h = rms_norm(x, p["norm"], norm_eps)
    zx = h @ p["in_zx"]
    z, xi = torch.chunk(zx, 2, dim=-1)
    bc = h @ p["in_bc"]
    dt_raw = h @ p["in_dt"]
    if mode == "decode":
        conv_x_in = torch.cat([cache["conv_x"].to(xi.dtype), xi], 1)
        conv_bc_in = torch.cat([cache["conv_bc"].to(bc.dtype), bc], 1)
        h0 = cache["ssm"]
    elif mode in ("train", "prefill"):
        conv_x_in, conv_bc_in = xi, bc
        h0 = torch.zeros((B, nh, hd, n), dtype=F32, device=x.device)
    else:
        raise ValueError(mode)
    xc = F.silu(causal_conv1d(conv_x_in, p["conv_w"], p["conv_b"]))[:, -T:]
    bcc = causal_conv1d(conv_bc_in, p["conv_bc_w"], p["conv_bc_b"])[:, -T:]
    step = mode == "decode"
    y, hT = _mamba2_core(p, cfg, xc, bcc, dt_raw, h0, single_step=step)
    y = rms_norm(y * F.silu(z), p["gnorm"], norm_eps)
    out = y @ p["out_proj"]
    if mode == "train":
        cache = None
    elif mode == "prefill":
        tails = {"conv_x": _conv_tail(xi, ck), "conv_bc": _conv_tail(bc, ck)}
        cache = _store(cache, {**tails, "ssm": hT})
    else:
        tails = {"conv_x": conv_x_in[:, 1:], "conv_bc": conv_bc_in[:, 1:]}
        cache = _store(cache, {**tails, "ssm": hT})
    return x + out, cache


def init_mamba2_cache(cfg, batch: int, dtype=torch.bfloat16, device="cuda") -> dict:
    n, ck = cfg.ssm_state, cfg.ssm_conv
    conv_x = (batch, ck - 1, cfg.d_inner)
    conv_bc = (batch, ck - 1, 2 * n)
    ssm = (batch, cfg.ssm_heads, cfg.ssm_head_dim, n)
    return {
        "conv_x": torch.zeros(conv_x, dtype=dtype, device=device),
        "conv_bc": torch.zeros(conv_bc, dtype=dtype, device=device),
        "ssm": torch.zeros(ssm, dtype=F32, device=device),
    }
