"""Mamba-1 selective scan: the CUDA kernels' wrappers (forward and
backward), their plain versions and the ``torch.autograd.Function`` that
joins them (kernel source: ``csrc/ssm_scan.cu``; the forward replaces the
Pallas TPU kernel ``repro.kernels.ssm_scan.ssm_scan``, which has no
backward).

Shapes: x, dt [B, T, d]; Bs, Cs [B, T, N] (fp32 or bf16, one type); A
[d, N] and D [d] fp32; y [B, T, d] in x's type. Any T and d, N <= 16; all
arithmetic in fp32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssm_scan_ref

launches = 0  # forward kernel launches in this process (a run resets it)
bwd_launches = 0  # backward kernel launches

CHUNK = 16  # steps between the forward's state checkpoints (kChunk)
MAX_STATE = 16  # largest N the kernels take (kMaxN)
BWD_CHANNELS = 64  # channels per backward block (kBwdCh)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def states_shape(B: int, T: int, d: int, N: int) -> tuple:
    """The forward's checkpoint scratch: the fp32 state at the start of
    every CHUNK-step tile."""
    return (B, -(-T // CHUNK), d, N)


def partials_shape(B: int, T: int, d: int) -> tuple:
    """The backward's fp32 per-block partial sums of dB (``[..., :N]``) and
    dC (``[..., MAX_STATE:MAX_STATE + N]``), one row per backward block."""
    return (B, -(-d // BWD_CHANNELS), T, 2 * MAX_STATE)


def meta_trace(x, dt, Bs, Cs, A, D):
    """The scan on ``meta`` tensors (the launch tools' dry run, which has
    no data): the plain version's output shape and type, its elementwise
    ops over the [B, T, d, N] trajectory and its graph edges to every
    input, in one pass. The plain version walks T steps in Python (at a
    4096-token batch through 64 layers, forward, recompute and backward,
    several million meta ops) for the same shapes; neither runs a matmul,
    so neither adds a counted FLOP."""
    if x.device.type != "meta":
        raise ValueError(f"ssm_scan.meta_trace: {x.device} tensor")
    f = [t.float() for t in (x, dt, Bs, Cs, A, D)]
    h = torch.exp(f[1][..., None] * f[4]) * (f[1] * f[0])[..., None]
    y = (h * f[2][:, :, None, :] * f[3][:, :, None, :]).sum(-1)
    return (y + f[5] * f[0]).to(x.dtype)


def plain(x, dt, Bs, Cs, A, D):
    """The kernel's function in plain PyTorch: the step-by-step oracle on
    inputs upcast to fp32 (the kernel forms ``dt * x`` in fp32 too)."""
    f = [t.float() for t in (x, dt, Bs, Cs, A, D)]
    return ssm_scan_ref(*f).to(x.dtype)


def plain_bwd(x, dt, Bs, Cs, A, D, dy):
    """The backward kernel's function in plain PyTorch: the adjoint
    recurrence, with ``g_t = dL/dh_t``, ``u_t = dt_t x_t`` and
    ``a_t = exp(dt_t A)``::

        g_t   = dy_t C_t + a_{t+1} g_{t+1}
        dC_t  = sum_d dy_t h_t         dB_t = sum_d g_t u_t
        du_t  = g_t . B_t              q_t  = g_t h_{t-1} a_t
        ddt_t = q_t . A + du_t x_t     dx_t = du_t dt_t + D dy_t
        dA    = sum_{b,t} q_t dt_t     dD   = sum_{b,t} dy_t x_t

    Returns ``(dx, ddt, dB, dC, dA, dD)`` in the inputs' types. Builds the
    [B, T, d, N] trajectory the kernel never stores."""
    xf, dtf, Bf, Cf, dyf = (t.float() for t in (x, dt, Bs, Cs, dy))
    A, D = A.float(), D.float()
    Bn, T, d = xf.shape
    a = torch.exp(dtf[..., None] * A)  # [B, T, d, N]
    u = dtf * xf
    h = torch.zeros((Bn, d, A.shape[-1]), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(T):
        h = a[:, t] * h + u[:, t, :, None] * Bf[:, t, None, :]
        hs.append(h)
    hs = torch.stack(hs, 1)
    hprev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], 1)
    gs = [None] * T
    g = torch.zeros_like(h)
    for t in range(T - 1, -1, -1):
        carry = a[:, t + 1] * g if t + 1 < T else 0.0
        g = dyf[:, t, :, None] * Cf[:, t, None, :] + carry
        gs[t] = g
    gs = torch.stack(gs, 1)
    dC = torch.einsum("btd,btdn->btn", dyf, hs)
    dB = torch.einsum("btdn,btd->btn", gs, u)
    du = torch.einsum("btdn,btn->btd", gs, Bf)
    q = gs * hprev * a
    ddt = torch.einsum("btdn,dn->btd", q, A) + du * xf
    dA = torch.einsum("btdn,btd->dn", q, dtf)
    dx = du * dtf + D * dyf
    dD = (dyf * xf).sum((0, 1))
    return (
        dx.to(x.dtype), ddt.to(dt.dtype), dB.to(Bs.dtype), dC.to(Cs.dtype), dA, dD
    )


def _check(x, dt, Bs, Cs, A, D, dy=None, states=None):
    """Raise unless the tensors are what the kernels take (the backward's
    also ``dy`` and ``states``); returns (B, T, d, N)."""
    if x.dim() != 3 or Bs.dim() != 3:
        raise ValueError("ssm_scan: x and Bs must be [B, T, d] and [B, T, N]")
    Bn, T, d = x.shape
    N = Bs.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssm_scan: unsupported dtype {x.dtype}")
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"ssm_scan: state size {N} not in 1..{MAX_STATE}")
    want = [
        ("x", x, (Bn, T, d), x.dtype),
        ("dt", dt, (Bn, T, d), x.dtype),
        ("Bs", Bs, (Bn, T, N), x.dtype),
        ("Cs", Cs, (Bn, T, N), x.dtype),
        ("A", A, (d, N), torch.float32),
        ("D", D, (d,), torch.float32),
    ]
    if dy is not None:
        want += [
            ("dy", dy, (Bn, T, d), x.dtype),
            ("states", states, states_shape(Bn, T, d, N), torch.float32),
        ]
    for name, t, shape, dtype in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            msg = f"{name} is {t.dtype} {tuple(t.shape)}, expected {dtype} {shape}"
            raise ValueError(f"ssm_scan: {msg}")
    for name, t, _, _ in want:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ssm_scan: {name} must be a CUDA tensor on x's device")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} must be contiguous")
    return Bn, T, d, N


def launch(x, dt, Bs, Cs, A, D, *, save_states: bool = False):
    """Run the forward kernel on the current stream. Returns ``(y,
    states)``: ``states`` is the ``states_shape`` fp32 checkpoint scratch
    the backward needs when ``save_states``, else None."""
    global launches
    Bn, T, d, N = _check(x, dt, Bs, Cs, A, D)
    y = torch.empty_like(x)
    states = None
    if save_states:
        f32 = dict(dtype=torch.float32, device=x.device)
        states = torch.empty(states_shape(Bn, T, d, N), **f32)
    ptrs = [t.data_ptr() for t in (x, dt, Bs, Cs, A, D, y)]
    hc = None if states is None else states.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = build.library("ssm_scan").ssm_scan_fwd_launch
    rc = fn(_DTYPES[x.dtype], *ptrs, hc, Bn, T, d, N, stream)
    build.check("ssm_scan", rc)
    launches += 1
    return y, states


def launch_bwd(x, dt, Bs, Cs, A, D, dy, states):
    """Run the backward kernel on the current stream over the forward's
    ``states``; returns ``(dx, ddt, dB, dC, dA, dD)`` as ``plain_bwd``
    does. The channel sums of dB and dC (and the batch sums of dA and dD)
    arrive as per-block partials and are added here with ``torch.sum``."""
    global bwd_launches
    Bn, T, d, N = _check(x, dt, Bs, Cs, A, D, dy, states)
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    f32 = dict(dtype=torch.float32, device=x.device)
    dbc = torch.empty(partials_shape(Bn, T, d), **f32)
    dA = torch.empty((Bn, d, N), **f32)
    dD = torch.empty((Bn, d), **f32)
    ptrs = [t.data_ptr() for t in (x, dt, Bs, Cs, A, D, dy, states)]
    ptrs += [t.data_ptr() for t in (dx, ddt, dbc, dA, dD)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = build.library("ssm_scan").ssm_scan_bwd_launch
    rc = fn(_DTYPES[x.dtype], *ptrs, Bn, T, d, N, stream)
    build.check("ssm_scan_bwd", rc)
    bwd_launches += 1
    part = dbc.sum(1)
    dB = part[..., :N].to(Bs.dtype)
    dC = part[..., MAX_STATE : MAX_STATE + N].to(Cs.dtype)
    return dx, ddt, dB, dC, dA.sum(0), dD.sum(0)


class SsmScan(torch.autograd.Function):
    """``y = ssm_scan(x, dt, Bs, Cs, A, D)`` on the forward kernel, its
    gradients on the backward kernel. The forward keeps the state
    checkpoints only when an input needs a gradient."""

    @staticmethod
    def forward(ctx, x, dt, Bs, Cs, A, D):
        args = [t.contiguous() for t in (x, dt, Bs, Cs, A, D)]
        need = any(ctx.needs_input_grad)
        y, states = launch(*args, save_states=need)
        if need:
            ctx.save_for_backward(*args, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        *args, states = ctx.saved_tensors
        return launch_bwd(*args, dy.contiguous(), states)
