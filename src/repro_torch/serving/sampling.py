"""Seeded Gumbel-max temperature sampling shared by every decode surface
(PyTorch port of ``repro.serving.sampling``).

A request's token stream depends only on its own ``(seed, temperature)``
and the logits it sees:

* rows with ``temperature == 0`` return ``argmax(logits)`` exactly;
* rows with ``temperature > 0`` return ``argmax(logits / temp + g)``, where
  ``g`` is Gumbel noise keyed by ``fold_in(PRNGKey(seed), position)`` only —
  never by batch composition, bucket width or scheduling — so reruns and
  the warmed and synchronous loops draw the same tokens.

The key schedule and the noise are JAX's, bit for bit (``jax.random``
with ``jax_threefry_partitionable`` on, its default): threefry2x32 (20
rounds), ``PRNGKey(seed) = (0, seed)``, ``fold_in(key, d) =
threefry2x32(key, (0, d))``, the random bits of element ``i`` the xor of
the two words of ``threefry2x32(key, (0, i))``, then JAX's uniform (the
mantissa bits of ``[1, 2)``, minus 1, clamped to ``[tiny, 1)``) and
``-log(-log(u))``. The words are uint32 values held in int64 tensors, so
the same integer ops run on a CUDA tensor and on a CPU tensor and give the
same bits. Top-k / top-p truncation is not part of the rule (nor of the
reference's).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# temperatures below this clamp still count as "hot enough to divide by":
# guards the logits / temp division against inf without changing any
# realistic temperature (rows at exactly 0.0 never reach the division)
_MIN_TEMP = 1e-4

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, as ``jax.random``'s. Every argument
    is an int64 tensor (or int) of uint32 values; they broadcast. Returns
    the two output words."""
    k2 = k0 ^ k1 ^ _KS_PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _u32(a, device) -> torch.Tensor:
    """Integers of any type (a uint32 bit pattern held in int32
    included) as int64 uint32 values on ``device``."""
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.int64) & M32
    return torch.as_tensor(np.asarray(a).astype(np.int64) & M32,
                           device=device)


def keys(seeds, positions, device=None) -> tuple:
    """Per-row threefry keys ``fold_in(PRNGKey(seed), position)``: two
    int64 ``[B]`` tensors of uint32 words."""
    s = _u32(seeds, device).reshape(-1)
    p = _u32(positions, device).reshape(-1)
    zero = torch.zeros_like(s)
    return threefry2x32(zero, s, zero, p)


def random_bits(k0, k1, n: int) -> torch.Tensor:
    """``[B, n]`` int64: the 32 random bits of elements ``0..n-1`` under
    the per-row keys ``(k0, k1)`` (``jax.random.bits(key, (n,))``)."""
    i = torch.arange(n, dtype=torch.int64, device=k0.device)[None, :]
    x0, x1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(i), i)
    return x0 ^ x1


def _int_view(nbits: int):
    return {32: torch.int32, 16: torch.int16}[nbits]


def uniform(bits, dtype) -> torch.Tensor:
    """JAX's uniform in ``[tiny, 1)`` of ``dtype`` from 32-bit ``bits``:
    the random mantissa of a float in ``[1, 2)``, minus 1, scaled and
    clamped as ``jax.random.uniform(minval=tiny, maxval=1)`` does. 16-bit
    types take the low bits (8 of them where the mantissa is shorter)."""
    fi = torch.finfo(dtype)
    nmant = round(-math.log2(fi.eps))
    rng_bits = fi.bits if nmant >= 8 else 8
    if rng_bits < 32:
        bits = bits & ((1 << rng_bits) - 1)
    one = int(torch.tensor(1.0, dtype=dtype).view(_int_view(fi.bits)))
    fbits = (bits >> (rng_bits - nmant)) | one
    floats = fbits.to(_int_view(fi.bits)).view(dtype) - 1
    # maxval - minval in ``dtype`` (it rounds to 1); Python scalars, so
    # that a captured step copies nothing from the host
    span = float(torch.tensor(1.0 - fi.tiny, dtype=dtype))
    return torch.clamp_min(floats * span + fi.tiny, fi.tiny)


def gumbel(k0, k1, n: int, dtype) -> torch.Tensor:
    """``[B, n]`` Gumbel noise of ``dtype`` per row key
    (``jax.random.gumbel(key, (n,), dtype)``, its default "low" mode)."""
    return -torch.log(-torch.log(uniform(random_bits(k0, k1, n), dtype)))


def greedy_tokens(logits) -> torch.Tensor:
    """[B] int32 argmax of [B, V] logits, on the logits' device."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_tokens(logits, temps, seeds, positions) -> torch.Tensor:
    """[B] next-token ids (int32, on the logits' device) from [B, V]
    logits. ``temps`` / ``seeds`` / ``positions`` are per row, host arrays
    or tensors. Rows at ``temps == 0`` return the exact argmax, rows at
    ``temps > 0`` the Gumbel-max sample of ``softmax(logits / temp)``
    keyed by ``fold_in(PRNGKey(seed), position)``, its noise in the
    logits' type. When ``temps`` is a host array with no hot row the draw
    is skipped; a tensor of temperatures (a captured step's input) always
    draws, then selects."""
    greedy = greedy_tokens(logits)
    if not torch.is_tensor(temps) and not np.any(np.asarray(temps) > 0.0):
        return greedy
    dev = logits.device
    t = torch.as_tensor(temps, dtype=torch.float32, device=dev).reshape(-1)
    k0, k1 = keys(seeds, positions, dev)
    noise = gumbel(k0, k1, logits.shape[-1], logits.dtype)
    scale = torch.clamp_min(t, _MIN_TEMP).to(logits.dtype)
    sampled = torch.argmax(logits / scale[:, None] + noise, dim=-1)
    return torch.where(t > 0.0, sampled.to(torch.int32), greedy)


def sample_token_host(logits_row, temperature: float, seed: int,
                      position: int) -> int:
    """One token from a host logits row, by the same keyed draw as the
    step functions make for identical ``(logits, temperature, seed,
    position)`` (the row in fp32, as the reference takes it). The greedy
    case does no tensor work."""
    row = np.asarray(logits_row)
    if temperature <= 0.0:
        return int(np.argmax(row))
    out = sample_tokens(
        torch.as_tensor(row.astype(np.float32))[None, :],
        np.full((1,), temperature, np.float32),
        np.asarray([seed], np.int64), np.asarray([position], np.int64))
    return int(out[0])
