"""Next-token selection shared by every decode surface (PyTorch port of
``repro.serving.sampling``).

Greedy rows (``temperature == 0``) return ``argmax(logits)`` exactly, as in
the reference. The reference's seeded Gumbel-max draw for
``temperature > 0`` (threefry keys from ``(seed, position)``) is not ported
yet: asking for it raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch


def check_greedy(temps) -> None:
    """Raise unless every per-row temperature is 0. ``temps`` is read on
    the host (a device tensor is copied there): the captured serving steps
    take only the greedy ``argmax`` (``greedy_tokens``), so the runtime
    checks its host array before it replays one."""
    t = temps.cpu().numpy() if torch.is_tensor(temps) else np.asarray(temps)
    if np.any(t > 0.0):
        raise NotImplementedError(
            "temperature > 0 sampling (the reference's threefry Gumbel-max "
            "draw) is not ported yet")


def greedy_tokens(logits) -> torch.Tensor:
    """[B] int32 argmax of [B, V] logits, on the logits' device."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_tokens(logits, temps, seeds, positions) -> torch.Tensor:
    """[B] next-token ids (int32) from [B, V] logits. ``temps`` is a host
    array (or tensor) of per-row temperatures; every row must be greedy."""
    check_greedy(temps)
    return greedy_tokens(logits)


def sample_token_host(logits_row, temperature: float, seed: int,
                      position: int) -> int:
    """One greedy token from a host logits row."""
    check_greedy([temperature])
    return int(np.argmax(np.asarray(logits_row)))
