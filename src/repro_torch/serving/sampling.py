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


def _check_greedy(temps) -> None:
    t = temps.cpu().numpy() if torch.is_tensor(temps) else np.asarray(temps)
    if np.any(t > 0.0):
        raise NotImplementedError(
            "temperature > 0 sampling (the reference's threefry Gumbel-max "
            "draw) is not ported yet")


def sample_tokens(logits, temps, seeds, positions) -> torch.Tensor:
    """[B] next-token ids (int32) from [B, V] logits. ``temps`` is a host
    array (or tensor) of per-row temperatures; every row must be greedy."""
    _check_greedy(temps)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_token_host(logits_row, temperature: float, seed: int,
                      position: int) -> int:
    """One greedy token from a host logits row."""
    _check_greedy([temperature])
    return int(np.argmax(np.asarray(logits_row)))
