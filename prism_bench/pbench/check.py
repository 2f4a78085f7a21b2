"""The checks that decide ``correct``, besides the logit comparison itself
(``reference/*.py``, run by ``bench``).

* Every finished request delivered exactly the tokens it asked for.
* The engine's per-origin routing counts, which ``local_ratio`` and
  ``remote_kb_per_tok`` are computed from: each tick adds whole (token,
  expert) rows, the same number in every layer, ``top_k`` per token; and
  over the run each origin's tokens through the model lie between what the
  harness counts from the requests' own events (computed prompt tokens of
  the requests whose first token came, plus one per later token) and that
  plus the whole computed prompts of the requests still prefilling.
* The placement the metrics read (the controller's plan) is the one the
  engine's slot tables hold.
"""

from __future__ import annotations

import numpy as np

from pbench.tokens import stable_seed


def sample(recs: list, seed: int, want_tokens: int) -> list:
    """Finished requests to compare: the longest, the last to finish (served
    after every placement the run applied) and others drawn from the seed,
    until ``want_tokens`` served tokens are in."""
    done = [r for r in recs if r.done_t is not None and r.token_t]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.req.prompt) + len(r.token_t))
    last = max(done, key=lambda r: r.done_t)
    chosen = [longest] + ([last] if last is not longest else [])
    rest = [r for r in done if r is not longest and r is not last]
    rng = np.random.default_rng(stable_seed("sample", seed))
    served = sum(len(r.token_t) for r in chosen)
    for i in rng.permutation(len(rest)):
        if served >= want_tokens:
            break
        chosen.append(rest[i])
        served += len(rest[i].token_t)
    return chosen


def wrong_lengths(recs: list) -> int:
    """Finished requests whose token count is not the one asked for."""
    return sum(1 for r in recs if r.done_t is not None
               and len(r.handle.tokens) != r.req.max_new)


def count_faults(ticks: list, total: np.ndarray, recs: list,
                 top_k: int) -> tuple[int, dict]:
    """Ticks and origins whose routing counts break the bookkeeping above
    (0 when sound), and each origin's (low, counted, high) tokens."""
    bad = 0
    for t in ticks:
        d = t.delta
        per_layer = d.sum(axis=-1)  # [L, N]
        if (d.min() < -1e-6 or np.abs(d - np.rint(d)).max() > 1e-6
                or np.abs(per_layer - per_layer[:1]).max() > 1e-6
                or np.abs(per_layer[0] / top_k
                          - np.rint(per_layer[0] / top_k)).max() > 1e-6):
            bad += 1
    n_org = total.shape[1]
    lo = np.zeros(n_org)
    extra = np.zeros(n_org)
    for r in recs:
        if r.handle is None:
            continue
        computed = 0 if r.full_hit else len(r.req.prompt) - r.skipped
        if r.token_t:
            lo[r.req.origin] += computed + len(r.token_t) - 1
        elif r.admit_t is not None:
            extra[r.req.origin] += computed
    counted = total.sum(axis=-1) / top_k  # [L, N]
    if np.abs(counted - counted[:1]).max() > 1e-6:
        bad += 1
    seen = {}
    for n in range(n_org):
        c = float(counted[0, n])
        seen[n] = (float(lo[n]), c, float(lo[n] + extra[n]))
        if not lo[n] - 1e-6 <= c <= lo[n] + extra[n] + 1e-6:
            bad += 1
    return bad, seen


def residency_mismatch(plan_res: np.ndarray, engine_res: np.ndarray) -> int:
    return int(((plan_res > 0) != (engine_res > 0)).sum())
