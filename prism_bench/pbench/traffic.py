"""One general generator of the benchmark's traffic, driven by a mix file.

Two arrival kinds:

* ``poisson``: an open loop. Arrivals are a non-homogeneous Poisson process
  sampled by thinning (candidates at the peak rate, each kept with
  probability rate(t) / peak), as the program's ``WorkloadStream`` does:
  a diurnal swing and flash crowds (a window that multiplies the rate and
  pins a share of its requests to one origin) are parameters of the mix.
  Origins are Zipf-skewed; each origin has its own task and its requests
  draw from it with probability ``own_task_share``; every prompt starts
  with its origin's system prompt.
* ``backlog``: every request is due at t = 0. Documents of clipped
  lognormal length, each asked ``asks_per_doc`` times by its origin with a
  different question appended, the asks spread over the backlog with gaps
  drawn uniformly in ``ask_gap`` requests.

What a run's work is made of (arrival times, origins, tasks, lengths,
which document each ask reuses) is drawn from the mix's ``shape_seed``, so
every seed serves the same sizes at the same times; ``--seed`` draws the
tokens (and the weights elsewhere).
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

from pbench.tokens import TaskTokens, stable_seed


@dataclasses.dataclass
class Req:
    idx: int
    due: float  # seconds after the traffic starts
    origin: int
    task: int
    prompt: np.ndarray
    max_new: int
    doc: int = -1


def load_mix(root: Path, name: str) -> dict:
    """The mix ``name`` from ``root/traffic``; a mix may name another in
    ``extends`` and override some of its keys."""
    mix = json.loads((root / "traffic" / f"{name}.json").read_text())
    base = mix.pop("extends", None)
    if base is not None:
        mix = {**load_mix(root, base), **mix}
    mix["name"] = name
    return mix


def clipped_lognormal(rng, spec, n: int) -> np.ndarray:
    """``n`` lengths: ``median * exp(sigma * N(0, 1))`` rounded and clipped
    to ``[lo, hi]`` (``spec = [median, sigma, lo, hi]``)."""
    median, sigma, lo, hi = spec
    z = rng.standard_normal(n)
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(int)


def rate_at(mix: dict, t: float) -> float:
    r = mix["rate_per_s"] * (1.0 + mix.get("diurnal_amplitude", 0.0) * math.sin(
        2.0 * math.pi * t / mix.get("diurnal_period_s", 60.0)))
    for c in mix.get("crowds", ()):
        if c["start_s"] <= t < c["start_s"] + c["duration_s"]:
            r *= c["multiplier"]
    return r


def peak_rate(mix: dict) -> float:
    peak = mix["rate_per_s"] * (1.0 + mix.get("diurnal_amplitude", 0.0))
    crowds = mix.get("crowds", ())
    if crowds:
        peak *= max(c["multiplier"] for c in crowds)
    return peak


def _origin_probs(mix: dict) -> np.ndarray:
    w = (np.arange(mix["origins"]) + 1.0) ** -mix.get("origin_skew", 0.0)
    return w / w.sum()


def _poisson_shape(mix: dict, duration: float) -> list[dict]:
    rng = np.random.default_rng(mix["shape_seed"])
    n_org = mix["origins"]
    p_org = _origin_probs(mix)
    peak = peak_rate(mix)
    shift = mix.get("task_shift_at_s")
    out: list[dict] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / peak)
        if t >= duration:
            break
        if rng.random() >= rate_at(mix, t) / peak:
            continue
        origin = int(rng.choice(n_org, p=p_org))
        for c in mix.get("crowds", ()):
            # drawn even when it misses, so what follows a crowd does not
            # depend on how many requests it pinned
            if (c["start_s"] <= t < c["start_s"] + c["duration_s"]
                    and rng.random() < c["fraction"]):
                origin = int(c["origin"])
        task = origin
        if rng.random() >= mix.get("own_task_share", 1.0):
            task = int((origin + 1 + rng.integers(n_org - 1)) % n_org)
        if shift is not None and t >= shift:
            task += n_org
        (p_len,) = clipped_lognormal(rng, mix["prompt_len"], 1)
        (o_len,) = clipped_lognormal(rng, mix["output_len"], 1)
        out.append(dict(due=t, origin=origin, task=task, prompt=int(p_len),
                        max_new=int(o_len)))
    return out


def _backlog_shape(mix: dict) -> list[dict]:
    rng = np.random.default_rng(mix["shape_seed"])
    n_docs, asks = mix["documents"], mix["asks_per_doc"]
    doc_len = clipped_lognormal(rng, mix["doc_len"], n_docs)
    origin = rng.choice(mix["origins"], size=n_docs, p=_origin_probs(mix))
    q_lo, q_hi = mix["question_len"]
    g_lo, g_hi = mix["ask_gap"]
    order: dict[int, tuple[int, int]] = {}  # position -> (doc, ask)
    cursor = 0
    for d in range(n_docs):
        while cursor in order:
            cursor += 1
        pos = cursor
        for a in range(asks):
            if a:
                pos += 1 + int(rng.integers(g_lo, g_hi + 1))
            while pos in order:
                pos += 1
            order[pos] = (d, a)
    out = []
    for pos in sorted(order):
        d, _ = order[pos]
        q = int(rng.integers(q_lo, q_hi + 1))
        (o_len,) = clipped_lognormal(rng, mix["output_len"], 1)
        out.append(dict(due=0.0, origin=int(origin[d]), task=int(origin[d]),
                        prompt=int(doc_len[d]) + q, question=q, doc=d,
                        max_new=int(o_len)))
    return out


def build(mix: dict, seed: int, vocab: int, duration: float) -> list[Req]:
    """The requests of one run, in due order: shapes from the mix's
    ``shape_seed``, tokens from ``seed``. ``duration``: how many seconds of
    arrivals an open loop needs."""
    rng = np.random.default_rng(stable_seed("tokens", seed))
    tasks: dict[int, TaskTokens] = {}

    def task(k: int) -> TaskTokens:
        if k not in tasks:
            tasks[k] = TaskTokens(f"task{k}", vocab, seed)
        return tasks[k]

    out: list[Req] = []
    if mix["arrivals"] == "poisson":
        n_sys = mix.get("system_prompt_tokens", 0)
        system = [task(o).sample(rng, n_sys) for o in range(mix["origins"])]
        for i, s in enumerate(_poisson_shape(mix, duration)):
            body = task(s["task"]).sample(rng, s["prompt"] - n_sys)
            out.append(Req(i, s["due"], s["origin"], s["task"],
                           np.concatenate([system[s["origin"]], body]),
                           s["max_new"]))
    elif mix["arrivals"] == "backlog":
        docs: dict[int, np.ndarray] = {}
        for i, s in enumerate(_backlog_shape(mix)):
            d = s["doc"]
            if d not in docs:
                docs[d] = task(s["task"]).sample(rng,
                                                 s["prompt"] - s["question"])
            q = task(s["task"]).sample(rng, s["question"])
            out.append(Req(i, 0.0, s["origin"], s["task"],
                           np.concatenate([docs[d], q]), s["max_new"], d))
    else:
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    return out
