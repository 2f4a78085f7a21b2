"""Streaming million-user workload engine (tentpole of the workload PR).

Edge serving is driven by *populations*, not request lists: diurnal load
cycles, flash crowds pinned to a region, heavy-tailed prompt/output
lengths, and task mixes that drift mid-run. This module generates that
traffic as a **stream** — :class:`WorkloadStream` is a restartable
iterator of typed :class:`repro_torch.serving.api.Request` objects that never
materializes the full trace, so a million-request scenario costs O(1)
memory and the *same seed always replays the same stream bit-for-bit*
(every draw comes from one ``np.random.default_rng(seed)`` consumed in a
fixed order; iterating twice re-creates the generator).

The arrival process is a non-homogeneous Poisson process sampled by
*thinning*: candidates are drawn from a homogeneous process at the
scenario's peak rate and accepted with probability ``rate(t) / peak``,
which keeps the stream lazy, exact and seed-stable. On top of the
arrivals:

* **diurnal cycle** — ``rate(t)`` swings sinusoidally around
  ``base_rate`` with ``diurnal_amplitude`` over ``diurnal_period``;
* **flash crowds** — each :class:`FlashCrowd` multiplies the rate inside
  its window and pins most of that burst's requests to one origin and
  (optionally) one task profile, the scenario the Eq.-4 placement review
  must chase;
* **regional skew** — origins are drawn Zipf-like
  (``P(origin=k) ∝ (k+1)^-origin_skew``);
* **heavy-tailed lengths** — prompt/output lengths are clipped
  lognormals;
* **task drift** — at ``task_shift_at`` the per-origin task profile
  flips from ``task{o}`` to ``task{o+n}``, the mid-run activation shift.

:func:`drive` feeds a stream into an :class:`~repro_torch.serving.cluster
.EdgeCluster` under a bounded backlog (submit-ahead window), and
:func:`goodput_report` turns the finished handles into the SLO economy:
goodput (SLO-attained tokens/sec), attainment, shed counts, and p50/p99
TTFT / inter-token latency split by scenario phase
(``flash`` / ``peak`` / ``offpeak``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.serving.api import EventType, Request


@dataclasses.dataclass(frozen=True)
class FlashCrowd:
    """One regional burst: between ``start`` and ``start + duration`` the
    arrival rate is multiplied by ``multiplier`` and a ``fraction`` of
    the burst's requests are pinned to ``origin`` (with ``task``
    overriding their task profile when set — a crowd that all wants the
    same thing is what moves the gating distribution)."""

    start: float
    duration: float
    multiplier: float = 4.0
    origin: int = 0
    fraction: float = 0.8
    task: str | None = None

    def __post_init__(self):
        if self.duration <= 0:
            raise ValueError(f"duration must be > 0 (got {self.duration})")
        if self.multiplier < 1.0:
            raise ValueError(
                f"multiplier must be >= 1 (got {self.multiplier})")
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(
                f"fraction must be in [0, 1] (got {self.fraction})")

    def active(self, t: float) -> bool:
        return self.start <= t < self.start + self.duration


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Declarative scenario description consumed by
    :class:`WorkloadStream`.

    duration:          scenario length in arrival-clock seconds.
    base_rate:         mean arrival rate (requests/s) before modulation.
    n_origins:         number of edge servers requests can arrive at.
    origin_skew:       Zipf exponent of the origin distribution (0 =
                       uniform; larger = more regional concentration).
    diurnal_period:    seconds per diurnal cycle.
    diurnal_amplitude: relative swing of the cycle in [0, 1); rate(t)
                       spans ``base_rate * (1 ± amplitude)``.
    crowds:            flash-crowd windows layered on the cycle.
    prompt_len:        (median, sigma, min, max) of the clipped lognormal
                       prompt-length distribution.
    output_len:        same shape for ``max_new_tokens``.
    task_shift_at:     when set, the per-origin task profile flips from
                       ``task{o}`` to ``task{o + n_origins}`` at this
                       time — the mid-run activation-distribution shift.
    slo:               per-request latency budget stamped on every
                       request (backend clock; None = no SLO).
    temperature:       sampling temperature stamped on every request
                       (each request still gets its own PRNG seed).
    seed:              the stream's PRNG seed; same seed = same stream.
    """

    duration: float = 120.0
    base_rate: float = 2.0
    n_origins: int = 3
    origin_skew: float = 1.0
    diurnal_period: float = 60.0
    diurnal_amplitude: float = 0.5
    crowds: tuple[FlashCrowd, ...] = ()
    prompt_len: tuple[float, float, int, int] = (96.0, 0.6, 8, 512)
    output_len: tuple[float, float, int, int] = (16.0, 0.5, 4, 64)
    task_shift_at: float | None = None
    slo: float | None = None
    temperature: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.duration <= 0:
            raise ValueError(f"duration must be > 0 (got {self.duration})")
        if self.base_rate <= 0:
            raise ValueError(
                f"base_rate must be > 0 (got {self.base_rate})")
        if self.n_origins < 1:
            raise ValueError(
                f"n_origins must be >= 1 (got {self.n_origins})")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError(
                "diurnal_amplitude must be in [0, 1) "
                f"(got {self.diurnal_amplitude})")
        for c in self.crowds:
            if not 0 <= c.origin < self.n_origins:
                raise ValueError(
                    f"crowd origin {c.origin} out of range for "
                    f"{self.n_origins} origin(s)")

    # -- the rate function the thinning sampler accepts against ---------
    def rate(self, t: float) -> float:
        """Instantaneous arrival rate (requests/s) at time ``t``."""
        r = self.base_rate * (1.0 + self.diurnal_amplitude
                              * math.sin(2.0 * math.pi * t
                                         / self.diurnal_period))
        for c in self.crowds:
            if c.active(t):
                r *= c.multiplier
        return r

    @property
    def peak_rate(self) -> float:
        """Upper bound of ``rate(t)`` — the thinning envelope."""
        peak = self.base_rate * (1.0 + self.diurnal_amplitude)
        if self.crowds:
            peak *= max(c.multiplier for c in self.crowds)
        return peak

    def phase_of(self, t: float) -> str:
        """Scenario phase at ``t``: ``flash`` inside any crowd window,
        else ``peak``/``offpeak`` by the diurnal cycle's sign."""
        for c in self.crowds:
            if c.active(t):
                return "flash"
        if math.sin(2.0 * math.pi * t / self.diurnal_period) >= 0.0:
            return "peak"
        return "offpeak"


class WorkloadStream:
    """Restartable lazy stream of typed requests for one
    :class:`WorkloadSpec`.

    Iterating yields :class:`repro_torch.serving.api.Request` objects in
    arrival order without ever holding more than one in memory. Every
    ``iter()`` restarts the underlying PRNG, so two passes over the same
    stream (or two streams built from the same spec) are bit-identical —
    the replay contract the benchmark asserts.
    """

    def __init__(self, spec: WorkloadSpec):
        self.spec = spec

    def __iter__(self):
        spec = self.spec
        rng = np.random.default_rng(spec.seed)
        peak = spec.peak_rate
        # Zipf-like origin distribution: P(k) ∝ (k+1)^-skew
        w = (np.arange(spec.n_origins) + 1.0) ** -spec.origin_skew
        origin_p = w / w.sum()
        pm, ps, plo, phi = spec.prompt_len
        om, os_, olo, ohi = spec.output_len
        t = 0.0
        while True:
            t += rng.exponential(1.0 / peak)
            if t >= spec.duration:
                return
            if rng.random() >= spec.rate(t) / peak:
                continue                       # thinned-out candidate
            origin = int(rng.choice(spec.n_origins, p=origin_p))
            task = None
            for c in spec.crowds:
                # the crowd draw is consumed even when it misses, so the
                # stream downstream of a window does not depend on how
                # many crowd requests were pinned
                if c.active(t) and rng.random() < c.fraction:
                    origin = c.origin
                    task = c.task
            if task is None:
                o = origin
                if (spec.task_shift_at is not None
                        and t >= spec.task_shift_at):
                    o += spec.n_origins
                task = f"task{o}"
            p_len = int(np.clip(round(float(pm)
                                      * math.exp(ps * rng.standard_normal())),
                                plo, phi))
            o_len = int(np.clip(round(float(om)
                                      * math.exp(os_ * rng.standard_normal())),
                                olo, ohi))
            yield Request(
                prompt=rng.integers(0, 2 ** 15, size=p_len, dtype=np.int32),
                max_new_tokens=o_len, origin=origin,
                temperature=spec.temperature, slo=spec.slo,
                arrival=round(t, 9), task=task,
                seed=int(rng.integers(2 ** 31 - 1)))

    def phase_of(self, t: float) -> str:
        return self.spec.phase_of(t)


# ---------------------------------------------------------------------------
# Feeding a cluster under bounded memory
# ---------------------------------------------------------------------------

def _backlog(cluster) -> int:
    """Requests the backend is holding but has not finished serving."""
    b = cluster.backend
    pend = getattr(b, "_pending", None)
    if pend is not None:                       # sim backend: arrival heap
        return len(pend)
    return sum(len(r.queue) + r.active for r in b.runtimes)


def drive(cluster, stream, max_pending: int = 256) -> list:
    """Feed ``stream`` into ``cluster`` under a bounded backlog.

    Submits requests in arrival order; whenever the backend's backlog
    reaches ``max_pending`` the cluster is stepped until it drains below
    the cap, so drive()'s memory footprint is O(max_pending) no
    matter how long the stream is. Returns the handles in submission
    order (``cluster.run()`` finishes the tail)."""
    if max_pending < 1:
        raise ValueError(f"max_pending must be >= 1 (got {max_pending})")
    handles = []
    for req in stream:
        handles.append(cluster.submit(req))
        while _backlog(cluster) >= max_pending:
            if not cluster.step():
                break
    cluster.run()
    return handles


# ---------------------------------------------------------------------------
# Goodput accounting
# ---------------------------------------------------------------------------

def _pct(xs: list) -> dict:
    if not xs:
        return {"p50": 0.0, "p99": 0.0}
    return {"p50": round(float(np.percentile(xs, 50)), 6),
            "p99": round(float(np.percentile(xs, 99)), 6)}


def _ttft_itl(h) -> tuple[float, list] | None:
    """(TTFT, [inter-token gaps]) for one finished handle, in its
    backend's clock. Runtime handles carry real TOKEN timestamps; sim
    handles model the split — service time spread uniformly over the
    prompt+decode tokens, TTFT = wait + (prompt+1) token times."""
    sub = h.submitted_at if h.submitted_at is not None else 0.0
    tok = [e.time for e in h.events if e.type == EventType.TOKEN]
    if tok:
        return tok[0] - sub, list(np.diff(tok))
    m = h.metrics
    wait, latency = m.get("wait"), m.get("latency")
    tokens = int(m.get("tokens") or 0)
    if wait is None or latency is None or tokens <= 0:
        return None
    T = len(h.request.prompt)
    itl = max(latency - wait, 0.0) / max(T + tokens, 1)
    return wait + itl * (T + 1), [itl] * max(tokens - 1, 0)


def goodput_report(handles, span: float | None = None,
                   phase_of=None) -> dict:
    """SLO economy of one serving run.

    handles:  the cluster's request handles (finished ones are counted;
              shed ones count as sheds, never as attained tokens).
    span:     clock span to rate goodput over; defaults to last FINISHED
              time minus first submit time.
    phase_of: optional ``time -> phase name`` map (e.g.
              ``WorkloadSpec.phase_of``) keyed on each request's submit
              time; adds a per-phase breakdown.

    Goodput counts only tokens of finished, un-shed requests whose SLO
    verdict is not ``False`` — a request with no SLO is unconditionally
    good, a late one contributes nothing (its tokens were wasted work).
    """
    finished = sheds = met = with_slo = 0
    good_tokens = total_tokens = 0
    t_lo = t_hi = None
    ttfts: list = []
    itls: list = []
    phases: dict = {}
    for h in handles:
        if not h.done:
            continue
        finished += 1
        m = h.metrics
        sub = h.submitted_at if h.submitted_at is not None else 0.0
        end = h.events[-1].time if h.events else sub
        t_lo = sub if t_lo is None else min(t_lo, sub)
        t_hi = end if t_hi is None else max(t_hi, end)
        ph = None
        if phase_of is not None:
            ph = phase_of(sub)
            phases.setdefault(ph, {
                "requests": 0, "sheds": 0, "slo_met": 0, "with_slo": 0,
                "attained_tokens": 0, "_ttft": [], "_itl": []})
            phases[ph]["requests"] += 1
        if m.get("shed"):
            sheds += 1
            with_slo += 1
            if ph is not None:
                phases[ph]["sheds"] += 1
                phases[ph]["with_slo"] += 1
            continue
        tokens = int(m.get("tokens", len(h.tokens)) or 0)
        total_tokens += tokens
        verdict = m.get("slo_met")
        if verdict is not None:
            with_slo += 1
            if ph is not None:
                phases[ph]["with_slo"] += 1
        if verdict is not False:               # met, or no SLO attached
            good_tokens += tokens
            if verdict is True:
                met += 1
                if ph is not None:
                    phases[ph]["slo_met"] += 1
            if ph is not None:
                phases[ph]["attained_tokens"] += tokens
        ti = _ttft_itl(h)
        if ti is not None:
            ttfts.append(ti[0])
            itls.extend(ti[1])
            if ph is not None:
                phases[ph]["_ttft"].append(ti[0])
                phases[ph]["_itl"].extend(ti[1])
    if span is None:
        span = (t_hi - t_lo) if (t_lo is not None and t_hi > t_lo) else 1.0
    out = {
        "requests": len(handles),
        "finished": finished,
        "sheds": sheds,
        "slo_met": met,
        "slo_attainment": round(met / with_slo, 6) if with_slo else 1.0,
        "total_tokens": int(total_tokens),
        "goodput_tokens_per_s": round(good_tokens / span, 6),
        "span": round(float(span), 6),
        "ttft": _pct(ttfts),
        "itl": _pct(itls),
    }
    for ph, d in phases.items():
        d["ttft"] = _pct(d.pop("_ttft"))
        d["itl"] = _pct(d.pop("_itl"))
        d["slo_attainment"] = (round(d["slo_met"] / d["with_slo"], 6)
                               if d["with_slo"] else 1.0)
        del d["with_slo"]
    if phase_of is not None:
        out["phases"] = phases
    return out
