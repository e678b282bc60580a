"""Scenario trace generators — deterministic, seedable arrival traces (a copy
of ``repro.fleet.workloads``).

Each generator produces a :class:`Trace` of timestamped requests with a
model id, SLO and priority, mirroring the workload families that dominate
real mobile deployments ("Smart at what cost?" characterisation):

  * ``voice``  — voice-assistant sessions: Poisson session starts, each a
    short burst of utterances (LLM-style requests with a prompt length and
    decode budget).
  * ``video``  — video analytics: periodic detector frames with jitter.
  * ``ar``     — camera AR: sustained high-FPS segmentation frames with a
    tight SLO, plus periodic detector keyframes.
  * ``mixed``  — diurnal mixture: all three families thinned by a
    day-curve mapped onto the trace duration.
  * ``chaos_voice`` / ``chaos_mixed`` — the chaos-testing variants: the
    same request families with per-request deadlines and a low-priority
    background tier, replayed under the matching injected-fault schedule
    (``repro_torch.faults.plan.chaos_plan``) so shedding, deadline requeues and
    processor fallback all exercise (docs/robustness.md).

The same ``(scenario, duration, seed)`` always yields byte-identical traces
(``tests/test_fleet.py``); the fleet replay harness derives one trace per
device from the fleet seed.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# model ids — resolved to operator graphs (or serving-engine workers) by
# repro.fleet.replay; SLOs are in simulated seconds against the virtual clock
VISION = "vision-det"  # detector (YOLOv2-tiny @416)
AR = "ar-seg"          # AR segmentation (YOLOv2-tiny @224: lighter, tighter)
ASSISTANT = "assistant-llm"  # reduced-LLM decode graph

VISION_SLO_S = 0.12
AR_SLO_S = 0.05
ASSISTANT_SLO_S = 0.10


@dataclass(frozen=True)
class TraceRequest:
    uid: int
    t_arrival_s: float
    model: str
    slo_s: float
    priority: int = 0
    # LLM-style requests (serving backend); 0/0 for vision frames
    prompt_len: int = 0
    max_new_tokens: int = 0
    # hard completion deadline relative to arrival (chaos scenarios): the
    # serving engine requeues-with-backoff then errors; None = no deadline
    deadline_s: Optional[float] = None


@dataclass(frozen=True)
class Trace:
    scenario: str
    seed: int
    duration_s: float
    requests: Tuple[TraceRequest, ...]

    def __len__(self) -> int:
        return len(self.requests)

    def __iter__(self) -> Iterator[TraceRequest]:
        return iter(self.requests)

    def summary(self) -> Dict[str, object]:
        counts: Dict[str, int] = {}
        for r in self.requests:
            counts[r.model] = counts.get(r.model, 0) + 1
        return {"scenario": self.scenario, "seed": self.seed,
                "duration_s": self.duration_s, "n_requests": len(self.requests),
                "per_model": counts,
                "mean_rate_rps": len(self.requests) / max(self.duration_s, 1e-9)}


def _finish(scenario: str, seed: int, duration_s: float, reqs: List[Tuple]) -> Trace:
    """Sort by arrival and assign uids in arrival order (ties: insertion)."""
    order = sorted(range(len(reqs)), key=lambda i: (reqs[i][0], i))
    out = tuple(TraceRequest(uid, *reqs[i]) for uid, i in enumerate(order))
    return Trace(scenario, seed, duration_s, out)


def _poisson_times(rng: np.random.Generator, rate_per_s: float,
                   duration_s: float) -> List[float]:
    t, out = 0.0, []
    if rate_per_s <= 0.0:
        return out
    while True:
        t += float(rng.exponential(1.0 / rate_per_s))
        if t >= duration_s:
            return out
        out.append(t)


def voice_assistant(duration_s: float = 30.0, seed: int = 0,
                    rate_scale: float = 1.0) -> Trace:
    """Bursty sessions: each session start spawns 1 + Geometric(0.5)
    utterances spaced by ~1.5 s thinking gaps."""
    rng = np.random.default_rng(seed)
    reqs: List[Tuple] = []
    for t0 in _poisson_times(rng, 0.10 * rate_scale, duration_s):
        n_utter = 1 + int(rng.geometric(0.5))
        t = t0
        for _ in range(n_utter):
            if t >= duration_s:
                break
            reqs.append((t, ASSISTANT, ASSISTANT_SLO_S, 1,
                         int(rng.integers(8, 24)), int(2 + rng.integers(0, 6))))
            t += float(rng.exponential(1.5))
    return _finish("voice", seed, duration_s, reqs)


def video_analytics(duration_s: float = 30.0, seed: int = 0,
                    rate_scale: float = 1.0) -> Trace:
    """Periodic detector frames (default 4 fps) with capture jitter."""
    rng = np.random.default_rng(seed)
    fps = 4.0 * rate_scale
    reqs: List[Tuple] = []
    k = 0
    while (k + 1) / fps < duration_s:
        t = (k + 1) / fps + float(rng.normal(0.0, 0.01))
        if 0.0 <= t < duration_s:
            reqs.append((t, VISION, VISION_SLO_S, 0, 0, 0))
        k += 1
    return _finish("video", seed, duration_s, reqs)


def camera_ar(duration_s: float = 30.0, seed: int = 0,
              rate_scale: float = 1.0) -> Trace:
    """Sustained AR load: high-FPS segmentation frames under a tight SLO,
    plus a detector keyframe every ~2 s for re-localisation."""
    rng = np.random.default_rng(seed)
    fps = 12.0 * rate_scale
    reqs: List[Tuple] = []
    k = 0
    while (k + 1) / fps < duration_s:
        t = (k + 1) / fps + float(rng.normal(0.0, 0.004))
        if 0.0 <= t < duration_s:
            reqs.append((t, AR, AR_SLO_S, 2, 0, 0))
        k += 1
    for t in _poisson_times(rng, 0.5 * rate_scale, duration_s):
        reqs.append((t, VISION, VISION_SLO_S, 0, 0, 0))
    return _finish("ar", seed, duration_s, reqs)


def mixed_diurnal(duration_s: float = 30.0, seed: int = 0,
                  rate_scale: float = 1.0) -> Trace:
    """Diurnal mixture: the trace window maps onto one day-curve cycle
    (night trough -> midday peak), thinning a mixture of all three request
    families. Captures the population-level traffic shape a fleet sees."""
    rng = np.random.default_rng(seed)
    base_rate = 10.0 * rate_scale  # peak requests/s before thinning
    mix = ((AR, 0.45, AR_SLO_S, 2), (VISION, 0.35, VISION_SLO_S, 0),
           (ASSISTANT, 0.20, ASSISTANT_SLO_S, 1))
    probs = np.array([m[1] for m in mix])
    reqs: List[Tuple] = []
    for t in _poisson_times(rng, base_rate, duration_s):
        # day curve in [0.3, 1.0]: trough at the window edges, peak mid-trace
        day = 0.3 + 0.7 * 0.5 * (1.0 - np.cos(2.0 * np.pi * t / duration_s))
        if rng.random() > day:
            continue
        model, _, slo, prio = mix[int(rng.choice(len(mix), p=probs))]
        if model == ASSISTANT:
            reqs.append((t, model, slo, prio,
                         int(rng.integers(8, 24)), int(2 + rng.integers(0, 6))))
        else:
            reqs.append((t, model, slo, prio, 0, 0))
    return _finish("mixed", seed, duration_s, reqs)


ASSISTANT_DEADLINE_S = 6 * ASSISTANT_SLO_S  # ~p95 headroom over the SLO


def chaos_voice(duration_s: float = 30.0, seed: int = 0,
                rate_scale: float = 1.0) -> Trace:
    """The chaos-testing voice workload: denser assistant sessions with
    per-request deadlines, plus a priority-0 background tier (prefetch /
    summarisation jobs) that exists to be shed under ``battery_critical``.
    Priorities: 2 = the session's opening utterance (interactive), 1 =
    follow-ups, 0 = background. Replayed under the ``chaos_voice`` fault
    schedule by ``repro_torch.fleet.replay``."""
    rng = np.random.default_rng(seed)
    reqs: List[Tuple] = []
    for t0 in _poisson_times(rng, 0.5 * rate_scale, duration_s):
        n_utter = 1 + int(rng.geometric(0.5))
        t = t0
        for j in range(n_utter):
            if t >= duration_s:
                break
            reqs.append((t, ASSISTANT, ASSISTANT_SLO_S, 2 if j == 0 else 1,
                         int(rng.integers(8, 24)), int(2 + rng.integers(0, 6)),
                         ASSISTANT_DEADLINE_S))
            t += float(rng.exponential(1.0))
    for t in _poisson_times(rng, 0.4 * rate_scale, duration_s):
        reqs.append((t, ASSISTANT, ASSISTANT_SLO_S, 0,
                     int(rng.integers(16, 48)), int(4 + rng.integers(0, 6)),
                     2 * ASSISTANT_DEADLINE_S))
    return _finish("chaos_voice", seed, duration_s, reqs)


def chaos_mixed(duration_s: float = 30.0, seed: int = 0,
                rate_scale: float = 1.0) -> Trace:
    """``mixed_diurnal`` with a completion deadline stamped on every
    request (6x its SLO) — identical arrivals/RNG stream, replayed under
    the ``chaos_mixed`` fault schedule (which includes transient op
    failures on the vision/graph path)."""
    base = mixed_diurnal(duration_s=duration_s, seed=seed,
                         rate_scale=rate_scale)
    reqs = tuple(dataclasses.replace(r, deadline_s=6 * r.slo_s)
                 for r in base.requests)
    return Trace("chaos_mixed", seed, duration_s, reqs)


SCENARIOS = {
    "voice": voice_assistant,
    "video": video_analytics,
    "ar": camera_ar,
    "mixed": mixed_diurnal,
    "chaos_voice": chaos_voice,
    "chaos_mixed": chaos_mixed,
}


def make_trace(scenario: str, duration_s: float = 30.0, seed: int = 0,
               rate_scale: float = 1.0) -> Trace:
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; "
                         f"choose from {sorted(SCENARIOS)}")
    return SCENARIOS[scenario](duration_s=duration_s, seed=seed,
                               rate_scale=rate_scale)
