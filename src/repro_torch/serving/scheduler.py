"""Energy-aware batch planner for the serving engine: the counterpart of
``repro.serving.scheduler``.

``AdaOperScheduler`` consults the runtime energy profiler + DP partitioner
to pick, per batch, (a) the operator partition plan and (b) the microbatch
size that minimises predicted energy-delay product. Plans are memoised in
an LRU keyed by the quantized device-state bucket and the profiler's
correction version; on a cache miss every plan is additionally stamped with
its per-rail (cpu/gpu/bus) energy *fractions* from the device simulator's
physics, so the engine can attribute predicted joules per rail in the
telemetry ledger (``repro_torch.core.telemetry``). The joules are the
simulator's mobile-SoC model, not the energy of the device the models run
on. With a ``CoexecPlanner`` (``coexec=``) and two or more busy models, every
DP solve prices contention with the co-runners (``core.coexec``). With an
uncertainty model on the profiler (``repro_torch.uncertainty``) every fresh
plan is stamped with its calibrated (latency, energy) interval.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Tuple

from repro_torch.core.coexec import FULL_DUTY, CoexecPlanner
from repro_torch.core.opgraph import build_transformer_graph
from repro_torch.core.partitioner import dp_partition, score_plan
from repro_torch.core.profiler import state_bucket
from repro_torch.faults.recovery import pinned_partition, surviving_alpha


def combine_rails(parts) -> Optional[Tuple[float, float, float]]:
    """Energy-weighted combination of (fractions, energy_j) pairs — e.g. a
    prefill plan plus ``max_new`` decode steps. Pairs with ``None``
    fractions (no attribution available) drop their weight."""
    tot = cpu = gpu = bus = 0.0
    for fr, weight in parts:
        if fr is None or weight <= 0.0:
            continue
        cpu += fr[0] * weight
        gpu += fr[1] * weight
        bus += fr[2] * weight
        tot += weight
    if tot <= 0.0:
        return None
    return (cpu / tot, gpu / tot, bus / tot)


class AdaOperScheduler:
    """Energy-aware batch planner: for each candidate microbatch size,
    predict (latency, energy) of prefill+decode opgraphs with the profiler
    under the observed device state, DP-partition each, and pick the EDP
    minimiser. Returns the plan so the runtime can apply it.

    Fast path: graphs are built once per (cfg, batch, length-bucket, kind)
    and plans are memoised in an LRU keyed additionally by the quantized
    device-state bucket and the profiler's correction version — so a warm
    cache answers a schedule decision with zero cost-model evaluations,
    and any drift feedback (version bump) or state move invalidates it.
    """

    def __init__(self, profiler, sim, objective: str = "edp",
                 candidate_batches=(1, 2, 4, 8), plan_cache_size: int = 256,
                 graph_cache_size: int = 64,
                 coexec: Optional[CoexecPlanner] = None):
        self.profiler = profiler
        self.sim = sim
        self.objective = objective
        self.candidates = candidate_batches
        self.plan_cache_size = plan_cache_size
        self.graph_cache_size = graph_cache_size
        # contention-aware joint planning (repro_torch.core.coexec): None (the
        # default) and single-resident serving keep every plan, cache key
        # and solve bit-identical to the independent path
        self.coexec = coexec
        self._resident: tuple = ()
        self._graph_cache: OrderedDict = OrderedDict()
        self._plan_cache: OrderedDict = OrderedDict()
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0

    def set_resident(self, models) -> bool:
        """Declare the currently-busy worker set (the engine calls this each
        serve round). Returns True when the set changed — the engine's
        drift-scoped plan memo must be cleared then under a coexec planner,
        since its keys do not carry residency."""
        names = tuple(sorted(models))
        if names == self._resident:
            return False
        self._resident = names
        return True

    def _coexec_cost(self, cost_fn):
        """(possibly contention-wrapped cost_fn, extra plan-cache key).

        With joint planning active (a coexec planner and >= 2 resident
        workers), ops are priced against a full-duty co-runner profile —
        admission runs before co-runners' plan shapes are known, and the
        ledger-feedback corrections scale each rail from there. Inactive:
        returns the inputs untouched, so cache keys stay byte-identical."""
        if self.coexec is None or len(self._resident) <= 1:
            return cost_fn, ()
        n = max(len(self._resident), getattr(self.sim, "coexec", 1))
        wrapped = self.coexec.model.wrap(cost_fn, n, FULL_DUTY)
        return wrapped, ("coex", self._resident, n,
                         self.coexec.model.version())

    def _cache_key(self, obs) -> tuple:
        """Plan-cache scope: quantized device state, profiler correction
        version, and the sim's fault epoch — every fault/recovery
        transition shifts the epoch, so plans solved under a faulted rail
        can never serve a healthy device (or vice versa)."""
        return (state_bucket(obs), self.profiler.correction_version(),
                getattr(self.sim, "fault_epoch", 0))

    @staticmethod
    def _len_bucket(n: int) -> int:
        """Next power of two (min 16): nearby prompt lengths share graphs,
        cost tables and cached plans."""
        return max(16, 1 << (max(int(n), 1) - 1).bit_length())

    @staticmethod
    def _new_bucket(n: int) -> int:
        """Next power of two (min 1) for decode-length horizons and prefill
        batch buckets."""
        return 1 << (max(int(n), 1) - 1).bit_length()

    def _graph(self, cfg, batch: int, seq: int, kind: str):
        key = (cfg.name, batch, seq, kind)
        g = self._graph_cache.get(key)
        if g is None:
            g = self._graph_cache[key] = build_transformer_graph(cfg, batch, seq, kind=kind)
        else:
            self._graph_cache.move_to_end(key)
        while len(self._graph_cache) > self.graph_cache_size:
            self._graph_cache.popitem(last=False)
        return g

    def _candidates_for(self, n_waiting: int) -> List[int]:
        n = max(n_waiting, 1)
        cands = {c for c in self.candidates if c <= n}
        # exact-fit candidate: 3 waiting with candidates (1,2,4) must be able
        # to serve all 3 in one batch, not just 2
        cands.add(min(n, max(self.candidates)))
        return sorted(cands)

    def _plan_one(self, cfg, b: int, seq: int, kind: str, cost_fn, cache_key):
        """One cached DP solve for a (batch, seq, kind) graph, stamped on a
        fresh solve with ``rail_fractions`` — the simulator's per-rail
        energy shares of the planned split — for ledger attribution — and,
        with an uncertainty model attached, with its calibrated interval.

        With joint planning active (>= 2 resident workers and a coexec
        planner) the DP is solved against the contention-priced cost model
        and the winning alphas are re-scored on the base predictor, under a
        cache key extended with the resident set + contention version —
        single-resident serving takes the original key and solve,
        bit-identically."""
        joint_cost, joint_key = self._coexec_cost(cost_fn)
        key = (cfg.name, b, seq, kind) + cache_key + joint_key
        ent = self._plan_cache.get(key)
        if ent is not None:
            self.plan_cache_hits += 1
            self._plan_cache.move_to_end(key)
            return ent
        self.plan_cache_misses += 1
        g = self._graph(cfg, b, seq, kind)
        pinned = (surviving_alpha(self.sim)
                  if getattr(self.sim, "faulted_rails", None) else None)
        if pinned is None:
            ent = dp_partition(g, joint_cost, objective=self.objective)
            if joint_cost is not cost_fn:
                # contention priced the search; the accounting (admission,
                # EDP scoring, ledger charges) stays on the base predictor
                ent = score_plan(g, ent.alphas, cost_fn)
        else:
            # processor fallback: a rail is down, pin every op to the
            # survivor (cache-scoped to the fault epoch via cache_key)
            ent = pinned_partition(g, cost_fn, pinned)
        ent.rail_fractions = (self.sim.rail_fractions(g, ent.alphas)
                              if hasattr(self.sim, "rail_fractions") else None)
        # risk-aware serving: the plan's calibrated (latency, energy)
        # interval, which admission prices at an upper quantile and the
        # engine re-checks for an interval exit. None (no uncertainty model
        # attached, or a bare cost callable) is the inert default
        ent.interval = (cost_fn.plan_interval(g, ent.alphas)
                        if getattr(self.profiler, "uncertainty", None) is not None
                        and hasattr(cost_fn, "plan_interval") else None)
        ent.graph = g
        self._plan_cache[key] = ent
        while len(self._plan_cache) > self.plan_cache_size:
            self._plan_cache.popitem(last=False)
        return ent

    def _plan_pair(self, cfg, b: int, plen: int, max_new: int, cost_fn, cache_key):
        return (self._plan_one(cfg, b, plen, "prefill", cost_fn, cache_key),
                self._plan_one(cfg, b, plen + max_new, "decode", cost_fn, cache_key))

    def step_plan(self, cfg, batch: int, seq_len: int, max_new: int):
        """Per-iteration plan for an active pool of ``batch`` slots whose
        sequences fit the ``seq_len`` bucket: the decode-step plan only,
        batch and decode horizon pow2-bucketed; the returned ``batch`` is
        the bucketed value — normalise per-request energy by it."""
        obs = self.sim.observe()
        cost_fn = self.profiler.cost_fn(obs)
        cache_key = self._cache_key(obs)
        b = self._new_bucket(batch)
        seq = self._len_bucket(seq_len) + self._new_bucket(max_new)
        plan_dec = self._plan_one(cfg, b, seq, "decode", cost_fn, cache_key)
        out = {"batch": b,
               "step_latency": plan_dec.pred_latency,
               "step_energy": plan_dec.pred_energy,
               "rails": plan_dec.rail_fractions}
        if getattr(plan_dec, "interval", None) is not None:
            # the interval and the (graph, alphas) the engine re-prices to
            # detect an interval exit; absent on the point-estimate path
            out["interval"] = plan_dec.interval
            out["recheck"] = (plan_dec.graph, plan_dec.alphas)
        return out

    def prefill_plan(self, cfg, batch: int, seq_len: int):
        """Cached prefill plan for an admission (batch is pow2-bucketed)."""
        obs = self.sim.observe()
        cost_fn = self.profiler.cost_fn(obs)
        cache_key = self._cache_key(obs)
        b = self._new_bucket(batch)
        plan = self._plan_one(cfg, b, self._len_bucket(seq_len), "prefill",
                              cost_fn, cache_key)
        out = {"batch": b, "latency": plan.pred_latency,
               "energy": plan.pred_energy, "rails": plan.rail_fractions}
        if getattr(plan, "interval", None) is not None:
            out["interval"] = plan.interval
        return out

    def choose(self, cfg, n_waiting: int, prompt_len: int, max_new: int):
        """The EDP-minimising (batch, prefill plan, decode plan) for
        ``n_waiting`` requests of one prompt bucket."""
        obs = self.sim.observe()
        cost_fn = self.profiler.cost_fn(obs)
        cache_key = self._cache_key(obs)
        plen = self._len_bucket(prompt_len)
        best = None
        for b in self._candidates_for(n_waiting):
            plan_pre, plan_dec = self._plan_pair(cfg, b, plen, max_new, cost_fn, cache_key)
            lat = plan_pre.pred_latency + max_new * plan_dec.pred_latency
            en = plan_pre.pred_energy + max_new * plan_dec.pred_energy
            # normalise per request: energy-delay product per served request
            score = (lat / b) * (en / b)
            if best is None or score < best["score"]:
                best = {"batch": b, "score": score, "latency": lat, "energy": en,
                        "plan_prefill": plan_pre, "plan_decode": plan_dec,
                        "rails": combine_rails(
                            [(plan_pre.rail_fractions, plan_pre.pred_energy),
                             (plan_dec.rail_fractions,
                              max_new * plan_dec.pred_energy)])}
        return best
