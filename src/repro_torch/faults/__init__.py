"""Fault injection + graceful degradation (see docs/robustness.md): the
counterpart of ``repro.faults``.

Typed, seedable fault schedules (:mod:`repro_torch.faults.plan`), an injector that
drives them against ``DeviceSim``'s virtual clock (:mod:`.injector`),
processor-fallback replanning (:mod:`.recovery`), and the exception leaf the
simulator raises from its execution path (:mod:`.errors`).
"""
from repro_torch.faults.errors import FaultError, ProcessorFault, TransientOpFault
from repro_torch.faults.injector import FaultInjector
from repro_torch.faults.plan import (CHAOS_SCENARIOS, KINDS, FaultEvent, FaultPlan,
                               chaos_plan)
from repro_torch.faults.recovery import pinned_partition, surviving_alpha

__all__ = [
    "CHAOS_SCENARIOS", "KINDS", "FaultError", "FaultEvent", "FaultInjector",
    "FaultPlan", "ProcessorFault", "TransientOpFault", "chaos_plan",
    "pinned_partition", "surviving_alpha",
]
