"""Fault-injection exception types (a copy of ``repro.faults.errors``).

A deliberate leaf module (imports nothing, not even from ``repro_torch``): the
device simulator raises these from its execution path, and the recovery
machinery in the controller/scheduler catches them — both sides import
*this* module, so the ``core`` ← ``faults`` edge stays acyclic (the
injector itself imports ``core``, never the other way round).
"""
from __future__ import annotations


class FaultError(RuntimeError):
    """Base class for injected-fault failures."""


class ProcessorFault(FaultError):
    """An op was dispatched (fully or partially) onto a faulted processor
    rail — the recovery machinery should have replanned with the partition
    ratio pinned to the surviving processors first."""


class TransientOpFault(FaultError):
    """A single op execution failed transiently (driver hiccup, evicted
    workgroup). Retrying the op is expected to succeed once the injector's
    armed failure budget drains."""
