"""Uncertainty-aware energy prediction + risk-aware control (docs/uncertainty.md),
the counterpart of ``repro.uncertainty`` (numpy, no device).

Quantile GBDT ensembles give the profiler's point predictions a
heteroscedastic scale; online split-conformal calibration turns that scale
into intervals with a guaranteed-coverage multiplier. Attached to a
:class:`~repro_torch.core.profiler.RuntimeEnergyProfiler` the intervals drive
risk-aware admission, interval-stamped plans, and interval-triggered
repartition; unattached, every existing code path is bit-identical.
"""
from repro_torch.uncertainty.conformal import SplitConformal, conformal_quantile
from repro_torch.uncertainty.model import UncertaintyModel

__all__ = ["SplitConformal", "UncertaintyModel", "conformal_quantile"]
