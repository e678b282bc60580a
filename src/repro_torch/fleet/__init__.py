"""Trace-driven workload & device-fleet replay subsystem (``repro_torch.fleet``,
the counterpart of ``repro.fleet``).

Turns the single-device AdaOper reproduction into a population-level
evaluation harness: scenario arrival traces (``workloads``), heterogeneous
device tiers with battery accounting (``population``), a discrete-event
virtual-time replay driving one controller/serving stack per device
(``replay``), and fleet-aggregate reporting (``report``). See
``docs/fleet.md``.
"""
from repro_torch.fleet.population import (  # noqa: F401
    DEFAULT_MIX,
    TIERS,
    DeviceProfile,
    TierSpec,
    sample_device,
    sample_population,
)
from repro_torch.fleet.replay import (  # noqa: F401
    DeviceReplay,
    FleetReplay,
    default_graph_registry,
)
from repro_torch.fleet.report import (  # noqa: F401
    DeviceMetrics,
    FleetReport,
    RequestRecord,
    latency_percentiles,
)
from repro_torch.fleet.workloads import (  # noqa: F401
    SCENARIOS,
    Trace,
    TraceRequest,
    make_trace,
)
