"""AdaOper core of the port: the energy ledger, op graphs, the device
simulator, the runtime energy profiler (GBDT + GRU corrector), the DP
operator partitioner, the contention-aware joint planner, the closed-loop
controller and the paper's baselines; the exports of ``repro.core``."""
from repro_torch.core.baselines import codl_plan, mace_gpu_plan  # noqa: F401
from repro_torch.core.coexec import (  # noqa: F401
    CoexecPlanner,
    ContentionModel,
    RailLoad,
    joint_partition,
    plan_rail_load,
    predicted_rail_fractions,
)
from repro_torch.core.controller import AdaOperController  # noqa: F401
from repro_torch.core.gbdt import GBDTRegressor  # noqa: F401
from repro_torch.core.gru import GRUCorrector  # noqa: F401
from repro_torch.core.opgraph import (  # noqa: F401
    OpGraph,
    OpNode,
    build_transformer_graph,
    build_yolo_graph,
)
from repro_torch.core.partitioner import (  # noqa: F401
    ALPHA_LEVELS,
    PartitionPlan,
    dp_partition,
    incremental_repartition,
    score_plan,
)
from repro_torch.core.profiler import (  # noqa: F401
    CostTableCache,
    RuntimeEnergyProfiler,
    op_features,
    op_features_batch,
    state_bucket,
)
from repro_torch.core.simulator import CPU, GPU, PRESETS, DeviceSim, DeviceState  # noqa: F401
