"""BF-IO core: the host-side numpy modules (workload models, the (IO)
solver, lookahead, routing policies, metrics, the power model, the
closed-form theory of the paper's Section 5 and the serving simulator)
and the batched balancer on the device,
:mod:`repro_torch.core.balancer_jax` (``bfio_assign``,
``bfio_assign_batch``, ``windowed_imbalance``)."""
from .workload import (  # noqa: F401
    ArrivalInstance,
    DriftModel,
    Request,
    constant_drift,
    drift_for_family,
    fractional_drift,
    make_instance,
    scaled_drift,
    unit_drift,
)
from .io_solver import (  # noqa: F401
    local_search,
    objective,
    solve_exact,
    solve_greedy,
    solve_io,
)
from .lookahead import (  # noqa: F401
    GeometricPredictor,
    NoisyOraclePredictor,
    OraclePredictor,
    trajectories,
)
from .policies import (  # noqa: F401
    BFIOPolicy,
    FCFSPolicy,
    JSQPolicy,
    Policy,
    PowerOfDPolicy,
    RoundRobinPolicy,
    SchedulerContext,
    make_policy,
)
from .metrics import SimMetrics, step_imbalance  # noqa: F401
from .energy import (  # noqa: F401
    A100_POWER,
    TPU_V5E_POWER,
    PowerModel,
    asymptotic_saving,
    energy_decomposition,
    energy_sandwich,
    saving_bound,
)
from .simulator import SimConfig, SimTrace, simulate  # noqa: F401
from . import theory  # noqa: F401
