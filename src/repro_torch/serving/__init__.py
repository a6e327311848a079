"""Request-level serving simulation subsystem.

Import-light by design: the workload / fleet / steady-state layers are
numpy-only so analytic sweeps never pay accelerator import costs.  The
real engine (``torch``-backed) stays a direct-module import:
``from repro_torch.serving.engine import ServingEngine``.
"""
from repro_torch.serving.workload import (  # noqa: F401
    RequestPlan, Workload,
)
from repro_torch.serving.fleet import (  # noqa: F401
    FleetReport, FleetSim,
)
from repro_torch.serving.steady_state import (  # noqa: F401
    ServingGrid, ServingSweep, analytic_point, serving_sweep_analytic,
)
