"""The serverless stack (``repro.serverless``): the ArchSpec registry, the
analytic simulator, the event runtime with its fault plans, recovery
policies, autoscalers and traces, the sweeps, the attack registry and
the robust aggregators of real training."""
from repro_torch.serverless.archs import (  # noqa: F401
    ArchSpec, get_arch, list_archs, paper_archs, register_arch,
    unregister_arch,
)
from repro_torch.serverless.adversarial import (  # noqa: F401
    AttackSpec, SIM_AGGREGATORS, byzantine_fractions, get_attack,
    list_attacks, register_attack, sim_aggregator_max_f,
    unregister_attack,
)
from repro_torch.serverless.simulator import (  # noqa: F401
    ARCHS, Channel, EpochReport, PAPER_TABLE2, REDIS, RoundPlan, S3,
    ServerlessSetup, paper_cost_check, round_plan, simulate_epoch,
)
from repro_torch.serverless.runtime import (  # noqa: F401
    EventRuntime, RuntimeReport, default_recovery, resolve_recovery,
    run_event_epoch,
)
from repro_torch.serverless.faults import (  # noqa: F401
    ByzantineGradients, ByzantineWorker, ColdStartStorm, FaultPlan,
    Straggler, WorkerCrash,
)
from repro_torch.serverless.recovery import (  # noqa: F401
    CheckpointRestore, CoordinateMedian, GeometricMedian, Krum,
    PeerTakeover, RecoveryEvent, RecoveryPolicy, TrimmedMean,
    coordinate_median, geometric_median, krum, trimmed_mean,
    trimmed_mean_sort,
)
from repro_torch.serverless.autoscale import (  # noqa: F401
    ReactiveAutoscaler, ScheduledScaler,
)
from repro_torch.serverless.traces import (  # noqa: F401
    AZURE_LLM_2311_18677, LAMBDA_2105_07806, RequestTrace, Trace,
    lambda_default, request_default,
)
from repro_torch.serverless.sweep import (  # noqa: F401
    AdversarialCell, AdversarialGrid, AnalyticSweep, EventPointStats,
    EventSweepPoint, FaultRates, SweepGrid, adversarial_curve,
    adversarial_sweep, iter_grid, knee_point, pareto_front,
    ram_scaled_compute, scalar_sweep, sweep_analytic, sweep_events,
)
