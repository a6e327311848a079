"""Chaos harness for real data-parallel training
(``repro.resilience``).

Runs the transformer configs data-parallel, one process a worker, under
deterministic fault schedules and recovers through the *same*
:class:`~repro_torch.serverless.recovery.RecoveryPolicy` objects the event
runtime scores, closing the loop between simulated time-to-recover and
what checkpoint-restore and peer takeover cost on real state.
"""
from repro_torch.resilience.harness import (RecoveryOutcome,
                                            ResilienceConfig,
                                            ResilientTrainer, RunResult)
from repro_torch.resilience.schedule import FaultSchedule
from repro_torch.resilience.store import InMemoryStore

__all__ = [
    "FaultSchedule",
    "InMemoryStore",
    "RecoveryOutcome",
    "ResilienceConfig",
    "ResilientTrainer",
    "RunResult",
]
