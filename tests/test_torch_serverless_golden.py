"""The golden snapshot through the port: every fingerprint of
``tests/golden/serverless_golden.json`` recomputed by
``repro_torch.serverless`` and held EXACTLY equal (floats via
``float.hex``, sweep columns via sha256 of their raw bytes) — 15 scalar
``simulate_epoch`` reports, 55 event-engine ``run_event_epoch`` reports
under both recovery policies, and the 16 columns of the vectorized sweep.

The scenario matrix is a copy of ``golden_utils``' built from the port's
classes; the fingerprint functions are ``golden_utils``' own (they only
read report fields)."""
import hashlib
import json

import numpy as np
import pytest

pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import golden_utils as gu  # noqa: E402
from repro_torch.serverless import (ByzantineWorker,  # noqa: E402
                                    CheckpointRestore, ColdStartStorm,
                                    FaultPlan, PeerTakeover,
                                    ReactiveAutoscaler, S3, ServerlessSetup,
                                    Straggler, WorkerCrash, lambda_default,
                                    run_event_epoch, simulate_epoch)
from repro_torch.serverless.simulator import REDIS  # noqa: E402
from repro_torch.serverless.sweep import (SweepGrid,  # noqa: E402
                                          ram_scaled_compute,
                                          sweep_analytic)


def epoch_scenarios():
    return {
        "default": dict(n_params=gu.N_PARAMS, compute_s_per_batch=0.9,
                        setup=ServerlessSetup()),
        "s3_w8": dict(n_params=gu.N_PARAMS, compute_s_per_batch=0.9,
                      setup=ServerlessSetup(n_workers=8, ram_gb=3.0,
                                            channel=S3),
                      accumulation=8, significant_fraction=0.1),
        "small": dict(n_params=gu.N_PARAMS, compute_s_per_batch=1.7,
                      setup=ServerlessSetup(n_workers=2, ram_gb=1.0),
                      significant_fraction=0.5),
    }


def runtime_scenarios():
    crash = FaultPlan(crashes=(WorkerCrash(1, 30.0),))
    strag = FaultPlan(stragglers=(Straggler(2, slowdown=4.0),))
    mixed = FaultPlan.random(seed=3, n_workers=4, horizon_s=120.0,
                             crash_rate=0.5, straggler_rate=0.5,
                             byzantine_fraction=0.25, storm_prob=0.5)
    traced = FaultPlan.from_trace(lambda_default(), seed=5, n_workers=4,
                                  horizon_s=120.0, base_cold_start_s=2.5,
                                  crash_rate=0.3)
    base = dict(n_params=gu.N_PARAMS, compute_s_per_batch=0.9,
                setup=ServerlessSetup())
    s3 = dict(n_params=gu.N_PARAMS, compute_s_per_batch=0.9,
              setup=ServerlessSetup(n_workers=8, ram_gb=3.0, channel=S3))
    return {
        "fault_free": dict(base),
        "crash_restore": dict(base, faults=crash,
                              recovery=CheckpointRestore(
                                  checkpoint_every=4)),
        "crash_takeover": dict(base, faults=crash,
                               recovery=PeerTakeover()),
        "straggler": dict(base, faults=strag,
                          recovery=CheckpointRestore()),
        "storm": dict(base,
                      faults=FaultPlan(storm=ColdStartStorm(
                          extra_s=8.0, fraction=0.5), seed=7),
                      recovery=CheckpointRestore()),
        "byzantine_masked": dict(base,
                                 faults=FaultPlan(byzantine=(
                                     ByzantineWorker(0),)),
                                 recovery=CheckpointRestore(),
                                 robust_trim=1),
        "random_mix_restore": dict(base, faults=mixed,
                                   recovery=CheckpointRestore(),
                                   robust_trim=1),
        "random_mix_takeover": dict(base, faults=mixed,
                                    recovery=PeerTakeover(),
                                    robust_trim=1),
        "trace_replay": dict(base, faults=traced,
                             recovery=CheckpointRestore(
                                 checkpoint_every=3)),
        "autoscaled_straggler": dict(
            base, faults=strag, recovery=CheckpointRestore(),
            autoscaler=ReactiveAutoscaler(min_workers=1, max_workers=8)),
        "s3_crash_restore": dict(
            s3, faults=FaultPlan(crashes=(WorkerCrash(3, 20.0),)),
            recovery=CheckpointRestore(checkpoint_every=4)),
    }


def sweep_fingerprint():
    grid = SweepGrid(n_params=gu.N_PARAMS,
                     compute_s_per_batch=ram_scaled_compute(0.9),
                     archs=gu.PAPER_ARCHS, n_workers=(2, 4, 8),
                     ram_gb=(1.0, 2.0, 3.0), channels=(REDIS, S3),
                     accumulation=(8, 24),
                     significant_fraction=(0.1, 0.3))
    vec = sweep_analytic(grid)
    out = {"n_points": len(vec)}
    for col in gu.SWEEP_COLUMNS:
        arr = np.asarray(getattr(vec, col))
        spots = ([str(arr[0]), str(arr[-1])] if arr.dtype.kind == "U"
                 else [gu._hex(arr[0]), gu._hex(arr[-1])])
        out[col] = {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
                    "first_last": spots}
    return out


@pytest.fixture(scope="module")
def golden():
    with open(gu.GOLDEN_PATH) as f:
        return json.load(f)


def test_scenario_matrix_is_the_golden_one(golden):
    assert sorted(epoch_scenarios()) == sorted(gu.epoch_scenarios())
    assert sorted(runtime_scenarios()) == sorted(gu.runtime_scenarios())
    for arch in gu.PAPER_ARCHS:
        assert sorted(golden["epoch"][arch]) == sorted(epoch_scenarios())
        assert sorted(golden["runtime"][arch]) == sorted(runtime_scenarios())


@pytest.mark.parametrize("arch", gu.PAPER_ARCHS)
@pytest.mark.parametrize("scenario", sorted(epoch_scenarios()))
def test_epoch_reports_match_golden(golden, arch, scenario):
    kw = epoch_scenarios()[scenario]
    fp = gu.epoch_fingerprint(simulate_epoch(arch, **kw))
    assert fp == golden["epoch"][arch][scenario]


@pytest.mark.parametrize("arch", gu.PAPER_ARCHS)
@pytest.mark.parametrize("scenario", sorted(runtime_scenarios()))
def test_runtime_reports_match_golden(golden, arch, scenario):
    kw = runtime_scenarios()[scenario]
    fp = gu.runtime_fingerprint(run_event_epoch(arch, **kw))
    assert fp == golden["runtime"][arch][scenario]


def test_sweep_columns_match_golden(golden):
    fresh = sweep_fingerprint()
    assert fresh["n_points"] == golden["sweep"]["n_points"]
    for col in gu.SWEEP_COLUMNS:
        assert fresh[col] == golden["sweep"][col], col
