"""Parity of the port's serverless stack (``repro_torch.serverless``,
``repro_torch.costmodel``) with the reference beyond the golden snapshot:
both packages run on the same inputs and must agree EXACTLY (numpy and
host Python carried over with the reference's arithmetic).

Covered: ``simulate_epoch`` / ``round_plan`` for every registered arch
at the golden's three setups, ``paper_cost_check``, the five simulated
aggregators, a serial ``sweep_events`` grid and an ``adversarial_sweep``
grid, ``FaultPlan.random`` / ``from_trace``, the event runtime for the
beyond-paper archs and against the port's own frozen engine, and the
ArchSpec registry with ``get_strategy`` / ``make_strategy``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import golden_utils as gu  # noqa: E402
import repro.serverless as J  # noqa: E402
from repro.core import strategies as jstrategies  # noqa: E402
from repro.serverless import adversarial as jadv  # noqa: E402
from repro.serverless import archs as jarchs  # noqa: E402
from repro.serverless import simulator as jsim  # noqa: E402
from repro.serverless import sweep as jsweep  # noqa: E402
import repro_torch.serverless as T  # noqa: E402
from repro_torch.core import strategies as tstrategies  # noqa: E402
from repro_torch.costmodel import pricing as tpricing  # noqa: E402
from repro_torch.guards import no_tracer_fields  # noqa: E402
from repro_torch.serverless import adversarial as tadv  # noqa: E402
from repro_torch.serverless import archs as tarchs  # noqa: E402
from repro_torch.serverless import runtime as truntime  # noqa: E402
from repro_torch.serverless import runtime_ref as truntime_ref  # noqa: E402
from repro_torch.serverless import simulator as tsim  # noqa: E402
from repro_torch.serverless import sweep as tsweep  # noqa: E402

ALL_ARCHS = tarchs.list_archs()
BEYOND = tuple(a for a in ALL_ARCHS if a not in tarchs.paper_archs())
N_PARAMS = int(4.2e6)


def _setups(pkg):
    """The golden's three scalar scenarios, built from ``pkg``."""
    return {
        "default": dict(n_params=N_PARAMS, compute_s_per_batch=0.9,
                        setup=pkg.ServerlessSetup()),
        "s3_w8": dict(n_params=N_PARAMS, compute_s_per_batch=0.9,
                      setup=pkg.ServerlessSetup(n_workers=8, ram_gb=3.0,
                                                channel=pkg.S3),
                      accumulation=8, significant_fraction=0.1),
        "small": dict(n_params=N_PARAMS, compute_s_per_batch=1.7,
                      setup=pkg.ServerlessSetup(n_workers=2, ram_gb=1.0),
                      significant_fraction=0.5),
    }


def _plain(v):
    """``v`` with every dataclass, also inside tuples and lists, turned
    into (class name, field dict): the two packages' classes differ."""
    if dataclasses.is_dataclass(v):
        return type(v).__name__, _fields(v)
    if isinstance(v, (tuple, list)):
        return type(v)(_plain(x) for x in v)
    return v


def _fields(obj):
    """Dataclass fields as a dict, nested dataclasses as ``_plain``."""
    return {f.name: _plain(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


# ---------------------------------------------------------------------------
# analytic simulator
# ---------------------------------------------------------------------------
def test_port_registers_the_reference_archs_in_order():
    assert ALL_ARCHS == jarchs.list_archs()
    assert tarchs.paper_archs() == jarchs.paper_archs() == tsim.ARCHS
    assert len(BEYOND) == 7


@pytest.mark.parametrize("scenario", ["default", "s3_w8", "small"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_simulate_epoch_and_round_plan_match_reference(arch, scenario):
    tkw, jkw = _setups(T)[scenario], _setups(J)[scenario]
    assert _fields(T.round_plan(arch, **tkw)) == \
        _fields(J.round_plan(arch, **jkw))
    assert _fields(T.simulate_epoch(arch, **tkw)) == \
        _fields(J.simulate_epoch(arch, **jkw))


@pytest.mark.parametrize("model", ["mobilenet", "resnet18"])
@pytest.mark.parametrize("arch", gu.PAPER_ARCHS)
def test_paper_cost_check_matches_reference(model, arch):
    assert T.paper_cost_check(model, arch) == J.paper_cost_check(model, arch)
    if arch in ALL_ARCHS:
        assert tsim.paper_compute_anchor(arch, model) == \
            jsim.paper_compute_anchor(arch, model)
    assert T.PAPER_TABLE2 == J.PAPER_TABLE2


def test_pricing_constants_and_formulas_match_reference():
    from repro.costmodel import pricing as jpricing
    for name in dir(jpricing):
        if name.isupper():
            got, want = getattr(tpricing, name), getattr(jpricing, name)
            if dataclasses.is_dataclass(want):
                got, want = _fields(got), _fields(want)
            assert got == want, name
    for fn, args in (("lambda_cost", (12.5, 2.0, 3)), ("gpu_cost", (77.0, 2)),
                     ("tpu_cost", (77.0, 8)),
                     ("storage_ops_cost", (1000, 5000))):
        assert getattr(tpricing, fn)(*args) == getattr(jpricing, fn)(*args)


# ---------------------------------------------------------------------------
# simulated aggregators
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(jadv.SIM_AGGREGATORS))
def test_sim_aggregators_match_reference(name):
    """A batched [B, W, D] stack with one byzantine budget per row."""
    assert list(tadv.SIM_AGGREGATORS) == list(jadv.SIM_AGGREGATORS)
    rng = np.random.default_rng(7)
    W = 9
    stacked = rng.standard_normal((4, W, 33)) * rng.lognormal(size=(4, W, 1))
    stacked[:, :2] *= -25.0                     # two outliers per row
    f = np.minimum(np.array([0, 1, 2, 3]), tadv.sim_aggregator_max_f(name, W))
    got = tadv.SIM_AGGREGATORS[name](stacked, f)
    want = jadv.SIM_AGGREGATORS[name](stacked, f)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4, 33)
    assert tadv.sim_aggregator_max_f(name, W) == \
        jadv.sim_aggregator_max_f(name, W)
    assert tadv.byzantine_fractions(W) == jadv.byzantine_fractions(W)


# ---------------------------------------------------------------------------
# fault plans and the event runtime
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_plan_draws_match_reference(seed):
    kw = dict(seed=seed, n_workers=8, horizon_s=300.0, crash_rate=0.4,
              straggler_rate=0.5, byzantine_fraction=0.25, storm_prob=0.5)
    got, want = T.FaultPlan.random(**kw), J.FaultPlan.random(**kw)
    assert _fields(got) == _fields(want)
    assert got.storm_victims(8) == want.storm_victims(8)
    kw = dict(seed=seed, n_workers=6, horizon_s=200.0,
              base_cold_start_s=2.5, crash_rate=0.3,
              byzantine_fraction=0.2, n_spare_workers=3)
    got = T.FaultPlan.from_trace(T.lambda_default(), **kw)
    want = J.FaultPlan.from_trace(J.lambda_default(), **kw)
    assert _fields(got) == _fields(want)


def _runtime_cases(pkg):
    crash = pkg.FaultPlan(crashes=(pkg.WorkerCrash(1, 30.0),))
    mixed = pkg.FaultPlan.random(seed=4, n_workers=4, horizon_s=150.0,
                                 crash_rate=0.5, straggler_rate=0.5,
                                 byzantine_fraction=0.25, storm_prob=0.5)
    return {
        "fault_free": {},
        "crash_auto": dict(faults=crash, recovery="auto"),
        "mixed_takeover": dict(faults=mixed, recovery=pkg.PeerTakeover(),
                               robust_trim=1),
        "autoscaled": dict(
            faults=pkg.FaultPlan(stragglers=(pkg.Straggler(2, 4.0),)),
            recovery=pkg.CheckpointRestore(),
            autoscaler=pkg.ReactiveAutoscaler(min_workers=1, max_workers=8)),
    }


@pytest.mark.parametrize("case", ["fault_free", "crash_auto",
                                  "mixed_takeover", "autoscaled"])
@pytest.mark.parametrize("arch", BEYOND)
def test_event_runtime_matches_reference_beyond_paper(arch, case):
    base = dict(n_params=N_PARAMS, compute_s_per_batch=0.9)
    got = T.run_event_epoch(arch, **base, **_runtime_cases(T)[case])
    want = J.run_event_epoch(arch, **base, **_runtime_cases(J)[case])
    assert gu.runtime_fingerprint(got) == gu.runtime_fingerprint(want)


@pytest.mark.parametrize("arch", gu.PAPER_ARCHS)
def test_event_runtime_matches_the_frozen_engine(arch):
    """The optimized engine reproduces the port's frozen closure-per-event
    engine field for field on seeded random plans, and the frozen
    engine reproduces the reference's."""
    from repro.serverless import runtime_ref as jruntime_ref
    base = dict(n_params=N_PARAMS, compute_s_per_batch=0.9)
    for seed in range(4):
        kw = dict(seed=seed, n_workers=4, horizon_s=120.0, crash_rate=0.4,
                  straggler_rate=0.4, byzantine_fraction=0.25,
                  storm_prob=0.5)
        rec = (T.PeerTakeover(), J.PeerTakeover()) if seed % 2 else \
            (T.CheckpointRestore(), J.CheckpointRestore())
        opt = truntime.run_event_epoch(
            arch, faults=T.FaultPlan.random(**kw), recovery=rec[0],
            robust_trim=1, **base)
        frozen = truntime_ref.run_event_epoch(
            arch, faults=T.FaultPlan.random(**kw), recovery=rec[0],
            robust_trim=1, **base)
        ref = jruntime_ref.run_event_epoch(
            arch, faults=J.FaultPlan.random(**kw), recovery=rec[1],
            robust_trim=1, **base)
        assert gu.runtime_fingerprint(opt) == gu.runtime_fingerprint(frozen)
        assert gu.runtime_fingerprint(frozen) == gu.runtime_fingerprint(ref)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_default_recovery_matches_reference(arch):
    got = T.default_recovery(arch)
    want = J.default_recovery(arch)
    assert type(got).__name__ == type(want).__name__
    assert _fields(got) == _fields(want)


def test_report_rejects_tensor_fields():
    rep = T.run_event_epoch("spirt", n_params=N_PARAMS,
                            compute_s_per_batch=0.9)
    no_tracer_fields(rep)
    with pytest.raises(TypeError, match="holds a torch tensor"):
        dataclasses.replace(rep, total_cost=torch.tensor(1.0))
    with pytest.raises(TypeError, match="stage_totals"):
        dataclasses.replace(rep, stage_totals={"sync": torch.ones(())})


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------
def _event_points(pkg):
    return [pkg.EventSweepPoint(arch=a, n_params=N_PARAMS,
                                compute_s_per_batch=0.9,
                                setup=pkg.ServerlessSetup(n_workers=w),
                                autoscale_max=am, robust_trim=1)
            for a in ("spirt", "gpu", "async_spirt_q8")
            for w, am in ((4, 0), (6, 8))]


def test_sweep_events_matches_reference():
    rates = dict(crash_rate=0.3, straggler_rate=0.3,
                 byzantine_fraction=0.2, storm_prob=0.3)
    got = T.sweep_events(_event_points(T), rates=T.FaultRates(**rates),
                         n_replicates=4, seed=5, processes=1)
    want = J.sweep_events(_event_points(J), rates=J.FaultRates(**rates),
                          n_replicates=4, seed=5, processes=1)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        g, w = _fields(g), _fields(w)
        g.pop("point"), w.pop("point")
        assert g == w


def test_adversarial_sweep_matches_reference():
    kw = dict(n_workers=8, dim=12, steps=30)
    got = T.adversarial_sweep(T.AdversarialGrid(**kw), seed=3)
    want = J.adversarial_sweep(J.AdversarialGrid(**kw), seed=3)
    assert len(got) == len(want) > 50
    assert [_fields(c) for c in got] == [_fields(c) for c in want]


# ---------------------------------------------------------------------------
# the registry and the strategies it names
# ---------------------------------------------------------------------------
def _spec_fields(spec):
    out = {}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        out[f.name] = v.__name__ if callable(v) else v
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_arch_spec_fields_match_reference(arch):
    """Every field but the callables equal; the callables carry the
    reference's names."""
    assert _spec_fields(tarchs.get_arch(arch)) == \
        _spec_fields(jarchs.get_arch(arch))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_make_strategy_matches_reference(arch):
    """The same strategy class with the same fields.  The one field whose
    values differ is MLLess's ``use_kernel``: the reference's default
    ``None`` picks its kernel by backend, the port's ``True`` by the
    tensor's device — both reach the kernel where there is one."""
    got = tarchs.get_arch(arch).make_strategy()
    want = jarchs.get_arch(arch).make_strategy()
    assert type(got).__name__ == type(want).__name__
    g, w = _fields(got), _fields(want)
    assert g.keys() == w.keys()
    if "use_kernel" in g:
        assert (g.pop("use_kernel"), w.pop("use_kernel")) == (True, None)
    assert g == w
    assert type(tstrategies.get_strategy(arch)).__name__ == \
        type(jstrategies.get_strategy(arch)).__name__


def test_get_strategy_resolves_registry_names_as_reference():
    assert type(tstrategies.get_strategy("gpu")) is tstrategies.AllReduce
    assert type(tarchs.get_arch("allreduce").make_strategy()) is \
        tstrategies.ParameterServer
    # STRATEGIES is searched before the registry, in both packages
    assert type(tstrategies.get_strategy("allreduce")) is \
        tstrategies.AllReduce
    assert type(jstrategies.get_strategy("allreduce")).__name__ == \
        "AllReduce"
    q = tstrategies.get_strategy("quantized_scatterreduce", chunk=256)
    assert type(q).__name__ == "QuantizedScatterReduce" and q.chunk == 256
    assert "quantized_scatterreduce" not in tstrategies.STRATEGIES
    with pytest.raises(KeyError, match="unknown strategy"):
        tstrategies.get_strategy("no_such_arch")


def test_make_strategy_keeps_the_self_naming_guard():
    spec = tarchs.ArchSpec(name="self_named", round_terms=lambda **k: {},
                           jax_strategy="self_named")
    with pytest.raises(ValueError, match="names itself"):
        spec.make_strategy()
    with pytest.raises(ValueError, match="has no strategy"):
        dataclasses.replace(spec, jax_strategy=None).make_strategy()
    tarchs.register_arch(spec)
    try:
        with pytest.raises(ValueError, match="names itself"):
            tstrategies.get_strategy("self_named")
    finally:
        tarchs.unregister_arch("self_named")


@pytest.mark.parametrize("arch", ["spirt", "gpu"])
def test_ram_scaled_compute_matches_reference(arch):
    for ram in (1.0, 2.0, 3.0, 10.24):
        assert tsweep.ram_scaled_compute(0.9)(arch, ram) == \
            jsweep.ram_scaled_compute(0.9)(arch, ram)
