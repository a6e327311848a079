"""The port's request-level serving simulation (``serving.workload``,
``serving.fleet``, ``serving.steady_state``) and analytic cost counts
(``costmodel.flops``) against the reference.  These are numpy and host
arithmetic carried over unchanged, so every output must be equal, not
close: request plans, fleet reports, analytic sweeps, parameter, FLOP and
byte counts."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.costmodel import flops as jflops  # noqa: E402
from repro.serverless import traces as jtraces  # noqa: E402
from repro.serving import fleet as jfleet  # noqa: E402
from repro.serving import steady_state as jsteady  # noqa: E402
from repro.serving import workload as jworkload  # noqa: E402
from repro_torch import costmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, all_arch_names  # noqa: E402
from repro_torch.costmodel import flops  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serverless import traces  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    FleetSim, ServingGrid, Workload, analytic_point, serving_sweep_analytic,
)
from repro_torch.serving import workload  # noqa: E402

REQUEST_TRACE = dict(name="r", inter_arrival_s=(0.5, 1.0, 4.0),
                     prompt_tokens=(64.0, 256.0, 1024.0),
                     decode_tokens=(8.0, 32.0, 128.0))


def _both(**kw):
    """Keyword arguments for the port and for the reference, with each
    side's own trace object under ``trace``."""
    trace = kw.pop("trace", None)
    out = []
    for tr in (traces, jtraces):
        args = dict(kw)
        if trace == "request_default":
            args["trace"] = tr.request_default()
        elif trace == "request":
            args["trace"] = tr.RequestTrace(**REQUEST_TRACE)
        elif trace == "cold":
            args["trace"] = tr.Trace(cold_start_s=(2.0, 9.0, 30.0))
        out.append(args)
    return out


WORKLOADS = {
    "poisson": dict(n_requests=300, rate_rps=2.0),
    "poisson_tokens": dict(n_requests=400, rate_rps=4.0, prompt_tokens=256,
                           decode_tokens=64),
    "trace": dict(n_requests=200, trace="request"),
    "default_trace": dict(n_requests=300, trace="request_default"),
}


def _workloads(name, rate=None):
    mine, ref = _both(**WORKLOADS[name])
    a, b = Workload(**mine), jworkload.Workload(**ref)
    if rate is not None:
        a, b = a.with_rate(rate), b.with_rate(rate)
    return a, b


@pytest.mark.parametrize("rate", [None, 2.0], ids=["native", "rate2"])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_generate_equals_reference(name, rate):
    a, b = _workloads(name, rate)
    assert a.mean_rate_rps() == b.mean_rate_rps()
    assert a.mean_service_tokens() == b.mean_service_tokens()
    for seed in (0, 3, 42):
        pa, pb = a.generate(seed), b.generate(seed)
        assert dataclasses.asdict(pa) == dataclasses.asdict(pb)
        assert (pa.total_tokens, pa.span_s) == (pb.total_tokens, pb.span_s)


def test_stream_rng_equals_reference():
    for seed, stream in ((0, 0), (7, 2), (123, 1)):
        assert np.array_equal(workload._stream_rng(seed, stream).random(16),
                              jworkload._stream_rng(seed, stream).random(16))


@pytest.mark.parametrize("kw", [
    dict(n_requests=0, rate_rps=1.0),
    dict(),                                  # no rate, no trace
    dict(rate_rps=-2.0),
    dict(rate_rps=float("inf")),
    dict(rate_rps=1.0, prompt_tokens=0),
    dict(rate_rps=1.0, decode_tokens=0),
])
def test_workload_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        jworkload.Workload(**kw)
    with pytest.raises(ValueError):
        Workload(**kw)


FLEETS = {
    "spirt_cold_trace": (dict(arch="spirt", replicas=2, batch_size=4,
                              trace="cold", seed=5), "default_trace", 2.0),
    "spirt_autoscale": (dict(arch="spirt", replicas=1, batch_size=4,
                             cold_start_s=1.0, autoscale=True,
                             max_replicas=6, control_interval_s=5.0),
                        "poisson_tokens", None),
    "lambda_ram": (dict(arch="spirt", replicas=1, batch_size=8, ram_gb=4.0,
                        cold_start_s=0.0), "poisson_tokens", 2.0),
    "gpu": (dict(arch="gpu", replicas=2, batch_size=8, cold_start_s=0.0),
            "poisson_tokens", 4.0),
    "gpu_trace": (dict(arch="gpu", replicas=1, batch_size=8,
                       cold_start_s=0.0), "default_trace", 2.0),
    "mlless": (dict(arch="mlless", replicas=3, batch_size=2), "trace", None),
}


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_fleet_run_equals_reference(name):
    """Every field of the report, the per-request latencies and the
    autoscaler's decisions included, and ``analytic_point`` on the same
    fleet and workload."""
    kw, wname, rate = FLEETS[name]
    mine, ref = _both(**kw)
    sim, jsim = FleetSim(**mine), jfleet.FleetSim(**ref)
    assert sim.step_times() == jsim.step_times()
    wa, wb = _workloads(wname, rate)
    a, b = sim.run(wa.generate(1)), jsim.run(wb.generate(1))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert len(a.latencies_s) == a.n_requests > 0
    assert analytic_point(sim, wa) == jsteady.analytic_point(jsim, wb)


@pytest.mark.parametrize("kw", [
    dict(arch="no_such_arch"), dict(batch_size=0), dict(replicas=0),
    dict(min_replicas=3, replicas=2), dict(decode_step_s=0.0),
    dict(ram_gb=0.0), dict(control_interval_s=0.0),
])
def test_fleet_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        jfleet.FleetSim(**kw)
    with pytest.raises(ValueError):
        FleetSim(**kw)


def _sweeps(**kw):
    wl = kw.pop("workload", None)
    a = serving_sweep_analytic(ServingGrid(
        **kw, **({} if wl is None else {"workload": Workload(**wl)})))
    b = jsteady.serving_sweep_analytic(jsteady.ServingGrid(
        **kw, **({} if wl is None else
                 {"workload": jworkload.Workload(**wl)})))
    return a, b


@pytest.mark.parametrize("case", ["all_archs", "overloaded"])
def test_serving_sweep_analytic_equals_reference(case):
    if case == "all_archs":
        a, b = _sweeps(replicas=(1, 2, 4), ram_gb=(1.0, 2.0, 4.0),
                       rate_rps=(0.25, 1.0, 4.0))
    else:
        a, b = _sweeps(archs=("spirt", "gpu"), replicas=(1,), ram_gb=(2.0,),
                       rate_rps=(0.1, 50.0),
                       workload=dict(n_requests=10, rate_rps=1.0,
                                     prompt_tokens=256, decode_tokens=64))
        assert not a.stable.all() and a.stable.any()
    assert len(a) == len(b) and a.requests_simulated == b.requests_simulated
    for f in dataclasses.fields(a):
        if f.name == "grid":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_serving_grid_rejects_what_the_reference_rejects():
    for kw in (dict(batch_size=0), dict(n_requests=0), dict(replicas=()),
               dict(rate_rps=(1.0, -1.0))):
        with pytest.raises(ValueError):
            jsteady.ServingGrid(**kw)
        with pytest.raises(ValueError):
            ServingGrid(**kw)


# ---------------------------------------------------------------------------
# costmodel.flops on every reference config
# ---------------------------------------------------------------------------
def _cfg_pair(arch, reduced):
    jcfg = jget_config(arch)
    if reduced:
        jcfg = jcfg.reduced()
    return ModelConfig(**dataclasses.asdict(jcfg)), jcfg


LM_ARCHS = [a for a in all_arch_names()
            if not a.endswith("-cifar")]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_flops_equal_reference(arch, reduced):
    """Parameter counts, forward / train / 6ND FLOPs and HBM bytes for
    every reference LM config (MoE, RG-LRU and encoder-decoder ones too),
    the port's config built from the reference's fields."""
    cfg, jcfg = _cfg_pair(arch, reduced)
    assert flops.param_count(cfg) == jflops.param_count(jcfg)
    assert flops.active_param_count(cfg) == jflops.active_param_count(jcfg)
    for B, S in ((1, 1), (4, 4096), (16, 32768), (1, 524288)):
        for kind in ("train", "prefill", "decode"):
            assert flops.forward_flops(cfg, B, S, kind) == \
                jflops.forward_flops(jcfg, B, S, kind)
            assert flops.step_bytes_hbm(cfg, B, S, kind) == \
                jflops.step_bytes_hbm(jcfg, B, S, kind)
        for remat in (True, False):
            assert flops.train_step_flops(cfg, B, S, remat) == \
                jflops.train_step_flops(jcfg, B, S, remat)
        assert flops.model_flops_6nd(cfg, B, S) == \
            jflops.model_flops_6nd(jcfg, B, S)


def test_costmodel_exports_flops_beside_pricing():
    assert costmodel.flops is flops
    assert hasattr(costmodel, "pricing")


def test_smollm_full_width_counts():
    """The analytic count is the module's 162,826,560 parameters less its
    61 RMSNorm vectors of 576 (two a layer and the final norm), which
    ``param_count`` leaves out; the decode step at decode_32k's context,
    batch 16, moves 12.40 GB (the bf16 KV cache's 23,040 B a token a
    sequence, and the weights once)."""
    cfg = get_config("smollm-135m")
    model_params = sum(p.numel() for p in transformer.reference_leaves(
        transformer.Model(cfg)))
    assert model_params == 162_826_560
    assert flops.param_count(cfg) == 162_791_424 == \
        model_params - (2 * cfg.n_layers + 1) * cfg.d_model
    per_token = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    assert per_token == 23_040
    assert flops.step_bytes_hbm(cfg, 16, 32768, "decode") == \
        2 * 162_791_424 + 16 * 32768 * per_token == 12_405_178_368
