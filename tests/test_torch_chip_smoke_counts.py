"""``chip_smoke.py``'s expected launch and call counts, held to counts
written out by hand at SmolLM-135M's 30 layers and at the 10 of its
multi-rank paths, and the depth each path builds: the resilience
harness's trainers, the sharding and tp phases' train runs, their
dry-runs and their serving (tp's (1, 6) serving on the ring's slots
too) at ``MULTI_RANK_LAYERS``; the lm and serve phases at SmolLM's full
depth.

``chip_smoke.py`` imports only the standard library at module level, so
it loads here with no card; where a path would build a model or start a
process group, the test puts a recorder in its place and stops there."""
import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401,E402  (pins torch's CPU threads)
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load()
FULL = get_config("smollm-135m")


@pytest.fixture(autouse=True)
def registry(monkeypatch):
    """The cut config registers under a name of its own; other tests in
    this process hold the registry to the reference's names, so each test
    here registers into a copy."""
    base.all_arch_names()
    monkeypatch.setattr(base, "_REGISTRY", dict(base._REGISTRY))


class Stop(Exception):
    """Raised by a recorder where the path would go on to the card."""


def assert_full_width(cfg):
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.vocab_size, cfg.d_ff) == (576, 9, 3, 64, 49152, 1536)


def assert_cut(cfg):
    assert cfg.n_layers == cs.MULTI_RANK_LAYERS == 10
    assert_full_width(cfg)


def test_smollm_depths():
    assert FULL.n_layers == 30
    assert_full_width(FULL)
    cut = cs.multi_rank_config()
    assert_cut(cut)
    assert get_config(cut.name) == cut


@pytest.mark.parametrize("layers,params", [(30, 162_826_560),
                                           (10, 92_024_640)])
def test_leaves_do_not_grow_with_depth(layers, params):
    """Fused AdamW launches once a leaf: 12 at any depth, each block leaf
    stacked over the layers."""
    from repro_torch.models import transformer
    cfg = FULL if layers == 30 else cs.multi_rank_config()
    assert cfg.n_layers == layers
    model = transformer.Model(cfg, device="meta")
    leaves = transformer.reference_leaves(model)
    assert len(leaves) == 12
    assert sum(p.numel() for p in leaves) == params


# (layers, steps, microbatches, mlless): fused AdamW, attention, each of
# MLLess's segmented pair
LM_CASES = [
    ((30, 30, 1, False), (360, 1800, 0)),     # the lm phase's 30 steps
    ((30, 3, 4, False), (36, 720, 0)),        # SPIRT, 4 microbatches
    ((30, 3, 1, True), (36, 180, 3)),         # MLLess
    ((30, 5, 1, False), (60, 300, 0)),        # seq 2048
    ((10, 3, 1, False), (36, 60, 0)),         # sharding / tp allreduce
    ((10, 3, 1, True), (36, 60, 3)),          # sharding / tp MLLess
]


@pytest.mark.parametrize("args,want", LM_CASES,
                         ids=[str(a) for a, _ in LM_CASES])
def test_expected_lm_launches(args, want):
    adamw, attn, seg = want
    assert cs.expected_lm_launches(*args) == {
        "fused_adamw_flat": adamw, "swa_attention_fwd": attn,
        "swa_attention_fwd_wgmma": attn, "swa_attention_fwd_tf32": 0,
        "wkv6_chunked": 0, "wkv6_chunked_tc": 0, "segment_norms": seg,
        "segment_filter": seg, "block_norms": 0, "masked_filter": 0}


@pytest.mark.parametrize("strategy,layers,attn,seg", [
    ("allreduce", 10, 60, 0), ("mlless", 10, 60, 3),
    ("allreduce", 30, 180, 0), ("mlless", 30, 180, 3)])
def test_shard_expected(strategy, layers, attn, seg):
    got = cs.shard_expected(strategy, layers)
    assert (got["fused_adamw_flat"], got["swa_attention_fwd"],
            got["segment_filter"]) == (36, attn, seg)


# each run's attention launches a rank (worker 1 is killed at step 3;
# a step at W 4 is one microbatch, at W 3 four) and fused AdamW's
RES_CASES = {
    30: {"baseline": (150, 60), "restore/0": (180, 72),
         "restore/1": (180, 72), "takeover": (330, 60),
         "takeover/killed": (90, 36), "shrunk": (450, 72),
         "shrunk/killed": (90, 36), "baseline/lr0.01": (60, 24)},
    10: {"baseline": (50, 60), "restore/0": (60, 72),
         "restore/1": (60, 72), "takeover": (110, 60),
         "takeover/killed": (30, 36), "shrunk": (150, 72),
         "shrunk/killed": (30, 36), "baseline/lr0.01": (20, 24)},
}
RES_LABELS = ("baseline", "restore/0", "restore/1", "takeover", "shrunk",
              "baseline/lr0.01")


@pytest.mark.parametrize("layers", [30, 10])
@pytest.mark.parametrize("label", RES_LABELS)
@pytest.mark.parametrize("rank", range(4))
def test_res_expected(layers, label, rank):
    assert f"baseline/lr{cs.RES_REF_LR}" == "baseline/lr0.01"
    killed = rank == cs.RES_KILL[1] and label in ("takeover", "shrunk")
    attn, adamw = RES_CASES[layers][label + ("/killed" if killed else "")]
    got = cs.res_expected(label, rank, layers)
    assert (got["swa_attention_fwd"], got["swa_attention_fwd_wgmma"],
            got["fused_adamw_flat"]) == (attn, attn, adamw)
    assert sum(got.values()) == 2 * attn + adamw


@pytest.mark.parametrize("layers,calls", [(30, 243), (10, 83)])
def test_tp_slots_calls(layers, calls):
    assert cs.tp_slots_calls(layers) == calls


def test_resilience_builds_every_trainer_cut(monkeypatch, tmp_path):
    """Every ``ResilientTrainer`` a rank builds (the fleet's, the shrunk
    restore's, the lr record's) is of the cut config."""
    from repro_torch import resilience
    from repro_torch.resilience.harness import RunResult
    built = []

    class Trainer:
        def __init__(self, config, ckpt_dir, **kw):
            built.append(get_config(config.arch))

        def warm(self, *args):
            pass

        def run(self, schedule=None, policy=None):
            return RunResult(arch="", sim_arch="", losses=(1.0,),
                             recoveries=[], n_params=0, state_bytes=0,
                             step_s=0.0, n_workers_end=4)

    monkeypatch.setattr(resilience, "ResilientTrainer", Trainer)
    monkeypatch.setattr(cs, "start_rank",
                        lambda *a: (torch.device("cpu"), {}))
    for name in ("reset_peak_memory_stats", "synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(dist, "barrier", lambda *a: None)
    monkeypatch.setattr(dist, "destroy_process_group", lambda *a: None)
    cs.res_rank(1, "init", str(tmp_path), str(tmp_path), 0.0)
    assert len(built) == 3
    for cfg in built:
        assert_cut(cfg)
    rec = json.loads((tmp_path / "rank1.json").read_text())
    assert set(rec["trainers"]) == {"fleet", "shrunk", "lr0.01"}


@pytest.mark.parametrize("path,args", [
    ("shard_train", ("allreduce", False, [])),
    ("tp_train", ("allreduce", False, [])),
    ("shard_serve", ("float32", 16, 2048, 512)),
    ("tp_serve", ("float32", (1, 6), 2, 3072, 2048, 8))])
def test_multi_rank_paths_build_the_cut_model(monkeypatch, path, args):
    import repro_torch.models as models
    built = []

    def build_model(cfg, **kw):
        built.append(cfg)
        raise Stop
    monkeypatch.setattr(models, "build_model", build_model)
    with pytest.raises(Stop):
        getattr(cs, path)("cpu", *args)
    assert_cut(built[0])


def test_dryruns_hold_the_cut_runs(monkeypatch):
    """The dry-runs the train runs are held against are of the cut config;
    the production dry-runs of train_4k and long_500k keep full depth."""
    from repro_torch.launch import dryrun
    calls = []

    def dryrun_one(arch, shape_name, *, config=None, **kw):
        calls.append((shape_name, config))
        return {}
    monkeypatch.setattr(dryrun, "dryrun_one", dryrun_one)
    monkeypatch.setattr(cs, "tp_family_dryruns", lambda: {})
    cs.shard_dryruns()
    cs.tp_dryruns()
    phase = [c for s, c in calls if s in ("sharding_phase", "tp_phase")]
    assert len(phase) == len(cs.SHARD_RUNS) + len(cs.TP_RUNS)
    for cfg in phase:
        assert_cut(cfg)
    assert [(s, c) for s, c in calls if s not in ("sharding_phase",
                                                  "tp_phase")] == [
        ("train_4k", None), ("long_500k", None)]


def test_slots_serve_the_cut_model(monkeypatch, tmp_path):
    served = []

    def tp_serve(dev, dtype, mesh, B, cache, prompt, n):
        served.append((dtype, mesh, B, cache, prompt, n))
        return {}
    monkeypatch.setattr(cs, "tp_serve", tp_serve)
    monkeypatch.setattr(cs, "free_device_memory", lambda: None)
    monkeypatch.setattr(cs, "start_rank",
                        lambda *a: (torch.device("cpu"), {}))
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(dist, "barrier", lambda *a: None)
    monkeypatch.setattr(dist, "destroy_process_group", lambda *a: None)
    cs.tp_slots_rank(0, "init", str(tmp_path), 0.0)
    assert served == [("float32", (1, 6), 2, 3072, 2048, 8),
                      ("bfloat16", (1, 6), 2, 3072, 2048, 8)]


def test_lm_phase_trains_full_depth(monkeypatch):
    import repro_torch.launch.train as train_mod
    archs = []

    def train(*, arch, **kw):
        archs.append(arch)
        raise Stop
    monkeypatch.setattr(train_mod, "train", train)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: None)
    monkeypatch.setattr(dist, "destroy_process_group", lambda *a: None)
    with pytest.raises(Stop):
        cs.lm_train_phase("init")
    assert get_config(archs[0]) == FULL


def test_serve_phase_serves_full_depth(monkeypatch):
    seen = []

    def serve_model(cfg, prompt, cache_len, n_tokens, label, expect, **kw):
        seen.append((cfg, expect))
        raise Stop
    monkeypatch.setattr(cs, "serve_tokens", lambda *a: None)
    monkeypatch.setattr(cs, "serve_model", serve_model)
    with pytest.raises(Stop):
        cs.serve_phase()
    cfg, expect = seen[0]
    assert cfg == FULL
    assert expect == {"swa_attention_fwd": 30,
                      "swa_attention_fwd_wgmma": 30,
                      "swa_attention_fwd_tf32": 0}
