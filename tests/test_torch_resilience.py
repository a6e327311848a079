"""The port's resilience harness against the reference's, on the CPU.

The reference's ``ResilientTrainer`` runs once in a child process on 4
forced host devices (``fsdp=False``; at its default ``fsdp=True`` its
restore fails here, ROADMAP §3, and its baseline and takeover are held
against the port's FSDP harness) beside the port's 4 gloo ranks, on the
same scenario: reduced SmolLM,
global batch 12, seq 8, 5 steps, worker 1 killed at step 3, a checkpoint
every 2 steps, seed 0, both starting from the reference's parameters
(``build_model(...).init(PRNGKey(0))`` in this one-device process, saved
as a reference checkpoint the port starts from).  Losses agree to rtol
1e-5 (``test_torch_lm_multirank``'s LM tolerance: fp32 sums in other
orders); byte counts, replayed steps, fleet widths and checkpoint bytes
agree exactly.  ``FaultSchedule`` and ``InMemoryStore`` are numpy and
bytes code and agree exactly."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.resilience import FaultSchedule as JFaultSchedule  # noqa: E402
from repro.resilience import InMemoryStore as JInMemoryStore  # noqa: E402
from repro.serverless.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import _subprocess  # noqa: E402
from repro_torch.launch import resilient_train  # noqa: E402
from repro_torch.models import params_from_reference  # noqa: E402
from repro_torch.resilience import (FaultSchedule, InMemoryStore,  # noqa: E402
                                    ResilienceConfig)
from repro_torch.serverless import recovery  # noqa: E402
from repro_torch.serverless.faults import FaultPlan, WorkerCrash  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RTOL = 1e-5
SCENARIO = dict(steps=5, checkpoint_every=2, seq=8, n_workers=4,
                global_batch=12, seed=0)

_REFERENCE = """
import dataclasses, json, os, shutil, sys
import jax
from repro.resilience import FaultSchedule, ResilienceConfig, ResilientTrainer
from repro.serverless.recovery import CheckpointRestore, PeerTakeover

tmp = sys.argv[1]
kw = dict({scenario}, fsdp=False)
sched = FaultSchedule.single(3, 1)
restore = CheckpointRestore(checkpoint_every=2)


def pack(r):
    return dict(losses=list(r.losses), replay_exact=r.replay_exact,
                recoveries=[dataclasses.asdict(x) for x in r.recoveries],
                n_workers_end=r.n_workers_end, state_bytes=r.state_bytes,
                n_params=r.n_params)


out = {{}}
for d in ("ref_ckpt", "ref_ckpt_shrunk"):
    os.makedirs(os.path.join(tmp, d))
tr = ResilientTrainer(ResilienceConfig(**kw),
                      ckpt_dir=os.path.join(tmp, "ref_ckpt"))
out["baseline"] = pack(tr.run())
shutil.copytree(os.path.join(tmp, "ref_ckpt"),
                os.path.join(tmp, "ref_ckpt_baseline"))
out["restore"] = pack(tr.run(sched, restore))
out["takeover"] = pack(tr.run(sched, PeerTakeover()))
out["treedef"] = str(jax.tree.structure(tr._state))
shrunk = ResilientTrainer(ResilienceConfig(restore_reinvoke=False, **kw),
                          ckpt_dir=os.path.join(tmp, "ref_ckpt_shrunk"))
out["shrunk"] = pack(shrunk.run(sched, restore))
# the reference's default: FSDP over the (4, 1) mesh
os.makedirs(os.path.join(tmp, "ref_ckpt_fsdp"))
tr = ResilientTrainer(ResilienceConfig(**dict(kw, fsdp=True)),
                      ckpt_dir=os.path.join(tmp, "ref_ckpt_fsdp"))
out["fsdp_baseline"] = pack(tr.run())
out["fsdp_takeover"] = pack(tr.run(sched, PeerTakeover()))
try:
    tr.run(sched, restore)
    out["fsdp_restore_error"] = None
except Exception as e:
    out["fsdp_restore_error"] = type(e).__name__
json.dump(out, open(os.path.join(tmp, "reference.json"), "w"))
"""

_PORT = """
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.resilience import (FaultSchedule, ResilienceConfig,
                                    ResilientTrainer)
from repro_torch.serverless.recovery import CheckpointRestore, PeerTakeover

rank, tmp, phase = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{{tmp}}/pg_{{phase}}",
                        rank=rank, world_size=4)
kw = dict({scenario})
sched = FaultSchedule.single(3, 1)
restore = CheckpointRestore(checkpoint_every=2)
params = os.path.join(tmp, "params.msgpack")


def pack(r):
    return dict(dataclasses.asdict(r), replay_exact=r.replay_exact)


def trainer(ckpt, init, **extra):
    return ResilientTrainer(ResilienceConfig(**kw, **extra),
                            os.path.join(tmp, ckpt), device="cpu",
                            init_from=init)


npz = np.load(os.path.join(tmp, "params.npz"))
state_dict = {{k: torch.from_numpy(npz[k]) for k in npz.files}}


out = {{}}
if phase == "main":
    tr = trainer("port_ckpt", params)
    out["baseline"] = pack(tr.run())
    out["restore"] = pack(tr.run(sched, restore))
    out["takeover"] = pack(tr.run(sched, PeerTakeover()))
    try:
        tr.fault_free_steps(1, start=1)
    except RuntimeError:
        out["fault_free_refused"] = True
    out["fault_free"] = tr.fault_free_steps(2) + tr.fault_free_steps(
        1, start=2)
    # the same parameters as a state dict, not a checkpoint
    shrunk = ResilientTrainer(ResilienceConfig(**kw, restore_reinvoke=False),
                              os.path.join(tmp, "port_ckpt_shrunk"),
                              device="cpu", init_params=state_dict)
    out["shrunk"] = pack(shrunk.run(sched, restore))
    # MLLess keeps a row a rank; rank 0, which writes the files, dies
    ml = trainer("port_ckpt_mlless", params, sim_arch="mlless")
    first = FaultSchedule.single(3, 0)
    out["mlless_baseline"] = pack(ml.run())
    out["mlless_restore"] = pack(ml.run(first, restore))
    out["mlless_takeover"] = pack(ml.run(first, PeerTakeover()))
elif phase == "fsdp":
    tr = trainer("port_ckpt_fsdp", params, fsdp=True)
    out["fsdp_baseline"] = pack(tr.run())
    out["fsdp_local"] = [[int(p.numel()), int(m.numel())] for p, m in zip(
        tr._train_step(tr._all).init_state()["params"],
        tr._train_step(tr._all).init_state()["opt"]["m"])]
    out["fsdp_full"] = [int(np.prod(s)) for s in
                        tr._train_step(tr._all).layout.shapes]
    out["fsdp_mask"] = tr._train_step(tr._all).layout.mask
    out["fsdp_restore"] = pack(tr.run(sched, restore))
    out["fsdp_takeover"] = pack(tr.run(sched, PeerTakeover()))
    shrunk = trainer("port_ckpt_fsdp_shrunk", params, fsdp=True,
                     restore_reinvoke=False)
    out["fsdp_shrunk"] = pack(shrunk.run(sched, restore))
else:
    tr = trainer("port_ckpt_resume", os.path.join(
        tmp, "ref_ckpt_baseline", "step_000002.msgpack"))
    out["resume"] = pack(tr.run())
json.dump(out, open(os.path.join(tmp, f"port_{{phase}}{{rank}}.json"), "w"))
dist.destroy_process_group()
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _port_ranks(tmp, phase):
    code = textwrap.dedent(_PORT.format(scenario=SCENARIO))
    return [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(tmp), phase],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(OMP_NUM_THREADS="1")) for r in range(4)]


def _wait(procs):
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resilience")
    params = jbuild_model(jget_config("smollm-135m").reduced(),
                          remat=False).init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    jckpt.save(str(tmp / "params.msgpack"), params)
    np.savez(tmp / "params.npz", **{k: v.numpy() for k, v in
                                    params_from_reference(params).items()})
    ref = subprocess.Popen(
        [sys.executable, "-c",
         textwrap.dedent(_REFERENCE.format(scenario=SCENARIO)), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"))
    _wait(_port_ranks(tmp, "main") + [ref])
    _wait(_port_ranks(tmp, "resume") + _port_ranks(tmp, "fsdp"))
    ports = [json.loads((tmp / f"port_main{r}.json").read_text())
             for r in range(4)]
    for r in range(4):
        for phase in ("resume", "fsdp"):
            ports[r].update(json.loads(
                (tmp / f"port_{phase}{r}.json").read_text()))
    return {"tmp": tmp, "params": params, "port": ports[0],
            "ranks": ports,
            "ref": json.loads((tmp / "reference.json").read_text())}


def test_every_rank_reports_the_same_result(runs):
    """The killed rank included: the lowest survivor's result is sent to
    every rank once the run ends."""
    for port in runs["ranks"][1:]:
        assert port == runs["ranks"][0]


def test_baseline_matches_the_reference(runs):
    port, ref = runs["port"]["baseline"], runs["ref"]["baseline"]
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=RTOL)
    assert port["n_params"] == ref["n_params"] == 1_377_536
    assert port["state_bytes"] == ref["state_bytes"] == 16_532_556
    assert port["recoveries"] == [] and port["n_workers_end"] == 4


def test_restore_replays_bit_exactly(runs):
    port, ref = runs["port"], runs["ref"]
    res = port["restore"]
    assert res["losses"] == port["baseline"]["losses"]
    assert res["replay_exact"] and len(res["replay_checks"]) == 1
    (rec,) = res["recoveries"]
    (want,) = ref["restore"]["recoveries"]
    assert (rec["replayed_steps"], rec["ckpt_step"], rec["bytes_moved"],
            rec["n_workers_after"], rec["step"], rec["worker"]) == \
        (want["replayed_steps"], want["ckpt_step"], want["bytes_moved"],
         want["n_workers_after"], want["step"], want["worker"]) == \
        (1, 2, 16_532_556, 4, 3, 1)
    assert res["n_workers_end"] == 4
    assert set(rec["split_s"]) == {"read", "decode", "to_device", "replay"}
    assert sum(rec["split_s"].values()) <= rec["wall_s"]


def test_takeover_matches_the_reference(runs):
    """No replay, the dead partition's bytes (a quarter of the blob), 3
    ranks from the kill on, re-splitting the batch of 12 with SPIRT's Ke
    going from gcd(4, 3) = 1 to gcd(4, 4) = 4."""
    port, ref = runs["port"]["takeover"], runs["ref"]["takeover"]
    (rec,) = port["recoveries"]
    (want,) = ref["recoveries"]
    assert (rec["replayed_steps"], rec["n_workers_after"],
            rec["bytes_moved"]) == (want["replayed_steps"],
                                    want["n_workers_after"],
                                    want["bytes_moved"]) == \
        (0, 3, 16_532_556 // 4)
    assert port["n_workers_end"] == 3 and port["state_bytes"] == 16_532_556
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=RTOL)
    assert port["losses"][:3] == runs["port"]["baseline"]["losses"][:3]


def test_shrunk_restore_matches_the_reference(runs):
    port, ref = runs["port"]["shrunk"], runs["ref"]["shrunk"]
    (rec,) = port["recoveries"]
    assert (rec["n_workers_after"], rec["replayed_steps"],
            rec["ckpt_step"]) == (3, 1, 2)
    assert rec["n_workers_after"] == ref["recoveries"][0]["n_workers_after"]
    assert port["losses"][:2] == runs["port"]["baseline"]["losses"][:2]
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=RTOL)
    assert port["n_workers_end"] == 3


def test_fault_free_steps_repeat_the_baseline(runs):
    """``fault_free_steps`` from step 0, then on from step 2, gives the
    baseline's first three losses bit for bit; going on with no earlier
    call is refused."""
    port = runs["port"]
    assert port["fault_free"] == port["baseline"]["losses"][:3]
    assert port["fault_free_refused"]


def test_step0_checkpoint_is_the_reference_file(runs):
    """The same parameters, zero moments and int32 steps: the port's file
    is the reference's, byte for byte, and the state's treedef string is
    ``str(jax.tree.structure(...))`` of the reference's harness state."""
    tmp = runs["tmp"]
    port = (tmp / "port_ckpt" / "step_000000.msgpack").read_bytes()
    assert port == (tmp / "ref_ckpt_baseline"
                    / "step_000000.msgpack").read_bytes()
    assert ckpt.stored_treedef(port) == runs["ref"]["treedef"]
    assert len(runs["ref"]["treedef"]) == 702


def test_the_reference_reads_the_ports_step2_checkpoint(runs):
    """The trained state after two steps, written by the port, restores
    through the reference's ``checkpoint.restore``.  Against the
    reference's own step-2 file: after two AdamW steps the elements do
    not agree one by one (AdamW moves a parameter by about lr whatever
    its gradient's size, so fp32 noise where a gradient is near zero
    moves it differently), so the moments are held in relative L2 norm
    (1e-3; about 1.1e-4 is seen) and the parameters within 2 x lr a step,
    ``test_torch_transformer``'s bound."""
    tmp, params = runs["tmp"], runs["params"]
    zero = np.zeros((), np.int32)
    like = {"opt": {"m": params, "step": zero, "v": params},
            "params": params, "step": zero, "strat": ()}
    port = jckpt.restore(str(tmp / "port_ckpt" / "step_000002.msgpack"),
                         like=like)
    ref = jckpt.restore(str(tmp / "ref_ckpt_baseline" / "step_000002.msgpack"),
                        like=like)
    assert int(port["step"]) == int(port["opt"]["step"]) == 2
    lr = ResilienceConfig().lr
    leaves = [jax.tree.leaves(t) for t in (
        port["opt"]["m"], port["opt"]["v"], port["params"],
        ref["opt"]["m"], ref["opt"]["v"], ref["params"])]
    for m, v, p, jm, jv, jp in zip(*leaves):
        for got, want in ((m, jm), (v, jv)):
            assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)
        assert np.abs(p - jp).max() <= 2 * lr * 2


def test_the_port_resumes_from_the_reference_step2_checkpoint(runs):
    """The reference's step-2 file (parameters, moments, steps) restores
    onto the port's 4 ranks, which train steps 2-4 as the reference's
    baseline did."""
    port = runs["port"]["resume"]
    assert port["first_step"] == 2 and len(port["losses"]) == 3
    np.testing.assert_allclose(port["losses"],
                               runs["ref"]["baseline"]["losses"][2:],
                               rtol=RTOL)


def test_mlless_rows_round_trip_through_the_checkpoint(runs):
    """MLLess keeps a residual per rank: the checkpoint gathers every
    rank's rows into a leading W axis (the reference's layout, treedef
    ``'strat': [*, ...]``), restore gives each rank its own row back
    (bit-exact replay), and takeover drops the dead rank's row.  The
    killed worker is rank 0, which wrote the files until then: rank 1
    writes them after, and sends the result to every rank."""
    port = runs["port"]
    assert port["mlless_restore"]["losses"] == \
        port["mlless_baseline"]["losses"]
    assert port["mlless_restore"]["replay_exact"]
    (rec,) = port["mlless_takeover"]["recoveries"]
    assert (rec["n_workers_after"], rec["replayed_steps"], rec["worker"]) \
        == (3, 0, 0)
    assert port["mlless_takeover"]["losses"][:3] == \
        port["mlless_baseline"]["losses"][:3]
    assert all(map(np.isfinite, port["mlless_takeover"]["losses"]))
    blob = (runs["tmp"] / "port_ckpt_mlless" / "step_000000.msgpack"
            ).read_bytes()
    strat = "[" + ", ".join(["*"] * 12) + "]"
    assert ckpt.stored_treedef(blob) == runs["ref"]["treedef"].replace(
        "'strat': ()", f"'strat': {strat}")
    shapes = [l.shape for l in jax.tree.leaves(runs["params"])]
    got = [tuple(r["shape"]) for r in
           ckpt.codec.unpackb(blob)["leaves"][-12:]]
    assert got == [(4,) + s for s in shapes]
    assert port["mlless_baseline"]["state_bytes"] > \
        port["baseline"]["state_bytes"]


def test_result_line_parses(runs):
    out = {"config": {"arch": "smollm-135m", "sim_arch": "spirt"},
           "kill": {"step": 3, "worker": 1},
           "runs": {k: runs["port"][k] for k in ("restore", "takeover")}}
    out["runs"]["restore"]["bitexact_vs_baseline"] = True
    out["runs"]["takeover"]["final_loss_gap"] = 0.25
    line = resilient_train.result_line(out)
    got = _subprocess.parse_result_line("noise\n" + line + "\n",
                                        numeric_except=("arch", "sim_arch"))
    assert got["bitexact"] == 1.0 and got["restore_replayed"] == 1.0
    assert got["arch"] == "smollm-135m" and got["takeover_loss_gap"] == 0.25
    with pytest.raises(RuntimeError, match="no RESULT line"):
        _subprocess.parse_result_line("nothing")


def test_fsdp_is_refused_naming_m8():
    """FSDP runs (M8) except for an encoder-decoder, whose encoder leaves
    the reference shards and never gathers (its step fails): refused
    before any rank is spawned.  The port's default stays False."""
    assert ResilienceConfig(fsdp=True).fsdp is True
    with pytest.raises(ValueError, match="M8"):
        ResilienceConfig(fsdp=True, arch="whisper-small")
    assert ResilienceConfig().fsdp is False
    with pytest.raises(ValueError, match="M8"):
        resilient_train.main(["--fsdp", "--arch", "whisper-small",
                              "--device", "cpu"])


def test_fsdp_baseline_and_takeover_match_the_reference(runs):
    """The reference's default, FSDP over its (4, 1) ("data", "model")
    mesh: the same losses to 1e-5, the same whole-state blob (16,532,556
    B, the gathered tree) and the dead partition's bytes; the reference's
    restore under FSDP fails (a ``TypeError`` in its replay, ROADMAP
    §3)."""
    port, ref = runs["port"], runs["ref"]
    for label in ("fsdp_baseline", "fsdp_takeover"):
        np.testing.assert_allclose(port[label]["losses"],
                                   ref[label]["losses"], rtol=RTOL)
        assert port[label]["state_bytes"] == ref[label]["state_bytes"] \
            == 16_532_556
    (rec,) = port["fsdp_takeover"]["recoveries"]
    (want,) = ref["fsdp_takeover"]["recoveries"]
    assert (rec["bytes_moved"], rec["n_workers_after"]) == \
        (want["bytes_moved"], want["n_workers_after"]) == \
        (16_532_556 // 4, 3)
    assert ref["fsdp_restore_error"] == "TypeError"


def test_fsdp_holds_shards_and_writes_the_whole_state(runs):
    """On the (4, 1) mesh the model axis of size 1 takes each block
    leaf's widest dim and FSDP the next one that divides by 4: the
    attention and MLP weights, not the norms (whose one width dim the
    model axis took).  Each rank holds a quarter of those leaves and of
    their moments; the step-0 checkpoint is the whole state, byte for
    byte the replicated run's file."""
    port, tmp = runs["port"], runs["tmp"]
    mask = port["fsdp_mask"]
    assert sum(mask) == 7 and len(mask) == 12
    for sharded, (p, m), n in zip(mask, port["fsdp_local"],
                                  port["fsdp_full"]):
        assert p == m == (n // 4 if sharded else n)
    assert (tmp / "port_ckpt_fsdp" / "step_000000.msgpack").read_bytes() \
        == (tmp / "port_ckpt" / "step_000000.msgpack").read_bytes()


def test_fsdp_restore_against_the_ports_own_replicated_run(runs):
    """Where the reference fails, the port's FSDP restore replays bit for
    bit against its own FSDP baseline, and its losses equal the
    replicated harness's restore to 1e-5; the shrunk restore re-derives
    the specs on the 3 survivors (nothing divides by 3: replicated)."""
    port = runs["port"]
    res = port["fsdp_restore"]
    assert res["losses"] == port["fsdp_baseline"]["losses"]
    assert res["replay_exact"]
    np.testing.assert_allclose(res["losses"], port["restore"]["losses"],
                               rtol=RTOL)
    (rec,) = res["recoveries"]
    assert (rec["replayed_steps"], rec["ckpt_step"], rec["bytes_moved"]) \
        == (1, 2, 16_532_556)
    np.testing.assert_allclose(port["fsdp_shrunk"]["losses"],
                               port["shrunk"]["losses"], rtol=RTOL)
    assert port["fsdp_shrunk"]["n_workers_end"] == 3


@pytest.mark.parametrize("kw,match", [
    (dict(n_workers=1), "n_workers"), (dict(steps=0), "steps"),
    (dict(push_every=0), "push_every"), (dict(global_batch=10), "divide"),
    (dict(global_batch=8), "survivors"), (dict(seq=1), "seq")])
def test_config_validates_as_the_reference(kw, match):
    from repro.resilience import ResilienceConfig as JResilienceConfig
    with pytest.raises(ValueError, match=match):
        ResilienceConfig(**kw)
    with pytest.raises(ValueError, match=match):
        JResilienceConfig(**kw)


def test_policies_drive_the_trainers_recovery():
    class Trainer:
        def recover_restore(self, w):
            return ("restore", w)

        def recover_takeover(self, w):
            return ("takeover", w)
    assert recovery.CheckpointRestore().real_apply(Trainer(), 2) == \
        ("restore", 2)
    assert recovery.PeerTakeover().real_apply(Trainer(), 1) == \
        ("takeover", 1)
    with pytest.raises(NotImplementedError, match="no real-training"):
        recovery.RecoveryPolicy().real_apply(Trainer(), 0)


# ---------------------------------------------------------------------------
# FaultSchedule and InMemoryStore: exact against the reference
# ---------------------------------------------------------------------------
def test_schedule_matches_the_reference():
    kills = ((7, 2), (3, 0))
    assert FaultSchedule(kills=kills).kills == \
        JFaultSchedule(kills=kills).kills == ((3, 0), (7, 2))
    s = FaultSchedule.single(4, worker=1)
    assert s.kills == JFaultSchedule.single(4, worker=1).kills
    assert [s.kill_at(i) for i in range(6)] == \
        [JFaultSchedule.single(4, 1).kill_at(i) for i in range(6)]
    for bad, match in ((((0, 1),), "step must be >= 1"),
                       (((2, -1),), "worker must be >= 0"),
                       (((2, 0), (2, 1)), "one kill per step")):
        with pytest.raises(ValueError, match=match):
            FaultSchedule(kills=bad)
        with pytest.raises(ValueError, match=match):
            JFaultSchedule(kills=bad)


@pytest.mark.parametrize("seed", range(12))
def test_schedule_from_seeded_random_plans_matches_the_reference(seed):
    rs = np.random.RandomState(seed)
    kw = dict(seed=seed, n_workers=int(rs.randint(2, 9)),
              horizon_s=float(rs.uniform(10, 200)),
              crash_rate=float(rs.uniform(0.2, 1.5)))
    steps = int(rs.randint(2, 40))
    horizon = float(rs.uniform(5, 250))
    port = FaultSchedule.from_fault_plan(
        FaultPlan.random(**kw), total_steps=steps, horizon_s=horizon)
    ref = JFaultSchedule.from_fault_plan(
        JFaultPlan.random(**kw), total_steps=steps, horizon_s=horizon)
    assert port.kills == ref.kills


def test_schedule_from_plan_clamps_and_validates():
    plan = FaultPlan(crashes=(WorkerCrash(0, 0.0), WorkerCrash(1, 50.0),
                              WorkerCrash(2, 999.0), WorkerCrash(3, 51.0)))
    s = FaultSchedule.from_fault_plan(plan, total_steps=10, horizon_s=100.0)
    assert s.kills == ((1, 0), (5, 1), (9, 2))
    with pytest.raises(ValueError, match="total_steps"):
        FaultSchedule.from_fault_plan(FaultPlan(), total_steps=1,
                                      horizon_s=10.0)
    with pytest.raises(ValueError, match="horizon_s"):
        FaultSchedule.from_fault_plan(FaultPlan(), total_steps=4,
                                      horizon_s=0.0)


@pytest.mark.parametrize("n,W", [(0, 1), (1029, 4), (1024, 4), (7, 3),
                                 (16_532_556, 4)])
def test_store_matches_the_reference(n, W):
    blob = bytes(np.random.RandomState(n % 97).randint(
        0, 256, n, dtype=np.uint8))
    port, ref = InMemoryStore(), JInMemoryStore()
    for st in (port, ref):
        st.push_partitions(blob, W)
        st.put("extra", b"xyz")
    assert port.keys() == ref.keys()
    for w in range(W):
        assert port.fetch_state(W, dead=w) == ref.fetch_state(W, dead=w)
    for attr in ("bytes_written", "bytes_read", "puts", "gets"):
        assert getattr(port, attr) == getattr(ref, attr)
    with pytest.raises(ValueError, match="out of range"):
        port.fetch_state(W, dead=W)
    with pytest.raises(ValueError, match="n_workers"):
        port.push_partitions(blob, 0)
    with pytest.raises(KeyError, match="no key 'b'"):
        port.get("b")
    port.reset()
    assert port.keys() == [] and port.bytes_written == port.gets == 0


def test_state_bridge_round_trips_a_rank_state():
    """``to_reference`` / ``from_reference`` on one process: params,
    moments, steps and an MLLess residual come back as they were."""
    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.core.strategies import MLLess
    from repro_torch.models import build_model, reference_leaves
    from repro_torch.resilience import state as bridge
    model = build_model(get_config("smollm-135m").reduced(), device="cpu")
    params = reference_leaves(model)
    st = {"params": params, "opt": optim.adamw(1e-3).init(params),
          "strat": MLLess().init_state(params), "step": 4}
    st["opt"]["step"] = 4
    gen = torch.Generator().manual_seed(0)
    for t in st["opt"]["m"] + list(st["strat"]):
        t.copy_(torch.randn(t.shape, generator=gen))
    tree = bridge.to_reference(st, model)
    blob = ckpt.dumps(tree)
    host = ckpt.loads(blob, like=bridge.template(st, model, 1))
    before = [t.clone() for t in st["opt"]["m"] + list(st["strat"])]
    fresh = {"params": params, "opt": optim.adamw(1e-3).init(params),
             "strat": (), "step": 0}
    with pytest.raises(ValueError, match="treedef"):
        ckpt.loads(blob, like=bridge.template(fresh, model, 1))
    fresh["strat"] = MLLess().init_state(params)
    bridge.from_reference(host, fresh, row=0)
    assert fresh["step"] == fresh["opt"]["step"] == 4
    for a, b in zip(before, fresh["opt"]["m"] + list(fresh["strat"])):
        assert torch.equal(a, b)
    assert ckpt.dumps(bridge.to_reference(fresh, model)) == blob
