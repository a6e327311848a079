"""Tensor-parallel training on 4 gloo ranks, a (2, 2) ("data", "model")
mesh, against the reference's train step with ``model_axis="model"`` on
a 4-device mesh with Auto axes, each in its own process (the reference
needs its host-device count before it imports jax): reduced SmolLM (2
layers, d 256, 4 / 1 heads, fp32), global batch 8 x 64, AdamW lr 3e-3, 2
steps from the reference's parameters.

Cases: allreduce, MLLess and SPIRT at ``fsdp=False``, allreduce at
``fsdp=True``, and a config whose 3 heads do not divide the model axis
(the replicated-attention path, wo sharded on its output dim).  Losses
agree to 1e-5.  MLLess sees whole leaves at the data width W = 2 (the
reference's strategy runs inside a ``shard_map`` whose model axis stays
auto): its first step's significant fraction agrees to one fp32 step and
its count of blocks exactly; its later losses are not held tightly
(blocks near the cut flip under rounding).  Each rank holds exactly
``params_from_reference(tree, mesh, rank)``'s slices, and so do both
AdamW moments.  The ``baseline`` dry-run's argument bytes a rank equal
the reference's ``memory_analysis()`` of the same step; the reference's
HLO collective counts are printed beside the port's and not held (XLA
chooses its own schedule)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models.transformer import build_model as jbuild_model  # noqa: E402
from repro_torch.models.transformer import params_from_reference  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
D, M, STEPS, BATCH, SEQ, LR = 2, 2, 2, 8, 64, 3e-3
# (config, strategy, fsdp); "heads3": 3 query and kv heads, d 256
CASES = [("smollm", "allreduce", False), ("smollm", "mlless", False),
         ("smollm", "spirt", False), ("smollm", "allreduce", True),
         ("heads3", "allreduce", False)]
IDS = ["allreduce", "mlless", "spirt", "allreduce-fsdp", "heads3"]
CONFIGS = sorted({c for c, _, _ in CASES})
REF_PARTS = 3

_CFG = """
import dataclasses


def cfg_of(name):
    cfg = get_config("smollm-135m").reduced()
    if name == "heads3":
        cfg = dataclasses.replace(cfg, n_heads=3, n_kv_heads=3)
    return cfg
"""

_PORT = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import optim
from repro_torch.configs.base import get_config
from repro_torch.core import build_train_step, get_strategy
from repro_torch.costmodel.collectives import record_collectives, stats
from repro_torch.data import lm_batches, token_stream
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import Model, params_from_reference
{cfg}
rank, inp, out, init = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size={D} * {M})
d = np.load(inp, allow_pickle=True)
mesh = make_mesh(({D}, {M}), ("data", "model"))
di = mesh.coords(rank)["data"]
B = {batch} // {D}
res = {{}}
for c, (name, strat, fsdp) in enumerate({cases}):
    tree = d["tree/" + name].item()
    model = Model(cfg_of(name))
    model.load_state_dict(params_from_reference(tree))
    ts = build_train_step(model, optim.adamw({lr}), get_strategy(strat),
                          mesh, data_axes=("data",), model_axis="model",
                          fsdp=fsdp)
    state = ts.init_state()
    mine = params_from_reference(tree, mesh, rank, fsdp=fsdp)
    res[f"{{c}}/slices_equal"] = np.asarray(all(
        torch.equal(p, mine[n]) for n, p in model.named_parameters()))
    res[f"{{c}}/moments_like_params"] = np.asarray(all(
        p.shape == m.shape == v.shape for p, m, v in zip(
            state["params"], state["opt"]["m"], state["opt"]["v"])))
    res[f"{{c}}/local_elements"] = np.asarray(
        sum(p.numel() for p in state["params"]))
    it = lm_batches(token_stream({batch} * {seq} * 64, cfg_of(name)
                                 .vocab_size), {batch}, {seq})
    losses, fracs = [], []
    for s in range({steps}):
        b = {{k: torch.from_numpy(v[di * B:(di + 1) * B])
              for k, v in next(it).items()}}
        with record_collectives() as rec:
            state, m = ts.step_fn(state, b)
        losses.append(float(m["loss"]))
        if "significant_fraction" in m:
            fracs.append(float(m["significant_fraction"]))
            res[f"{{c}}/n_rows"] = np.asarray(state["strat"].layout.n_rows)
        if s == 0:
            st = stats(rec)
            res[f"{{c}}/coll"] = np.asarray(
                [[st.counts[k], st.bytes_by_kind[k]] for k in
                 ("all-reduce", "all-gather", "reduce-scatter")])
    res[f"{{c}}/losses"] = np.asarray(losses)
    res[f"{{c}}/fracs"] = np.asarray(fracs)
np.savez(out, **res)
dist.barrier()
dist.destroy_process_group()
"""

_REFERENCE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro import optim
from repro.configs.base import get_config
from repro.core import build_train_step, get_strategy
from repro.costmodel.hlo_analysis import analyze_collectives
from repro.data import lm_batches, token_stream
from repro.models.transformer import build_model
{cfg}
out, part = sys.argv[1], int(sys.argv[2])
mesh = jax.make_mesh(({D}, {M}), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
res = {{}}
for c, (name, strat, fsdp) in enumerate({cases}):
    if c % {parts} != part:
        continue
    cfg = cfg_of(name)
    model = build_model(cfg)
    ts = build_train_step(model, optim.adamw({lr}), get_strategy(strat),
                          mesh, data_axes=("data",), model_axis="model",
                          fsdp=fsdp)
    state = ts.init_state(jax.random.PRNGKey(0))
    it = lm_batches(token_stream({batch} * {seq} * 64, cfg.vocab_size),
                    {batch}, {seq})
    losses, fracs = [], []
    step = ts.step_fn
    for s in range({steps}):
        b = jax.tree.map(jnp.asarray, next(it))
        if s == 0 and c == 0:
            step = ts.step_fn.lower(state, b).compile()
            res["argument_bytes"] = np.asarray(
                step.memory_analysis().argument_size_in_bytes)
            coll = analyze_collectives(step.as_text())
            res["hlo_counts"] = np.asarray(
                [coll.counts[k] for k in ("all-reduce", "all-gather",
                                          "reduce-scatter")])
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if "significant_fraction" in m:
            fracs.append(float(m["significant_fraction"]))
    res[f"{{c}}/losses"] = np.asarray(losses)
    res[f"{{c}}/fracs"] = np.asarray(fracs)
np.savez(out, **res)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _jcfg(name):
    cfg = jget_config("smollm-135m").reduced()
    if name == "heads3":
        import dataclasses
        cfg = dataclasses.replace(cfg, n_heads=3, n_kv_heads=3)
    return cfg


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    inp = str(tmp / "params.npz")
    saved = {}
    for name in CONFIGS:
        tree = jax.tree.map(np.asarray, jbuild_model(_jcfg(name)).init(
            jax.random.PRNGKey(0)))
        saved["tree/" + name] = np.asarray(tree, dtype=object)
    np.savez(inp, **saved)
    fmt = dict(D=D, M=M, steps=STEPS, batch=BATCH, seq=SEQ, lr=LR,
               cases=repr(CASES), cfg=_CFG, parts=REF_PARTS)
    # the reference's cases in REF_PARTS processes (its compiles set the
    # pace)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE.format(**fmt)),
         str(tmp / f"reference{i}.npz"), str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={D * M}",
                 JAX_PLATFORMS="cpu")) for i in range(REF_PARTS)]
    for r in range(D * M):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_PORT.format(**fmt)),
             str(r), inp, str(tmp / f"port{r}.npz"), f"file://{tmp}/pg"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(OMP_NUM_THREADS="1")))
    for p in procs:
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-3000:]
    ref = {}
    for i in range(REF_PARTS):
        ref.update(np.load(tmp / f"reference{i}.npz"))
    return ref, [np.load(tmp / f"port{r}.npz") for r in range(D * M)]


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_tp_losses_match_the_reference(results, case):
    ref, ports = results
    for p in ports:
        np.testing.assert_array_equal(p[f"{case}/losses"],
                                      ports[0][f"{case}/losses"])
    if CASES[case][1] == "mlless":
        # only the first step: later steps filter blocks near the cut
        # that rounding flips
        np.testing.assert_allclose(ports[0][f"{case}/losses"][:1],
                                   ref[f"{case}/losses"][:1], rtol=1e-5)
        return
    np.testing.assert_allclose(ports[0][f"{case}/losses"],
                               ref[f"{case}/losses"], rtol=1e-5)


def test_tp_mlless_sees_whole_leaves_at_the_data_width(results):
    """The first step's significant fraction (the mean over the W = 2 data
    ranks of each one's kept share of the whole leaves' blocks) equals the
    reference's to one fp32 step, and the count of kept blocks over the
    data ranks exactly."""
    ref, ports = results
    c = IDS.index("mlless")
    want = np.float32(ref[f"{c}/fracs"][0])
    for p in ports:
        got = np.float32(p[f"{c}/fracs"][0])
        assert abs(got - want) <= np.spacing(want)
        n = int(p[f"{c}/n_rows"]) * D
        assert abs(float(got) * n - round(float(got) * n)) < 1e-2
        assert round(float(got) * n) == round(float(want) * n)
    assert 0.5 < want < 1.0


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_tp_ranks_hold_the_reference_slices(results, case):
    """Each rank's parameters are ``params_from_reference(tree, mesh,
    rank, fsdp=...)``'s slices, both moments shaped alike; the model axis
    halves the model-sharded leaves (and FSDP the block leaves again)."""
    _, ports = results
    for p in ports:
        assert bool(p[f"{case}/slices_equal"])
        assert bool(p[f"{case}/moments_like_params"])
    n = {c: int(ports[0][f"{c}/local_elements"]) for c in range(len(CASES))}
    whole = 1_377_536          # reduced SmolLM's parameters
    if IDS[case] in ("allreduce", "mlless", "spirt"):
        # every leaf halves over the model axis (the norms too)
        assert n[case] == whole // 2
    if IDS[case] == "allreduce-fsdp":
        assert n[case] < whole // 2


def test_baseline_dryrun_argument_bytes_equal_the_reference(results):
    """The ``baseline`` dry-run of the same step on the (2, 2) mesh (a
    fake process group, meta tensors): the state and batch slices a rank
    holds, byte for byte the reference's ``memory_analysis()``; its
    collectives, which the real step records, kind for kind."""
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    ref, ports = results
    res = dryrun.dryrun_one(
        "smollm-135m", "small", profile="baseline", save=False,
        mesh=make_mesh((D, M), ("data", "model")),
        config=get_config("smollm-135m").reduced(),
        input_shape=InputShape("small", SEQ, BATCH, "train"))
    assert res["memory"]["argument_bytes"] == int(ref["argument_bytes"])
    assert res["fsdp"] is False and res["chips"] == D * M
    got = res["collectives"]
    port = ports[0]["0/coll"]
    for i, kind in enumerate(("all-reduce", "all-gather", "reduce-scatter")):
        assert got["counts"][kind] == port[i][0]
        assert got["bytes_by_kind"][kind] == port[i][1]
    print("collective counts a step (all-reduce, all-gather, "
          f"reduce-scatter): port {port[:, 0].tolist()}, the reference's "
          f"HLO {ref['hlo_counts'].tolist()}")


def test_train_entry_point_runs_tp_on_four_ranks(tmp_path):
    """``launch.train --mesh 2x2`` trains reduced SmolLM on 4 CPU ranks
    and saves the whole parameter tree, which the reference's
    ``checkpoint.restore`` reads at the reference's shapes."""
    from repro import checkpoint as jckpt
    path = tmp_path / "params.msgpack"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-135m", "--reduced", "--device", "cpu", "--world-size", "4",
         "--mesh", "2x2", "--steps", "2", "--batch", "8", "--seq", "32",
         "--checkpoint", str(path)],
        capture_output=True, text=True, timeout=300,
        env=_env(OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "'model': 2" in out.stdout and "step    1" in out.stdout
    like = jax.tree.map(np.asarray, jbuild_model(
        jget_config("smollm-135m").reduced()).init(jax.random.PRNGKey(0)))
    tree = jckpt.restore(str(path), like=like)
    assert [np.shape(x) for x in jax.tree.leaves(tree)] == \
        [x.shape for x in jax.tree.leaves(like)]
