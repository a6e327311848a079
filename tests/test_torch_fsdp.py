"""FSDP (ZeRO-3) training on 4 gloo ranks against the reference's train
step at ``fsdp=True`` on a 4-device ``("data",)`` mesh, each in its own
process (the reference needs its host-device count before it imports
jax): reduced SmolLM (2 layers, d 256, fp32), global batch 8 x 64, AdamW
lr 3e-3, allreduce, mlless and spirt, 2 steps from the reference's
parameters.

The collective bytes are the reference's compiled numbers
(``analyze_collectives`` of the compiled step; 2 all-gathers per FSDP
leaf per block, the backward's re-gather included, 1 reduce-scatter per
leaf per block, both doubled by SPIRT's 2 microbatches); the port's
``record_collectives`` must give the same bytes kind for kind and the
same number of all-gathers and reduce-scatters.  XLA merges the
all-reduces into one op, so their count is the port's own."""
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
W, STEPS, BATCH, SEQ, LR = 4, 2, 8, 64, 3e-3
STRATEGIES = ("allreduce", "mlless", "spirt")

# the reference's compiled step at fsdp=True: {kind: (bytes, ops)}
COMPILED = {
    "allreduce": {"all-reduce": (1_049_604, 1),
                  "all-gather": (8_921_088, 36),
                  "reduce-scatter": (1_115_136, 18)},
    "mlless": {"all-reduce": (1_049_608, 1),
               "all-gather": (8_921_088, 36),
               "reduce-scatter": (1_115_136, 18)},
    "spirt": {"all-reduce": (1_049_604, 1),
              "all-gather": (17_842_176, 72),
              "reduce-scatter": (2_230_272, 36)},
}
# the port's all-reduces a step: the strategy's one, the loss's mean and,
# under MLLess, the significant fraction's
PORT_ALL_REDUCES = {"allreduce": 2, "mlless": 3, "spirt": 2}

_PORT = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import optim
from repro_torch.configs.base import get_config
from repro_torch.core import build_train_step, get_strategy
from repro_torch.core.sharding import tree_leaves
from repro_torch.costmodel.collectives import record_collectives, stats
from repro_torch.data import lm_batches, token_stream
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.params import params_to_reference
from repro_torch.models.transformer import build_model, params_from_reference

rank, inp, out, init = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size={W})
d = np.load(inp)
full = {{k: torch.from_numpy(d[k]) for k in d.files}}
cfg = get_config("smollm-135m").reduced()
mesh = make_mesh(({W},), ("data",))
B = {batch} // {W}
res = {{}}


def gathered(leaves, layout):
    # whole copies: a replicated leaf is the live tensor, updated in place
    # by the next step
    return np.asarray([layout.gather(i, t.detach()).numpy().copy()
                       for i, t in enumerate(leaves)], dtype=object)


for strat in {strategies}:
    for fsdp in (True, False):
        if not fsdp and strat != "allreduce":
            continue
        model = build_model(cfg, device="cpu")
        model.load_state_dict(full)
        ts = build_train_step(model, optim.adamw({lr}), get_strategy(strat),
                              mesh, fsdp=fsdp)
        state = ts.init_state()
        tag = f"{{strat}}/{{'fsdp' if fsdp else 'dp'}}"
        if fsdp:
            mine = params_from_reference(dict(np.load(inp + ".tree.npz",
                                                      allow_pickle=True))
                                         ["tree"].item(), mesh, rank)
            res[tag + "/shards_equal"] = np.asarray(all(
                torch.equal(p, mine[n]) for n, p in
                model.named_parameters()))
            res[tag + "/elements"] = np.asarray(
                [[p.numel(), m.numel(), v.numel()] for p, m, v in
                 zip(state["params"], state["opt"]["m"],
                     state["opt"]["v"])])
            res[tag + "/mask"] = np.asarray(ts.layout.mask)
        it = lm_batches(token_stream({batch} * {seq} * 64, cfg.vocab_size),
                        {batch}, {seq})
        losses = []
        for s in range({steps}):
            b = {{k: torch.from_numpy(v[rank * B:(rank + 1) * B])
                  for k, v in next(it).items()}}
            with record_collectives() as rec:
                state, m = ts.step_fn(state, b)
            losses.append(float(m["loss"]))
            if s == 0:
                st = stats(rec)
                for k in ("all-reduce", "all-gather", "reduce-scatter"):
                    res[f"{{tag}}/coll/{{k}}"] = np.asarray(
                        [st.bytes_by_kind[k], st.counts[k]])
                if fsdp:
                    for k in "mv":
                        res[f"{{tag}}/{{k}}1"] = gathered(state["opt"][k],
                                                        ts.layout)
                    res[tag + "/p1"] = gathered(state["params"], ts.layout)
        res[tag + "/losses"] = np.asarray(losses)
        # the whole tree, the shards gathered (collective)
        res[tag + "/p_end"] = np.asarray(tree_leaves(
            params_to_reference(model), lambda x: isinstance(x, np.ndarray)),
            dtype=object)
if rank == 0:
    np.savez(out, **res)
dist.barrier()
dist.destroy_process_group()
"""

_REFERENCE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro import optim
from repro.configs.base import get_config
from repro.core import build_train_step, get_strategy
from repro.costmodel.hlo_analysis import analyze_collectives
from repro.data import lm_batches, token_stream
from repro.models.transformer import build_model

out = sys.argv[1]
cfg = get_config("smollm-135m").reduced()
mesh = jax.make_mesh(({W},), ("data",))
res = {{}}
for strat in {strategies}:
    model = build_model(cfg)
    ts = build_train_step(model, optim.adamw({lr}), get_strategy(strat),
                          mesh, data_axes=("data",), model_axis=None,
                          fsdp=True)
    state = ts.init_state(jax.random.PRNGKey(0))
    it = lm_batches(token_stream({batch} * {seq} * 64, cfg.vocab_size),
                    {batch}, {seq})
    losses = []
    for s in range({steps}):
        b = jax.tree.map(jnp.asarray, next(it))
        if s == 0 and strat == "allreduce":
            coll = analyze_collectives(
                ts.step_fn.lower(state, b).compile().as_text())
            for k in ("all-reduce", "all-gather", "reduce-scatter"):
                res[f"coll/{{k}}"] = np.asarray(
                    [coll.bytes_by_kind[k], coll.counts[k]])
        state, m = ts.step_fn(state, b)
        losses.append(float(m["loss"]))
        if s == 0:
            for k in "mv":
                res[f"{{strat}}/{{k}}1"] = np.asarray(
                    [np.asarray(x) for x in
                     jax.tree.leaves(state["opt"][k])], dtype=object)
            res[f"{{strat}}/p1"] = np.asarray(
                [np.asarray(x) for x in jax.tree.leaves(state["params"])],
                dtype=object)
    res[f"{{strat}}/losses"] = np.asarray(losses)
    res[f"{{strat}}/p_end"] = np.asarray(
        [np.asarray(x) for x in jax.tree.leaves(state["params"])],
        dtype=object)
np.savez(out, **res)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    inp = str(tmp / "params.npz")
    model = jbuild_model(jget_config("smollm-135m").reduced())
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    np.savez(inp, **{k: v.numpy() for k, v in
                     params_from_reference(tree).items()})
    np.savez(inp + ".tree.npz", tree=np.asarray(tree, dtype=object))
    fmt = dict(W=W, steps=STEPS, batch=BATCH, seq=SEQ, lr=LR,
               strategies=repr(STRATEGIES))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE.format(**fmt)),
         str(tmp / "reference.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={W}",
                 JAX_PLATFORMS="cpu"))]
    for r in range(W):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_PORT.format(**fmt)),
             str(r), inp, str(tmp / "port.npz"), f"file://{tmp}/pg"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(OMP_NUM_THREADS="1")))
    for p in procs:
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-3000:]
    return (np.load(tmp / "reference.npz", allow_pickle=True),
            np.load(tmp / "port.npz", allow_pickle=True))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fsdp_losses_match_the_reference(results, strategy):
    ref, port = results
    np.testing.assert_allclose(port[f"{strategy}/fsdp/losses"],
                               ref[f"{strategy}/losses"], rtol=1e-5)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fsdp_moments_and_parameters_match_the_reference(results,
                                                         strategy):
    """The first step's moments to 1e-5 and the parameters by the LM rule
    (``tests/test_torch_transformer.py``): to 1e-5 where |m| is at least
    1% of the leaf's largest, within AdamW's update bound everywhere; the
    gathered parameters after both steps within twice that bound."""
    ref, port = results
    tag = f"{strategy}/fsdp"
    for k in ("m1", "v1"):
        for got, want in zip(port[f"{tag}/{k}"], ref[f"{strategy}/{k}"]):
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
    for got, want, mw in zip(port[f"{tag}/p1"], ref[f"{strategy}/p1"],
                             ref[f"{strategy}/m1"]):
        sure = np.abs(mw) >= 1e-2 * np.abs(mw).max()
        np.testing.assert_allclose(got[sure], want[sure], rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        assert np.abs(got - want).max() <= 2 * LR
    for got, want in zip(port[f"{tag}/p_end"], ref[f"{strategy}/p_end"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 2 * LR * STEPS


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fsdp_collectives_equal_the_compiled_reference(results, strategy):
    ref, port = results
    for kind, (nbytes, ops) in COMPILED[strategy].items():
        got = port[f"{strategy}/fsdp/coll/{kind}"]
        assert got[0] == nbytes, kind
        want_ops = PORT_ALL_REDUCES[strategy] if kind == "all-reduce" \
            else ops
        assert got[1] == want_ops, kind
    # the table is what the reference compiles (checked here once)
    for kind, (nbytes, ops) in COMPILED["allreduce"].items():
        assert ref[f"coll/{kind}"].tolist() == [nbytes, ops]


def test_fsdp_holds_a_quarter_of_each_sharded_leaf(results):
    """9 of reduced SmolLM's 12 leaves are sharded (the block leaves; the
    embedding, unembedding and final norm are not): each rank holds 1/4
    of their elements in the parameter and both moments, and exactly
    ``params_from_reference(tree, mesh, rank)``'s slice."""
    _, port = results
    mask = port["allreduce/fsdp/mask"]
    assert mask.sum() == 9 and len(mask) == 12
    full = [p.size for p in port["allreduce/dp/p_end"]]
    for sharded, (p, m, v), n in zip(mask,
                                     port["allreduce/fsdp/elements"], full):
        assert p == m == v == (n // W if sharded else n)
    assert bool(port["allreduce/fsdp/shards_equal"])


def test_fsdp_matches_the_ports_own_data_parallel_run(results):
    _, port = results
    np.testing.assert_allclose(port["allreduce/fsdp/losses"],
                               port["allreduce/dp/losses"], rtol=1e-5)
    dp = port["allreduce/dp/coll/all-reduce"]
    assert dp.tolist() == [5_510_148, 2]
    assert port["allreduce/dp/coll/all-gather"].tolist() == [0, 0]


def test_train_entry_point_runs_fsdp_on_four_ranks(tmp_path):
    """``launch.train --mesh 4x1 --fsdp`` trains reduced SmolLM on 4 CPU
    ranks and saves the whole parameter tree, which the reference's
    ``checkpoint.restore`` reads at the reference's shapes."""
    from repro import checkpoint as jckpt
    path = tmp_path / "params.msgpack"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-135m", "--reduced", "--device", "cpu", "--world-size", "4",
         "--mesh", "4x1", "--fsdp", "--steps", "2", "--batch", "8",
         "--seq", "32", "--checkpoint", str(path)],
        capture_output=True, text=True, timeout=300,
        env=_env(OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "fsdp=True" in out.stdout and "step    1" in out.stdout
    like = jax.tree.map(np.asarray, jbuild_model(
        jget_config("smollm-135m").reduced()).init(jax.random.PRNGKey(0)))
    tree = jckpt.restore(str(path), like=like)
    assert [np.shape(x) for x in jax.tree.leaves(tree)] == \
        [x.shape for x in jax.tree.leaves(like)]


@pytest.mark.parametrize("mesh, err", [
    ("2x2", NotImplementedError), ("2x1", ValueError), ("4", ValueError)])
def test_train_entry_point_refuses_bad_meshes(mesh, err):
    """A model axis above 1 is tensor parallelism, which every transformer
    family runs and the CNNs refuse (``NotImplementedError``, before any
    process group is touched); the axes must span the world; a mesh is
    DxM or PxDxM."""
    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.core import build_train_step, get_strategy
    from repro_torch.launch.train import parse_mesh
    from repro_torch.models.transformer import Model
    if mesh == "2x2":
        tp = parse_mesh(mesh, 4)
        assert tp.shape == {"data": 2, "model": 2}
        from repro_torch.models.cnn import build_cnn
        model = build_cnn(get_config("mobilenet-cifar"), device="cpu")
        with pytest.raises(err, match="a CNN"):
            build_train_step(model, optim.adamw(1e-3),
                             get_strategy("allreduce"), tp,
                             model_axis="model")
    else:
        with pytest.raises(err):
            parse_mesh(mesh, 4)
    assert parse_mesh("2x2x1", 4).shape == {"pod": 2, "data": 2,
                                             "model": 1}
