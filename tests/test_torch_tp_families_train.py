"""Tensor-parallel training of the other families on 4 gloo ranks, a (2, 2)
("data", "model") mesh, against the reference's train step with
``model_axis="model"`` on a 4-device mesh with Auto axes, each in its own
process: reduced Mixtral 8x7B (4 experts, top 2, 4 / 1 heads), RWKV6
(head_dim 32: 8 heads, 4 a rank), RecurrentGemma at 3 layers (one
(RG-LRU, RG-LRU, local) block), Whisper-small (2 encoder and 2 decoder
layers over 32 stub frames) and Pixtral (8 stub patches), fp32, global
batch 8 x 64, AdamW lr 3e-3, 2 steps from the reference's parameters.

Cases: allreduce for every family, allreduce under FSDP for Mixtral and
RWKV, and MLLess for Mixtral (whole expert leaves at the data width).
Losses agree to 1e-5 (MLLess: the first step's, as
``test_torch_tp_train.py`` holds it).  Each rank holds exactly
``params_from_reference(tree, mesh, rank)``'s slices, and after the first
step its AdamW moments are the reference's moments' slices (to 1e-5 of
each leaf's largest; the bars of ``test_torch_families.py`` where a
gradient is a small remainder of larger terms).  The ``baseline``
dry-run's argument bytes a rank for Mixtral and RWKV equal the
reference's ``memory_analysis()``, and its collectives the real step's,
kind for kind."""
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
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.transformer import params_from_reference  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
D, M, STEPS, BATCH, SEQ, LR = 2, 2, 2, 8, 64, 3e-3
# (arch, strategy, fsdp)
CASES = [("mixtral-8x7b", "allreduce", False),
         ("rwkv6-7b", "allreduce", False),
         ("recurrentgemma-2b", "allreduce", False),
         ("whisper-small", "allreduce", False),
         ("pixtral-12b", "allreduce", False),
         ("mixtral-8x7b", "allreduce", True),
         ("rwkv6-7b", "allreduce", True),
         ("mixtral-8x7b", "mlless", False)]
IDS = ["mixtral", "rwkv", "rglru", "whisper", "pixtral", "mixtral-fsdp",
       "rwkv-fsdp", "mixtral-mlless"]
ARCHS = sorted({a for a, _, _ in CASES})
# the cases whose compiled step's argument bytes the dry-run is held to
BYTES = {"mixtral-8x7b": 0, "rwkv6-7b": 1}
REF_PARTS = 4
MESH = make_mesh((D, M), ("data", "model"))

_CFG = """
def cfg_of(arch):
    return get_config(arch).reduced(
        **({"n_layers": 3} if arch == "recurrentgemma-2b" else {}))
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
for c, (arch, strat, fsdp) in enumerate({cases}):
    tree = d["tree/" + arch].item()
    model = Model(cfg_of(arch))
    model.load_state_dict(params_from_reference(tree))
    ts = build_train_step(model, optim.adamw({lr}), get_strategy(strat),
                          mesh, data_axes=("data",), model_axis="model",
                          fsdp=fsdp)
    state = ts.init_state()
    mine = params_from_reference(tree, mesh, rank, fsdp=fsdp)
    res[f"{{c}}/slices_equal"] = np.asarray(all(
        torch.equal(p, mine[n]) for n, p in model.named_parameters()))
    losses = []
    for s in range({steps}):
        b = {{k: torch.from_numpy(d[f"batch{{s}}/{{arch}}/{{k}}"][
            di * B:(di + 1) * B]) for k in d["keys/" + arch]}}
        with record_collectives() as rec:
            state, m = ts.step_fn(state, b)
        losses.append(float(m["loss"]))
        if s == 0:
            st = stats(rec)
            res[f"{{c}}/coll"] = np.asarray(
                [[st.counts[k], st.bytes_by_kind[k]] for k in
                 ("all-reduce", "all-gather", "reduce-scatter")])
            for k in "mv":
                for i, t in enumerate(state["opt"][k]):
                    res[f"{{c}}/{{k}}{{i}}"] = t.numpy().copy()
    res[f"{{c}}/losses"] = np.asarray(losses)
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
from repro.models.transformer import build_model
{cfg}
inp, out, part = sys.argv[1], sys.argv[2], int(sys.argv[3])
d = np.load(inp, allow_pickle=True)
mesh = jax.make_mesh(({D}, {M}), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
res = {{}}
for c, (arch, strat, fsdp) in enumerate({cases}):
    if c % {parts} != part:
        continue
    model = build_model(cfg_of(arch))
    ts = build_train_step(model, optim.adamw({lr}), get_strategy(strat),
                          mesh, data_axes=("data",), model_axis="model",
                          fsdp=fsdp)
    state = ts.init_state(jax.random.PRNGKey(0))
    losses = []
    step = ts.step_fn
    for s in range({steps}):
        b = {{k: jnp.asarray(d[f"batch{{s}}/{{arch}}/{{k}}"])
              for k in d["keys/" + arch]}}
        if s == 0 and c in {bytes_cases}:
            step = ts.step_fn.lower(state, b).compile()
            res[f"{{c}}/argument_bytes"] = np.asarray(
                step.memory_analysis().argument_size_in_bytes)
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if s == 0:
            for k in "mv":
                for i, t in enumerate(jax.tree.leaves(state["opt"][k])):
                    res[f"{{c}}/{{k}}{{i}}"] = np.asarray(t)
    res[f"{{c}}/losses"] = np.asarray(losses)
np.savez(out, **res)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _jcfg(arch):
    return jget_config(arch).reduced(
        **({"n_layers": 3} if arch == "recurrentgemma-2b" else {}))


def _batches(arch):
    """The global batches of ``arch``: tokens and labels from the
    reference's stream, stub frames / patches ``0.1 * randn``."""
    from repro_torch.data import lm_batches, token_stream
    from repro_torch.launch.train import stub_inputs
    cfg = _jcfg(arch)
    it = lm_batches(token_stream(BATCH * SEQ * 64, cfg.vocab_size), BATCH,
                    SEQ)
    rs = np.random.RandomState(0)
    return [{**next(it), **stub_inputs(cfg, BATCH, rs)}
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_families_train")
    inp = str(tmp / "inputs.npz")
    saved, trees = {}, {}
    for arch in ARCHS:
        trees[arch] = jax.tree.map(np.asarray, jbuild_model(_jcfg(arch)).init(
            jax.random.PRNGKey(0)))
        saved["tree/" + arch] = np.asarray(trees[arch], dtype=object)
        batches = _batches(arch)
        saved["keys/" + arch] = np.asarray(sorted(batches[0]))
        for s, b in enumerate(batches):
            saved.update({f"batch{s}/{arch}/{k}": v for k, v in b.items()})
    np.savez(inp, **saved)
    fmt = dict(D=D, M=M, steps=STEPS, batch=BATCH, lr=LR, cases=repr(CASES),
               cfg=_CFG, parts=REF_PARTS,
               bytes_cases=repr(sorted(BYTES.values())))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE.format(**fmt)),
         inp, str(tmp / f"reference{i}.npz"), str(i)],
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
    return ref, [np.load(tmp / f"port{r}.npz") for r in range(D * M)], trees


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_tp_family_losses_match_the_reference(results, case):
    ref, ports, _ = results
    for p in ports:
        np.testing.assert_array_equal(p[f"{case}/losses"],
                                      ports[0][f"{case}/losses"])
    # MLLess: the first step only (later steps filter blocks near the cut
    # that rounding flips)
    n = 1 if CASES[case][1] == "mlless" else STEPS
    np.testing.assert_allclose(ports[0][f"{case}/losses"][:n],
                               ref[f"{case}/losses"][:n], rtol=1e-5)


def _moment_bar(name):
    """The bars of ``test_torch_families.py``: a key bias's gradient is
    zero in exact arithmetic (its moments are fp32 noise, held to 1e-7 of
    the largest moment), and Whisper's cross-attention q/k side carries
    about 1.5e-5 of rounding."""
    if name.endswith("['bk']"):
        return "key_bias"
    cross = ("['norm_x']", "['xattn']['bq']", "['xattn']['wq']",
             "['xattn']['wk']")
    return 4e-5 if name.endswith(cross) else 1e-5


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_tp_family_ranks_hold_the_reference_slices(results, case):
    """Each rank's parameters are ``params_from_reference(tree, mesh,
    rank, fsdp=...)``'s slices; after the first step each rank's AdamW
    moments are the slices of the reference's moments, laid out alike."""
    ref, ports, trees = results
    arch, _, fsdp = CASES[case]
    tree = trees[arch]
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    names = [jax.tree_util.keystr(path) for path, _ in flat]
    for k in "mv":
        want_leaves = [ref[f"{case}/{k}{i}"] for i in range(len(flat))]
        largest = max(np.abs(w).max() for w in want_leaves)
        for r, p in enumerate(ports):
            assert bool(p[f"{case}/slices_equal"])
            mine = params_from_reference(
                jax.tree_util.tree_unflatten(treedef, want_leaves), MESH, r,
                fsdp=fsdp)
            want = [mine[".".join(str(getattr(e, "key", getattr(e, "idx",
                                                             None)))
                                  for e in path)].numpy()
                    for path, _ in flat]
            for i, (w, name) in enumerate(zip(want, names)):
                got = p[f"{case}/{k}{i}"]
                assert got.shape == w.shape, name
                bar = _moment_bar(name)
                atol = 1e-7 * largest if bar == "key_bias" \
                    else bar * np.abs(w).max()
                np.testing.assert_allclose(got, w, rtol=0, atol=atol,
                                           err_msg=f"{k} {name} rank {r}")


@pytest.mark.parametrize("arch", sorted(BYTES))
def test_baseline_dryrun_bytes_and_collectives(results, arch):
    """The ``baseline`` dry-run of the allreduce step on the (2, 2) mesh
    (a fake process group, meta tensors): the state and batch slices a
    rank holds, byte for byte the reference's ``memory_analysis()``; its
    collectives, which the real step records, kind for kind."""
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch import dryrun
    ref, ports, _ = results
    c = BYTES[arch]
    res = dryrun.dryrun_one(
        arch, "small", profile="baseline", save=False, mesh=MESH,
        config=get_config(arch).reduced(),
        input_shape=InputShape("small", SEQ, BATCH, "train"))
    assert res["memory"]["argument_bytes"] == int(
        ref[f"{c}/argument_bytes"])
    got = res["collectives"]
    for i, kind in enumerate(("all-reduce", "all-gather", "reduce-scatter")):
        assert got["counts"][kind] == ports[0][f"{c}/coll"][i][0]
        assert got["bytes_by_kind"][kind] == ports[0][f"{c}/coll"][i][1]


def test_train_entry_point_runs_mixtral_tp_on_four_ranks():
    """``launch.train --mesh 2x2`` trains reduced Mixtral on 4 CPU ranks."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mixtral-8x7b", "--reduced", "--device", "cpu", "--world-size",
         "4", "--mesh", "2x2", "--steps", "2", "--batch", "8", "--seq",
         "32"], capture_output=True, text=True, timeout=300,
        env=_env(OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "'model': 2" in out.stdout and "step    1" in out.stdout
