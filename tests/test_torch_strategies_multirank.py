"""Two ranks: the port on two gloo processes against the JAX reference on
two host devices, each in subprocesses (the pytest process keeps its
one-device JAX backend; see test_multidevice.py).  Same per-rank numpy
gradients through one sync of each strategy, and one MLLess train step
of reduced MobileNet on a global batch of 8."""
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
from repro.models.cnn import build_cnn as jbuild_cnn  # noqa: E402
from repro_torch.core.strategies import STRATEGIES  # noqa: E402
from repro_torch.models import params_from_reference  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
W = 2
NAMES = sorted(STRATEGIES)
LEAF_SHAPES = [(3, 3, 1, 40), (300,), (16, 16), (1, 1, 24, 48), (7,)]

_PORT = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import optim
from repro_torch.configs.base import get_config
from repro_torch.core import build_train_step, get_strategy
from repro_torch.models import build_cnn

rank, inp, out, init = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
W, names = {W}, {names}
d = np.load(inp)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=W)
res = {{}}
grads = [torch.from_numpy(d[f"g{{rank}}_{{i}}"]) for i in range({n})]
for name in names:
    s = get_strategy(name)
    synced, state, info = s.sync(grads, s.init_state(grads))
    for i, o in enumerate(synced):
        res[f"{{name}}/out/{{i}}"] = o.numpy()
    if name == "mlless":
        for i, r in enumerate(state):
            res[f"mlless/resid/{{i}}"] = r.numpy()
        res["mlless/frac"] = info["significant_fraction"].numpy()
model = build_cnn(get_config("mobilenet-cifar").reduced(), device="cpu")
model.load_state_dict({{k[2:]: torch.from_numpy(d[k]) for k in d.files
                       if k.startswith("p/")}})
model = model.double()
ts = build_train_step(model, optim.sgd(0.05, momentum=0.9),
                      get_strategy("mlless"))
B = len(d["labels"]) // W
sl = slice(rank * B, (rank + 1) * B)
state, m = ts.step_fn(ts.init_state(), {{
    "images": torch.from_numpy(d["images"][sl]).double(),
    "labels": torch.from_numpy(d["labels"][sl])}})
res["step/loss"] = m["loss"].numpy()
res["step/frac"] = m["significant_fraction"].numpy()
for i, p in enumerate(state["params"]):
    res[f"step/param/{{i}}"] = p.detach().numpy()
np.savez(out, **res)
dist.destroy_process_group()
"""

_REFERENCE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import optim
from repro.compat import shard_map
from repro.configs.base import get_config
from repro.core import build_train_step, get_strategy, losses
from repro.models.cnn import build_cnn

inp, out = sys.argv[1], sys.argv[2]
W, names, n = {W}, {names}, {n}
d = np.load(inp)
mesh = jax.make_mesh((W,), ("data",))
grads = [np.stack([d[f"g{{r}}_{{i}}"] for r in range(W)]) for i in range(n)]
res = {{}}
for name in names:
    s = get_strategy(name)
    state = ([jnp.zeros(g.shape, jnp.float32) for g in grads]
             if name == "mlless" else ())

    def body(g, st, s=s):
        o, new, info = s.sync([x[0] for x in g], [x[0] for x in st], "data")
        return ([x[None] for x in o], [x[None] for x in new],
                {{k: v[None] for k, v in info.items()}})
    fn = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data"), P("data")),
                   axis_names={{"data"}})
    synced, new, info = jax.jit(fn)([jnp.asarray(g) for g in grads],
                                    list(state))
    for i, o in enumerate(synced):
        res[f"{{name}}/out/{{i}}"] = np.asarray(o)
    if name == "mlless":
        for i, r in enumerate(new):
            res[f"mlless/resid/{{i}}"] = np.asarray(r)
        res["mlless/frac"] = np.asarray(info["significant_fraction"])

# drawn outside x64 mode, where an undeclared dtype would be float64 and
# the draws would differ from the parameters the port loads
model = build_cnn(get_config("mobilenet-cifar").reduced())
tree32 = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
with jax.enable_x64(True):
    tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree32)

    def loss_fn(params, b):
        logits, _ = model.apply(params, b)
        return losses.classification_loss(logits, b["labels"])
    ts = build_train_step(model, optim.sgd(0.05, momentum=0.9),
                          get_strategy("mlless"), mesh, data_axes=("data",),
                          model_axis=None, loss_fn=loss_fn)
    state = ts.init_state(jax.random.PRNGKey(0), dtype_params=tree)
    state, m = ts.step_fn(state, {{
        "images": jnp.asarray(d["images"], jnp.float64),
        "labels": jnp.asarray(d["labels"])}})
    res["step/loss"] = np.asarray(m["loss"])
    res["step/frac"] = np.asarray(m["significant_fraction"])
    for i, p in enumerate(jax.tree.leaves(state["params"])):
        res[f"step/param/{{i}}"] = np.asarray(p)
np.savez(out, **res)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _inputs(path):
    rs = np.random.RandomState(10)
    arrays = {}
    for r in range(W):
        for i, s in enumerate(LEAF_SHAPES):
            arrays[f"g{r}_{i}"] = (rs.randn(*s) * rs.lognormal(size=s)
                                   ).astype(np.float32)
    from repro_torch.data import cifar_like
    imgs, labels = cifar_like(8, seed=4)
    arrays["images"], arrays["labels"] = imgs, labels
    model = jbuild_cnn(jget_config("mobilenet-cifar").reduced())
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    for k, v in params_from_reference(tree).items():
        arrays[f"p/{k}"] = v.numpy()
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multirank")
    inp = str(tmp / "inputs.npz")
    _inputs(inp)
    fmt = dict(W=W, names=repr(NAMES), n=len(LEAF_SHAPES))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE.format(**fmt)),
         inp, str(tmp / "reference.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={W}",
                 JAX_PLATFORMS="cpu"))]
    for r in range(W):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_PORT.format(**fmt)),
             str(r), inp, str(tmp / f"port{r}.npz"), f"file://{tmp}/pg"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(OMP_NUM_THREADS="2")))
    for p in procs:
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-3000:]
    return (np.load(tmp / "reference.npz"),
            [np.load(tmp / f"port{r}.npz") for r in range(W)])


@pytest.mark.parametrize("name", NAMES)
def test_one_sync_matches_reference_on_two_ranks(results, name):
    """Sums of two fp32 values, and means of two, are exact in any order,
    so every strategy's output agrees exactly on every rank.  MLLess
    filters each rank's own gradient first: its per-rank residuals and
    the mean significant fraction agree exactly too."""
    ref, ports = results
    for r, port in enumerate(ports):
        for i in range(len(LEAF_SHAPES)):
            np.testing.assert_array_equal(port[f"{name}/out/{i}"],
                                          ref[f"{name}/out/{i}"][r])
        if name == "mlless":
            for i in range(len(LEAF_SHAPES)):
                np.testing.assert_array_equal(port[f"mlless/resid/{i}"],
                                              ref[f"mlless/resid/{i}"][r])
    if name == "mlless":
        fracs = [float(p["mlless/frac"]) for p in ports]
        ref_frac = float(np.asarray(ref["mlless/frac"]).mean())
        assert np.mean(fracs) == pytest.approx(ref_frac, rel=1e-7)
        assert fracs[0] != fracs[1]   # each rank filtered its own grads


def test_mlless_train_step_matches_reference_on_two_ranks(results):
    """One step of reduced MobileNet, global batch 8 split 4 + 4, float64
    parameters as in test_torch_train_step: loss, mean significant
    fraction and every parameter of both ranks agree to 1e-6."""
    ref, ports = results
    n = len([k for k in ref.files if k.startswith("step/param/")])
    assert n == 83
    for port in ports:
        np.testing.assert_allclose(float(port["step/loss"]),
                                   float(ref["step/loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(port["step/frac"]),
                                   float(ref["step/frac"]), rtol=1e-6)
        for i in range(n):
            np.testing.assert_allclose(port[f"step/param/{i}"],
                                       ref[f"step/param/{i}"],
                                       rtol=1e-6, atol=1e-6)
