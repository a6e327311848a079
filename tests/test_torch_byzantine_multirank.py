"""Four ranks under a byzantine worker: the port on four gloo processes
against the JAX reference on four host devices, each in subprocesses (the
pytest process keeps its one-device JAX backend).  The reference runs on a
pure data-parallel mesh, ``("data",)`` with ``model_axis=None``: its own
harness builds a mesh with a ``model`` axis, which this JAX version
refuses.

Same per-rank numpy gradients through one sync of each robust inner under
``ByzantineGradients`` (rank 0 ships -8x its gradient), each attack's
corruption against the reference's numpy ``apply_rows`` on the gathered
stack, and two byzantine train steps of reduced MobileNet under the
trimmed mean with SPIRT's K = 4 microbatches."""
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
from repro.serverless import adversarial as jadv  # noqa: E402
from repro_torch.models import params_from_reference  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
W = 4
BYZ = (0,)
LEAF_SHAPES = [(3, 3, 1, 40), (300,), (16, 16), (1, 1, 24, 48), (7,)]
INNERS = {"trimmed_mean": "dict(trim=1)", "coordinate_median": "{}",
          "krum": "dict(f=0)",
          "geometric_median": "dict(tol=1e-6, max_iter=100)"}
ATTACKS = ["sign_flip", "scale", "little_is_enough", "zero"]
BATCH = 16          # global; 4 a rank, so K = 4 microbatches of 1

_PORT = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import optim
from repro_torch.configs.base import get_config
from repro_torch.core import build_train_step, get_strategy
from repro_torch.models import build_cnn
from repro_torch.serverless.adversarial import get_attack

rank, inp, out, init = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
W, BYZ, n = {W}, {BYZ}, {n}
inners, attacks = {inners}, {attacks}
d = np.load(inp)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=W)
res = {{}}
grads = [torch.from_numpy(d[f"g{{rank}}_{{i}}"]) for i in range(n)]


def byzantine(inner, **kw):
    return get_strategy("byzantine", inner=inner, workers=BYZ, n_workers=W,
                        **kw)


for name, kw in inners.items():
    s = byzantine(get_strategy(name, **kw), scale=-8.0)
    synced, state, _ = s.sync(grads, s.init_state(grads))
    assert state[0] == 1
    for i, o in enumerate(synced):
        res[f"inner/{{name}}/{{i}}"] = o.numpy()
for attack in attacks:
    spec = get_attack(attack)
    scale = -8.0 if attack == "scale" else spec.default_scale
    for i, o in enumerate(spec.torch_apply(grads, rank in BYZ, None, scale,
                                           0, 0)):
        res[f"attack/{{attack}}/{{i}}"] = o.numpy()
    s = byzantine(get_strategy("trimmed_mean"), attack=attack, scale=scale)
    for i, o in enumerate(s.sync(grads, s.init_state(grads))[0]):
        res[f"byz/{{attack}}/{{i}}"] = o.numpy()
for name in ("trimmed_mean", "coordinate_median"):
    s = get_strategy(name)
    for i, o in enumerate(s.sync_per_leaf(grads, ())[0]):
        res[f"leaf/{{name}}/{{i}}"] = o.numpy()

model = build_cnn(get_config("mobilenet-cifar").reduced(), device="cpu")
model.load_state_dict({{k[2:]: torch.from_numpy(d[k]) for k in d.files
                       if k.startswith("p/")}})
model = model.double()
ts = build_train_step(model, optim.sgd(0.05, momentum=0.9), byzantine(
    get_strategy("trimmed_mean", microbatches=4), scale=-8.0))
state = ts.init_state()
B = {batch} // W
for k in range(2):
    sl = slice(k * {batch} + rank * B, k * {batch} + (rank + 1) * B)
    state, m = ts.step_fn(state, {{
        "images": torch.from_numpy(d["images"][sl]).double(),
        "labels": torch.from_numpy(d["labels"][sl])}})
    res[f"step/loss{{k}}"] = m["loss"].numpy()
assert state["strat"][0] == 2
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
W, BYZ, n = {W}, {BYZ}, {n}
inners = {inners}
d = np.load(inp)
mesh = jax.make_mesh((W,), ("data",))
grads = [jnp.asarray(np.stack([d[f"g{{r}}_{{i}}"] for r in range(W)]))
         for i in range(n)]
res = {{}}


def byzantine(inner, **kw):
    return get_strategy("byzantine", inner=inner, workers=BYZ, n_workers=W,
                        **kw)


def sync(s):
    def body(g):
        local = [x[0] for x in g]
        o, _, _ = s.sync(local, s.init_state(local), "data")
        return [x[None] for x in o]
    return jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),),
                             out_specs=P("data"), axis_names={{"data"}}))(
        grads)


# the kernel paths, but the geometric median's direct form: its kernel
# computes the direct distances, not the cached-Gram form the CPU twin uses
for name, kw in inners.items():
    inner = get_strategy(name, use_pallas=name != "geometric_median", **kw)
    for i, o in enumerate(sync(byzantine(inner, scale=-8.0))):
        res[f"inner/{{name}}/{{i}}"] = np.asarray(o)

# drawn outside x64 mode, where an undeclared dtype would be float64 and
# the draws would differ from the parameters the port loads
model = build_cnn(get_config("mobilenet-cifar").reduced())
tree32 = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
with jax.enable_x64(True):
    tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree32)

    def loss_fn(params, b):
        logits, _ = model.apply(params, b)
        return losses.classification_loss(logits, b["labels"])
    strat = byzantine(get_strategy("trimmed_mean", microbatches=4,
                                   use_pallas=True), scale=-8.0)
    ts = build_train_step(model, optim.sgd(0.05, momentum=0.9), strat, mesh,
                          data_axes=("data",), model_axis=None,
                          loss_fn=loss_fn)
    state = ts.init_state(jax.random.PRNGKey(0), dtype_params=tree)
    for k in range(2):
        sl = slice(k * {batch}, (k + 1) * {batch})
        state, m = ts.step_fn(state, {{
            "images": jnp.asarray(d["images"][sl], jnp.float64),
            "labels": jnp.asarray(d["labels"][sl])}})
        res[f"step/loss{{k}}"] = np.asarray(m["loss"])
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
    rs = np.random.RandomState(12)
    arrays = {}
    for r in range(W):
        for i, s in enumerate(LEAF_SHAPES):
            arrays[f"g{r}_{i}"] = (rs.randn(*s) * rs.lognormal(size=s)
                                   ).astype(np.float32)
    from repro_torch.data import cifar_like
    imgs, labels = cifar_like(2 * BATCH, seed=4)
    arrays["images"], arrays["labels"] = imgs, labels
    model = jbuild_cnn(jget_config("mobilenet-cifar").reduced())
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    for k, v in params_from_reference(tree).items():
        arrays[f"p/{k}"] = v.numpy()
    np.savez(path, **arrays)
    return arrays


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("byzantine")
    inp = str(tmp / "inputs.npz")
    arrays = _inputs(inp)
    fmt = dict(W=W, BYZ=repr(BYZ), n=len(LEAF_SHAPES), batch=BATCH,
               inners="{" + ", ".join(f"{k!r}: {v}" for k, v in
                                      INNERS.items()) + "}",
               attacks=repr(ATTACKS))
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
            env=_env(OMP_NUM_THREADS="1")))
    for p in procs:
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-3000:]
    return (arrays, np.load(tmp / "reference.npz"),
            [np.load(tmp / f"port{r}.npz") for r in range(W)])


def _stacked(arrays, i):
    return np.stack([arrays[f"g{r}_{i}"] for r in range(W)])


@pytest.mark.parametrize("inner", sorted(INNERS))
def test_robust_sync_under_attack_matches_reference(results, inner):
    """One sync of each robust inner after rank 0's -8x corruption, the
    gradients packed into one buffer and gathered into a (4, D) stack.
    Trimmed mean and median: the trim=1 mask leaves two terms, the median
    of four averages two, so both are exact.  Krum selects one row
    (exact).  The geometric median loops on the host until the step falls
    below tol * scale; the two loops may stop one iteration apart:
    2 * tol * scale plus 1e-5 of the largest value."""
    arrays, ref, ports = results
    scale = np.sqrt(max(sum(float(np.sum(arrays[f"g{r}_{i}"].astype(
        np.float64) ** 2) * (64 if r in BYZ else 1))
        for i in range(len(LEAF_SHAPES))) for r in range(W)))
    for r, port in enumerate(ports):
        for i in range(len(LEAF_SHAPES)):
            got, want = port[f"inner/{inner}/{i}"], \
                ref[f"inner/{inner}/{i}"][r]
            if inner == "geometric_median":
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           atol=2e-6 * scale)
            else:
                np.testing.assert_array_equal(got, want)
    if inner != "geometric_median":   # the attacker's rows are out
        for i in range(len(LEAF_SHAPES)):
            evil = -8.0 * arrays[f"g0_{i}"]
            assert not np.array_equal(ports[0][f"inner/{inner}/{i}"], evil)


@pytest.mark.parametrize("attack", ATTACKS)
def test_attack_matches_numpy_rows_on_gathered_stack(results, attack):
    """Each rank's corrupted gradients, stacked in rank order, against
    the reference's numpy ``apply_rows`` on the stack of the inputs:
    exact, and to 1e-6 of the largest value for the colluding attack,
    whose fp32 all-reduces of x and x^2 stand in for float64 moments.
    The trimmed mean of the corrupted stack equals the port's byzantine
    sync."""
    arrays, _, ports = results
    spec = jadv.get_attack(attack)
    scale = -8.0 if attack == "scale" else spec.default_scale
    mask = np.isin(np.arange(W), BYZ)
    for i in range(len(LEAF_SHAPES)):
        stacked = _stacked(arrays, i).reshape(W, -1).astype(np.float64)
        want = spec.apply_rows(stacked, mask, None, scale)
        got = np.stack([p[f"attack/{attack}/{i}"].reshape(-1)
                        for p in ports])
        np.testing.assert_array_equal(got[~mask], stacked[~mask])
        if attack == "little_is_enough":
            np.testing.assert_allclose(got[mask], want[mask], rtol=0,
                                       atol=1e-6 * float(np.abs(
                                           stacked).max()))
        else:
            np.testing.assert_array_equal(got, want.astype(np.float32))
        s = np.sort(got.astype(np.float64), axis=0)[1:-1].mean(axis=0)
        for p in ports:
            np.testing.assert_allclose(
                p[f"byz/{attack}/{i}"].reshape(-1), s, rtol=1e-6,
                atol=1e-6 * float(np.abs(s).max()))


@pytest.mark.parametrize("name", ["trimmed_mean", "coordinate_median"])
def test_per_leaf_sync_equals_flat_sync(results, name):
    """The coordinate-wise rules give the same numbers leaf by leaf as on
    the one packed buffer, on every rank (no attack here: the flat sync
    of the inner alone equals the per-leaf one)."""
    arrays, _, ports = results
    for i in range(len(LEAF_SHAPES)):
        stacked = _stacked(arrays, i)
        s = np.sort(stacked, axis=0)
        want = (s[1] + s[2]) / 2 if name == "coordinate_median" else \
            s[1:-1].mean(axis=0)
        for p in ports:
            np.testing.assert_allclose(p[f"leaf/{name}/{i}"], want,
                                       rtol=1e-6, atol=1e-7)


def test_byzantine_train_steps_match_reference(results):
    """Two steps of reduced MobileNet, 4 ranks of 4 images, K = 4
    microbatches, rank 0 at -8x, the trimmed mean; float64 around the
    model, the aggregation in fp32 in both: both losses and every
    parameter of every rank agree to 1e-6."""
    _, ref, ports = results
    n = len([k for k in ref.files if k.startswith("step/param/")])
    assert n == 83
    for port in ports:
        for k in range(2):
            np.testing.assert_allclose(float(port[f"step/loss{k}"]),
                                       float(ref[f"step/loss{k}"]),
                                       rtol=1e-6)
        for i in range(n):
            np.testing.assert_allclose(port[f"step/param/{i}"],
                                       ref[f"step/param/{i}"],
                                       rtol=1e-6, atol=1e-6)
    for i in range(n):   # every rank holds the same replica
        for port in ports[1:]:
            np.testing.assert_array_equal(port[f"step/param/{i}"],
                                          ports[0][f"step/param/{i}"])


def test_byzantine_train_entry_point_on_cpu_ranks():
    """``run_in_subprocess`` drives ``main``: four gloo ranks of reduced
    MobileNet, three steps under the -8x attack; the RESULT line parses
    and every loss is finite."""
    from repro_torch.launch.byzantine_train import run_in_subprocess
    r = run_in_subprocess("trimmed_mean", steps=3, data_size=128,
                          world_size=4, device="cpu", timeout=300)
    assert r["inner"] == "trimmed_mean" and r["steps"] == 3
    for k in ("final_loss", "max_loss", "head_loss", "tail_loss", "acc"):
        assert np.isfinite(r[k]), r
    assert 0.0 <= r["acc"] <= 1.0
