"""Parity of the port's optimizers, strategies, train step and training
entry point with the JAX reference on the CPU, on one rank: a one-rank
gloo process group against the reference's pure-DP mesh
``jax.make_mesh((1,), ("data",))`` with ``model_axis=None``."""
import math

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.compat import shard_map  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import build_train_step as jbuild_train_step  # noqa: E402
from repro.core import get_strategy as jget_strategy  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.models.cnn import build_cnn as jbuild_cnn  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import build_train_step, get_strategy, losses  # noqa: E402
from repro_torch.core.strategies import STRATEGIES  # noqa: E402
from repro_torch.data import cifar_like  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

NAMES = sorted(STRATEGIES)
# leaf shapes of mixed sizes: several are not multiples of MLLess's block
LEAF_SHAPES = [(3, 3, 1, 40), (300,), (16, 16), (1, 1, 24, 48), (7,)]


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo process group (file rendezvous: pytest runs
    several workers at once)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    yield None
    dist.destroy_process_group()


def _leaves(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*s) * scale * rs.lognormal(size=s)).astype(np.float32)
            for s in LEAF_SHAPES]


def _jax_sync(strategy, grads, state):
    """The reference strategy's sync on the one-device pure-DP mesh."""
    mesh = jax.make_mesh((1,), ("data",))

    def body(g, s):
        out, new, info = strategy.sync(g, s, "data")
        return out, new, info
    info_spec = {"significant_fraction": P()} \
        if hasattr(strategy, "threshold") else {}
    fn = shard_map(body, mesh=mesh, in_specs=(P(), P()),
                   out_specs=(P(), P(), info_spec), axis_names={"data"})
    return jax.jit(fn)([jnp.asarray(g) for g in grads], state)


@pytest.mark.parametrize("name", NAMES)
def test_sync_matches_reference_on_one_rank(group, name):
    """One rank: every strategy returns the mean of one gradient.  Dense
    syncs are exact; MLLess's masks come from fp32 norms that agree to
    1e-5 (kept 1e-4 off the threshold here), so it is exact too, over
    two syncs that carry the residual."""
    jstrat, strat = jget_strategy(name), get_strategy(name)
    jstate = jstrat.init_state([jnp.asarray(g) for g in _leaves(0)])
    state = strat.init_state([torch.from_numpy(g) for g in _leaves(0)])
    for seed in (0, 1):
        grads = _leaves(seed)
        jout, jstate, jinfo = _jax_sync(jstrat, grads, jstate)
        out, state, info = strat.sync([torch.from_numpy(g) for g in grads],
                                      state)
        for a, b in zip(out, jout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if name == "mlless":
            for a, b in zip(state, jstate):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert float(info["significant_fraction"]) == \
                float(jinfo["significant_fraction"])
            assert 0 < float(info["significant_fraction"]) < 1


@pytest.mark.parametrize("name", NAMES)
def test_comm_bytes_match_reference(name):
    grads = _leaves(0)
    for W in (1, 2, 8):
        assert get_strategy(name).comm_bytes(grads, W) == \
            jget_strategy(name).comm_bytes(grads, W)
        assert get_strategy(name).comm_bytes(
            [torch.from_numpy(g) for g in grads], W) == \
            jget_strategy(name).comm_bytes(grads, W)


def test_get_strategy_rejects_unknown_names():
    with pytest.raises(KeyError, match="unknown strategy"):
        get_strategy("no_such_strategy")
    with pytest.raises(ValueError, match="needs an inner strategy"):
        get_strategy("byzantine")      # a known name, wrongly built


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("make", [
    lambda o: o.sgd(0.05),
    lambda o: o.sgd(0.05, momentum=0.9),
    lambda o: o.adamw(1e-2, weight_decay=0.1)], ids=["sgd", "momentum",
                                                     "adamw"])
def test_optimizers_match_reference(make):
    """Same fp32 formulas, one op at a time; XLA may contract a
    multiply-add, so agreement is to 1e-6 relative over three steps."""
    params = _leaves(3)
    jopt, opt = make(joptim), make(optim)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = jopt.init(jp), opt.init(tp)
    for seed in (4, 5, 6):
        grads = _leaves(seed)
        ju, js = jopt.update([jnp.asarray(g) for g in grads], js, jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts = opt.update([torch.from_numpy(g) for g in grads], ts, tp)
        optim.apply_updates(tp, tu)
    assert ts["step"] == int(js["step"]) == 3
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_fused_adamw_is_not_ported_yet():
    """Kept under its old name: ``adamw(use_fused=True)`` no longer
    raises.  On CPU tensors the fused path runs the kernel's plain version,
    launches nothing, and gives the unfused path's bits over three steps
    (the same fp32 operations in the same order)."""
    from repro_torch.kernels import fused_adamw
    params = _leaves(3)
    runs = []
    before = dict(fused_adamw.LAUNCHES)
    for fused in (True, False):
        opt = optim.adamw(1e-2, weight_decay=0.1, use_fused=fused)
        tp = [torch.from_numpy(p.copy()) for p in params]
        st = opt.init(tp)
        for seed in (4, 5, 6):
            u, st = opt.update([torch.from_numpy(g) for g in _leaves(seed)],
                               st, tp)
            optim.apply_updates(tp, u)
        runs.append((tp, st))
    assert fused_adamw.LAUNCHES == before
    (pf, sf), (pu, su) = runs
    for a, b in zip(pf + sf["m"] + sf["v"], pu + su["m"] + su["v"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_two_train_steps_match_reference(group, name):
    """Two steps of reduced MobileNet, batch 8, SGD(0.05, momentum 0.9).

    Run in float64 parameters and images: in fp32 a ReLU input within
    rounding of zero flips and early-layer gradients differ by up to 5%
    in either package (see test_torch_cnn).  The fp32 stages of the step
    (the loss, SGD's momentum, SPIRT's accumulator, MLLess's residual and
    filter) stay fp32 in both, so the same casts happen on values that
    agree to ~1e-12; losses, parameters and the significant fraction agree
    to 1e-6."""
    cfg_j = jget_config("mobilenet-cifar").reduced()
    imgs, labels = cifar_like(64, seed=2)
    rs = np.random.RandomState(0)
    batches = [rs.randint(0, 64, 8) for _ in range(2)]

    with jax.enable_x64(True):
        jmodel = jbuild_cnn(cfg_j)
        tree = jax.tree.map(lambda a: np.asarray(a, np.float64),
                            jmodel.init(jax.random.PRNGKey(0)))

        def loss_fn(params, b):
            logits, _ = jmodel.apply(params, b)
            return jlosses.classification_loss(logits, b["labels"])
        jts = jbuild_train_step(
            jmodel, joptim.sgd(0.05, momentum=0.9), jget_strategy(name),
            jax.make_mesh((1,), ("data",)), data_axes=("data",),
            model_axis=None, loss_fn=loss_fn)
        jstate = jts.init_state(jax.random.PRNGKey(0),
                                dtype_params=jax.tree.map(jnp.asarray, tree))
        jmetrics = []
        for idx in batches:
            jstate, m = jts.step_fn(jstate, {
                "images": jnp.asarray(imgs[idx], jnp.float64),
                "labels": jnp.asarray(labels[idx])})
            jmetrics.append(jax.tree.map(float, m))
        jparams = [np.asarray(p) for p in jax.tree.leaves(jstate["params"])]

    model = cnn.build_cnn(get_config("mobilenet-cifar").reduced(),
                          device="cpu")
    model.load_state_dict(cnn.params_from_reference(tree))
    model = model.double()
    ts = build_train_step(model, optim.sgd(0.05, momentum=0.9),
                          get_strategy(name))
    state = ts.init_state()
    for idx, jm in zip(batches, jmetrics):
        state, m = ts.step_fn(state, {
            "images": torch.from_numpy(imgs[idx]).double(),
            "labels": torch.from_numpy(labels[idx])})
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-6)
    assert state["step"] == 2
    got = jax.tree.leaves(cnn.params_to_reference(model))
    for a, b in zip(got, jparams):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_spirt_accumulates_over_gcd_microbatches(group):
    """B_local=6 with K=4 takes gcd 2 microbatches of 3: the gradient is
    their mean and the reported loss the last microbatch's."""
    model = cnn.build_cnn(get_config("mobilenet-cifar").reduced(),
                          device="cpu")
    imgs, labels = cifar_like(6, seed=3)
    batch = {"images": torch.from_numpy(imgs),
             "labels": torch.from_numpy(labels)}
    params = cnn.reference_leaves(model)
    want_g = [torch.zeros_like(p) for p in params]
    for sl in (slice(0, 3), slice(3, 6)):
        loss = losses.classification_loss(model(batch["images"][sl]),
                                          batch["labels"][sl])
        for a, g in zip(want_g, torch.autograd.grad(loss, params)):
            a.add_(g / 2)
    before = [p.detach().clone() for p in params]
    ts = build_train_step(model, optim.sgd(1.0), get_strategy("spirt"))
    state, m = ts.step_fn(ts.init_state(), batch)
    np.testing.assert_allclose(float(m["loss"]), loss.item(), rtol=1e-6)
    for p, b, g in zip(params, before, want_g):
        np.testing.assert_allclose((b - p.detach()).numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------
def test_train_entry_point_runs_on_cpu():
    res = launch_train.train(arch="mobilenet-cifar", strategy="mlless",
                             steps=3, batch=8, lr=0.05, device="cpu",
                             reduced=True, log=None)
    assert res["params"] == 215_642 and res["world_size"] == 1
    assert len(res["losses"]) == 3 and all(map(math.isfinite,
                                               res["losses"]))
    assert 0 < res["metrics"]["significant_fraction"] <= 1
    assert not dist.is_initialized()


def test_train_entry_point_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.train(arch="mobilenet-cifar", steps=1, reduced=True)
