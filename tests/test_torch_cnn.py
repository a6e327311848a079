"""Parity of the port's CNN path with the JAX reference on the CPU:
configs, synthetic data, models (logits and gradients), the parameter
bridge and the classification loss, at reduced width (0.25)."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.data import cifar_like as jcifar_like  # noqa: E402
from repro.models.cnn import build_cnn as jbuild_cnn  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.data import cifar_like  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

ARCHS = ["mobilenet-cifar", "resnet18-cifar"]


def _reference(arch, seed=0):
    cfg = jget_config(arch).reduced()
    model = jbuild_cnn(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    return model, jax.tree.map(np.asarray, params)


def _port(arch, tree):
    model = cnn.build_cnn(get_config(arch).reduced(), device="cpu")
    model.load_state_dict(cnn.params_from_reference(tree))
    return model


def test_configs_match_reference():
    for arch in ARCHS:
        assert (get_config(arch).reduced().width_mult
                == jget_config(arch).reduced().width_mult == 0.25)
        assert get_config(arch).kind == jget_config(arch).kind


def test_cifar_like_is_byte_identical():
    a = cifar_like(37, seed=5)
    b = jcifar_like(37, seed=5)
    assert a[0].tobytes() == b[0].tobytes()
    assert a[1].tobytes() == b[1].tobytes()


@pytest.mark.parametrize("arch,n_params,n_leaves", [
    ("mobilenet-cifar", 3_217_226, 83), ("resnet18-cifar", 11_173_962, 62)])
def test_full_width_parameter_counts(arch, n_params, n_leaves):
    """The full-width models match the reference's tree leaf for leaf."""
    model = cnn.build_cnn(get_config(arch), device="cpu")
    leaves = cnn.reference_leaves(model)
    ref = jax.eval_shape(jbuild_cnn(jget_config(arch)).init,
                         jax.random.PRNGKey(0))
    ref_leaves = jax.tree.leaves(ref)
    assert len(leaves) == len(ref_leaves) == n_leaves
    assert sum(p.numel() for p in leaves) == n_params
    for p, r in zip(leaves, ref_leaves):
        assert tuple(p.shape) == tuple(r.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_bridge_round_trips(arch):
    _, tree = _reference(arch, seed=3)
    back = cnn.params_to_reference(_port(arch, tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,k,s", [(32, 3, 2), (16, 3, 1), (15, 3, 2),
                                   (8, 1, 2)])
def test_conv_same_matches_jax_same_padding(n, k, s):
    """JAX "SAME" pads the odd pixel at the end ((0, 1) for a stride-2
    3x3 conv on an even input); fp32 convs of 36 products agree to 1e-5."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, n, n, 4).astype(np.float32)
    w = rs.randn(k, k, 4, 6).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = cnn.conv_same(torch.from_numpy(x).permute(0, 3, 1, 2),
                        torch.from_numpy(w), s)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_grads_match_reference(arch):
    """Same params and images through both packages.

    Logits in fp32 agree to 1e-4 and the loss to 1e-5: different conv
    and reduction orders over ~20 GroupNorm layers.  Gradients are
    compared in float64: in fp32 a ReLU input within rounding of zero
    can flip, and the early layers' gradients of the randomly
    initialised nets then differ by up to 5% in either package against
    a float64 run.  In float64 only the loss's fp32 cast of the logits
    rounds, and every leaf agrees to 1e-5 of its largest entry."""
    jmodel, tree = _reference(arch)
    imgs, labels = cifar_like(8, seed=1)

    def jloss(p, x):
        logits, _ = jmodel.apply(p, {"images": x})
        return jlosses.classification_loss(logits, jnp.asarray(labels)), \
            logits

    jl, jlogits = jax.jit(jloss)(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(imgs))
    model = _port(arch, tree)
    logits = model(torch.from_numpy(imgs))
    loss = losses.classification_loss(logits, torch.from_numpy(labels))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)

    with jax.enable_x64(True):
        tree64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        jgrads = jax.jit(jax.grad(lambda p: jloss(p, jnp.asarray(
            imgs, jnp.float64))[0]))(tree64)
        jleaves = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    model = model.double()
    loss = losses.classification_loss(
        model(torch.from_numpy(imgs).double()), torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, cnn.reference_leaves(model))
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        assert g.dtype == torch.float64 and jg.dtype == np.float64
        scale = max(float(np.abs(jg).max()), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, jg / scale,
                                   atol=1e-5)


def test_classification_loss_and_accuracy_match_reference():
    """Same fp32 formula (logsumexp minus the gold logit); bf16 logits
    are upcast first in both.  Agreement to 1e-6 relative."""
    rs = np.random.RandomState(2)
    labels = rs.randint(0, 10, 64).astype(np.int32)
    for dtype, tdtype in [(jnp.float32, torch.float32),
                          (jnp.bfloat16, torch.bfloat16)]:
        logits = (rs.randn(64, 10) * 4).astype(np.float32)
        want = jlosses.classification_loss(
            jnp.asarray(logits, dtype), jnp.asarray(labels))
        got = losses.classification_loss(
            torch.from_numpy(logits).to(tdtype), torch.from_numpy(labels))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    acc = losses.accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    jacc = jlosses.accuracy(jnp.asarray(logits), jnp.asarray(labels))
    assert float(acc) == float(jacc)


def test_build_cnn_is_seeded_and_refuses_missing_cuda():
    cfg = get_config("mobilenet-cifar").reduced()
    a = cnn.params_to_reference(cnn.build_cnn(cfg, device="cpu", seed=4))
    b = cnn.params_to_reference(cnn.build_cnn(cfg, device="cpu", seed=4))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cnn.build_cnn(cfg)
