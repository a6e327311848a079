"""Parity of the port's dense transformer LM with the JAX reference on the
CPU: the parameter bridge, forward logits with and without the attention
kernel's path, and three train steps through the reference's
``build_train_step`` on a one-device pure-DP mesh (``("data",)``,
``model_axis=None``), the JAX side running its Pallas kernels in
interpret mode."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs.base import all_arch_names as jall_arch_names  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import build_train_step as jbuild_train_step  # noqa: E402
from repro.core import get_strategy as jget_strategy  # noqa: E402
from repro.data import lm_batches as jlm_batches  # noqa: E402
from repro.data import token_stream as jtoken_stream  # noqa: E402
from repro.models.transformer import build_model as jbuild_model  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, all_arch_names  # noqa: E402
from repro_torch.core import build_train_step, get_strategy, losses  # noqa: E402
from repro_torch.data import lm_batches, token_stream  # noqa: E402
from repro_torch.kernels import fused_adamw, swa_attention  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

# (arch, reduced() arguments): SmolLM's GLOBAL layers; Gemma-3's 5 LOCAL
# (window 64 after reduced()) + 1 GLOBAL with GELU; Qwen's qkv bias;
# RWKV6's time-mix layers; Mixtral's fp32 router and experts;
# RecurrentGemma's RG-LRU blocks and tail; Whisper's encoder dict and
# cross-attention; Pixtral
ARCHS = {"smollm": ("smollm-135m", {}),
         "gemma6": ("gemma3-4b", {"n_layers": 6}),
         "qwen": ("qwen1.5-4b", {}),
         "rwkv": ("rwkv6-7b", {}),
         "mixtral": ("mixtral-8x7b", {}),
         "rglru5": ("recurrentgemma-2b", {"n_layers": 5}),
         "whisper": ("whisper-small", {}),
         "pixtral": ("pixtral-12b", {})}


def _configs(name):
    arch, kw = ARCHS[name]
    return jget_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _reference(name, use_pallas=False, seed=0):
    jcfg, cfg = _configs(name)
    jmodel = jbuild_model(jcfg, use_pallas=use_pallas)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    return jmodel, tree, cfg


def _port(cfg, tree, use_kernel=False):
    model = transformer.Model(cfg, use_kernel=use_kernel)
    model.load_state_dict(transformer.params_from_reference(tree))
    return model


def test_arch_names_match_reference():
    """The port registers the reference's architectures, CNNs included."""
    assert all_arch_names() == jall_arch_names()


def test_configs_match_reference():
    """Every LM config the port registers, and its ``reduced()``, the
    reference's."""
    lms = [n for n in all_arch_names() if get_config(n).family != "cnn"]
    assert len(lms) == 10
    for arch in lms:
        a, b = get_config(arch), jget_config(arch)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert dataclasses.asdict(a.reduced(n_layers=6)) == \
            dataclasses.asdict(b.reduced(n_layers=6))


def test_token_stream_and_batches_are_byte_identical():
    a, b = token_stream(5000, 512, seed=3), jtoken_stream(5000, 512, seed=3)
    assert a.tobytes() == b.tobytes()
    for x, y in zip(lm_batches(a, 4, 64, seed=1), jlm_batches(b, 4, 64,
                                                              seed=1)):
        assert x["tokens"].tobytes() == y["tokens"].tobytes()
        assert x["labels"].tobytes() == y["labels"].tobytes()
        break


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_params_bridge_round_trips(name):
    _, tree, cfg = _reference(name, seed=2)
    back = transformer.params_to_reference(_port(cfg, tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,n_leaves", [("smollm-135m", 12),
                                           ("gemma3-4b", 8 * 6 + 8 * 4 + 3),
                                           ("rwkv6-7b", 17),
                                           ("mixtral-8x7b", 13),
                                           ("mixtral-8x22b", 13),
                                           ("recurrentgemma-2b", 55),
                                           ("whisper-small", 34),
                                           ("pixtral-12b", 12)])
def test_leaves_match_the_reference_tree(arch, n_leaves):
    """Leaf for leaf in the reference's order, stacked (n_blocks, in, out)
    and tail layers alike (Gemma-3: 5 blocks of 6 and a tail of 4; RWKV6:
    one stacked block of 32 time-mix layers; Mixtral: the fp32 router and
    (E, d, f) experts; RecurrentGemma: 8 blocks of (RG-LRU, RG-LRU, LOCAL)
    and a tail of two RG-LRU layers; Whisper: the decoder's cross-attention
    and the encoder's stacked dict)."""
    cfg = get_config(arch)
    small = dataclasses.replace(cfg, d_model=64, n_heads=2, n_kv_heads=1,
                                head_dim=32, d_ff=96, vocab_size=300)
    jsmall = dataclasses.replace(jget_config(arch), d_model=64, n_heads=2,
                                 n_kv_heads=1, head_dim=32, d_ff=96,
                                 vocab_size=300)
    leaves = transformer.reference_leaves(transformer.Model(small))
    ref = jax.tree.leaves(jax.eval_shape(jbuild_model(jsmall).init,
                                         jax.random.PRNGKey(0)))
    assert len(leaves) == len(ref) == n_leaves
    for p, r in zip(leaves, ref):
        assert tuple(p.shape) == tuple(r.shape)
        assert str(p.dtype).split(".")[-1] == str(r.dtype)


def test_init_redraws_from_a_seed():
    cfg = get_config("smollm-135m").reduced()
    want = transformer.build_model(cfg, device="cpu", seed=5)
    got = transformer.Model(cfg).init(seed=5)
    for a, b in zip(got.parameters(), want.parameters()):
        assert torch.equal(a, b)
    assert not torch.equal(transformer.Model(cfg).embed.table,
                           want.embed.table)


def test_smollm_full_width_has_162m_parameters_in_12_leaves():
    model = transformer.Model(get_config("smollm-135m"))
    leaves = transformer.reference_leaves(model)
    assert len(leaves) == 12
    assert sum(p.numel() for p in leaves) == 162_826_560
    assert model.padded_vocab == 49152
    assert transformer.Model(get_config("phi3-mini-3.8b").reduced(
        vocab=32064)).padded_vocab == 32128


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ["smollm", "gemma6"])
def test_logits_match_reference(name, use_kernel):
    """fp32 logits at seq 128 (the window of 64 masks): kernel path (the
    plain attention on the CPU) against ``Model(use_pallas=True)``, and
    the chunked path against the reference's, to 1e-5 of the largest
    logit."""
    jmodel, tree, cfg = _reference(name, use_pallas=use_kernel)
    b = next(lm_batches(token_stream(2 * 128 * 8, cfg.vocab_size), 2, 128))
    want, _ = jmodel.apply(tree, {"tokens": jnp.asarray(b["tokens"])})
    want = np.asarray(want)
    model = _port(cfg, tree, use_kernel=use_kernel)
    with torch.no_grad():
        got, aux = model({"tokens": torch.from_numpy(b["tokens"])})
    assert got.shape == want.shape == (2, 128, 512) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_loss_matches_reference():
    from repro.core import losses as jlosses
    rs = np.random.RandomState(0)
    logits = rs.randn(2, 8, 40).astype(np.float32) * 3
    labels = rs.randint(0, 40, size=(2, 8)).astype(np.int32)
    np.testing.assert_allclose(
        float(losses.softmax_cross_entropy(torch.from_numpy(logits),
                                           torch.from_numpy(labels))),
        float(jlosses.softmax_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(labels))),
        rtol=1e-6)


def test_unknown_layer_kind_raises():
    """A layer kind outside GLOBAL, LOCAL, RGLRU and RWKV raises
    ``ValueError(kind)``, as the reference's ``_layer_init`` does."""
    base = get_config("smollm-135m").reduced()
    assert isinstance(base, ModelConfig)
    cfg = dataclasses.replace(base, layer_pattern=("mamba",))
    with pytest.raises(ValueError, match="mamba"):
        transformer.Model(cfg)
    with pytest.raises(ValueError, match="mamba"):
        jbuild_model(dataclasses.replace(
            jget_config("smollm-135m").reduced(),
            layer_pattern=("mamba",))).init(jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------
@pytest.fixture
def group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    yield None
    dist.destroy_process_group()


def _leaves_np(xs):
    """Copies: the port updates parameters and moments in place."""
    return [np.array(x.detach() if isinstance(x, torch.Tensor) else x)
            for x in xs]


@pytest.mark.parametrize("strategy,fused", [
    ("allreduce", False), ("spirt", True), ("mlless", True)])
def test_three_train_steps_match_reference(group, strategy, fused):
    """Reduced SmolLM, batch 4 x seq 64 from the same ``lm_batches``,
    AdamW(3e-3), three steps on one rank from the reference's parameters:
    the port with the kernels' paths (plain versions on the CPU) against
    the reference with ``use_pallas=True`` and its Pallas AdamW when
    ``fused``.  SPIRT accumulates K = 4 microbatches of one sequence;
    MLLess filters each of the 12 leaves.

    fp32.  The losses of all three steps agree to 1e-5, and after the
    first step the moments (linear in the synced gradient) to 1e-5 of each
    leaf's largest value.  AdamW's first update is -lr * g / (|g| + eps):
    where a gradient element lies within fp32 noise (~1e-6 of the leaf's
    largest) of zero its sign, and the update, are undetermined, and the
    moved element changes the later steps.  So the parameters agree to
    1e-5 of the leaf's largest value after the first step wherever |m|
    is at least 1% of the leaf's largest |m|, and everywhere within the
    update bound (2 lr a step).  Float64 does not condition this: the
    reference keeps the loss, norms, rotary embedding, attention and
    moments in fp32."""
    jmodel, tree, cfg = _reference("smollm", use_pallas=True)
    it = lm_batches(token_stream(4 * 64 * 64, cfg.vocab_size), 4, 64)
    batches = [next(it) for _ in range(3)]
    lr = 3e-3

    jts = jbuild_train_step(
        jmodel, joptim.adamw(lr, use_fused=fused), jget_strategy(strategy),
        jax.make_mesh((1,), ("data",)), data_axes=("data",),
        model_axis=None)
    jstate = jts.init_state(jax.random.PRNGKey(0),
                            dtype_params=jax.tree.map(jnp.asarray, tree))
    jmetrics, jsnap = [], []
    for b in batches:
        jstate, m = jts.step_fn(jstate, jax.tree.map(jnp.asarray, b))
        jmetrics.append(jax.tree.map(float, m))
        jsnap.append([_leaves_np(jax.tree.leaves(jstate[k]))
                      for k in ("params",)] + [
            _leaves_np(jax.tree.leaves(jstate["opt"][k])) for k in "mv"])

    model = _port(cfg, tree, use_kernel=True)
    ts = build_train_step(model, optim.adamw(lr, use_fused=fused),
                          get_strategy(strategy))
    state = ts.init_state()
    before = (dict(fused_adamw.LAUNCHES), dict(swa_attention.LAUNCHES))
    snap = []
    for b, jm in zip(batches, jmetrics):
        state, m = ts.step_fn(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-5)
        snap.append([_leaves_np(state["params"])] + [
            _leaves_np(state["opt"][k]) for k in "mv"])
    assert (fused_adamw.LAUNCHES, swa_attention.LAUNCHES) == before
    assert state["step"] == 3

    (p1, m1, v1), (jp1, jm1, jv1) = snap[0], jsnap[0]
    assert len(p1) == len(jp1) == 12
    for got, want in zip(m1 + v1, jm1 + jv1):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    for got, want, mw in zip(p1, jp1, jm1):
        sure = np.abs(mw) >= 1e-2 * np.abs(mw).max()
        np.testing.assert_allclose(got[sure], want[sure], rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        assert np.abs(got - want).max() <= 2 * lr
    for step, ((p, _, _), (jp, _, _)) in enumerate(zip(snap, jsnap), 1):
        for got, want in zip(p, jp):
            assert np.abs(got - want).max() <= 2 * lr * step


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------
def test_lm_entry_point_runs_on_cpu():
    res = launch_train.train(arch="smollm-135m", strategy="spirt", steps=3,
                             batch=4, seq=32, fused_optimizer=True,
                             device="cpu", reduced=True, log=None)
    assert res["params"] == 1_377_536 and res["world_size"] == 1
    assert len(res["losses"]) == 3 and all(map(math.isfinite,
                                               res["losses"]))
    assert not dist.is_initialized()


def test_lm_entry_point_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.train(arch="smollm-135m", steps=1, reduced=True)
