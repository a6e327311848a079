"""Parity of the port's MoE, RG-LRU, encoder-decoder and VLM families with
the JAX reference on the CPU, at reduced width (fp32, ``cfg.reduced()``):
Mixtral 8x7B and 8x22B (4 experts, top 2, LOCAL attention), RecurrentGemma
at 5 layers (one (RG-LRU, RG-LRU, LOCAL) block and a tail of two RG-LRU
layers), Whisper-small (2 encoder and 2 decoder layers over 32 stub
frames) and Pixtral (8 stub patches).  Parameters come from the
reference's ``init``, inputs from numpy seeds.

The forward's logits and aux loss against ``Model.apply``, two train
steps through the reference's ``build_train_step`` on a one-device
pure-DP mesh (the port on its kernels' paths, whose plain versions the
CPU runs), decode at per-row positions, the continuous-
batching engine on RecurrentGemma token for token, the loader byte for
byte, and the two entry points on the CPU.  Prefill, decode and the cache
of every family are in ``test_torch_serving.py``."""
import math

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import build_train_step as jbuild_train_step  # noqa: E402
from repro.core import get_strategy as jget_strategy  # noqa: E402
from repro.data import WorkerShards as JWorkerShards  # noqa: E402
from repro.data import global_batch_iter as jglobal_batch_iter  # noqa: E402
from repro.models.transformer import build_model as jbuild_model  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import build_train_step, get_strategy  # noqa: E402
from repro_torch.data import (WorkerShards, cifar_like,  # noqa: E402
                              global_batch_iter, lm_batches, token_stream)
from repro_torch.kernels import fused_adamw, swa_attention  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

# (arch, reduced() arguments, leaves)
ARCHS = {"mixtral": ("mixtral-8x7b", {}, 13),
         "mixtral22": ("mixtral-8x22b", {}, 13),
         "rglru5": ("recurrentgemma-2b", {"n_layers": 5}, 30 + 22 + 3),
         "whisper": ("whisper-small", {}, 34),
         "pixtral": ("pixtral-12b", {}, 12)}
TOL = 1e-5


def _reference(name, remat=True, seed=0):
    """The reference's model and parameters, and the port's model on them
    with the kernels' paths (their plain versions on the CPU; the
    reference's Pallas paths are held against them in
    ``test_torch_transformer.py`` and ``test_torch_lm_kernels.py``)."""
    arch, kw, _ = ARCHS[name]
    jcfg, cfg = jget_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    jmodel = jbuild_model(jcfg, remat=remat)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    model = transformer.Model(cfg, use_kernel=True, remat=remat)
    model.load_state_dict(transformer.params_from_reference(tree))
    return jmodel, tree, model


def _batches(cfg, n, B=2, S=32):
    it = lm_batches(token_stream(B * S * 64, cfg.vocab_size), B, S)
    rs = np.random.RandomState(0)
    return [{**next(it), **launch_train.stub_inputs(cfg, B, rs)}
            for _ in range(n)]


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_matches_reference(name):
    """Logits to 1e-5 of the largest (the bar of
    ``test_torch_transformer.py``), the aux loss to 1e-5 relative (the MoE
    layers' load-balance loss summed; 0 elsewhere)."""
    jmodel, tree, model = _reference(name)
    b = _batches(model.cfg, 1)[0]
    want, jaux = jax.jit(jmodel.apply)(tree, jax.tree.map(jnp.asarray, b))
    with torch.no_grad():
        got, aux = model(_t(b))
    assert got.shape == want.shape == (2, 32, model.padded_vocab)
    _close(got.numpy(), want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL)
    assert (float(aux) > 0) == model.cfg.is_moe


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
    return [np.array(x.detach() if isinstance(x, torch.Tensor) else x)
            for x in xs]


def _leaf_names(tree):
    return [jax.tree_util.keystr(path) for path, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _key_biases(tree):
    """Leaf-order flags of the key biases (``bk``): their gradient is zero
    in exact arithmetic (a bias on k shifts every score of a query by the
    same amount), so both sides' moments are fp32 noise there."""
    return [name.endswith("['bk']") for name in _leaf_names(tree)]


def _moment_tol(name):
    cross_scores = ("['norm_x']", "['xattn']['bq']", "['xattn']['wq']",
                    "['xattn']['wk']")
    return 4e-5 if name.endswith(cross_scores) else TOL


# mixtral-8x22b runs the layers of mixtral-8x7b at other widths: its
# forward and serving are held, its train step is 8x7b's
@pytest.mark.parametrize("name", ["mixtral", "pixtral", "rglru5", "whisper"])
def test_two_train_steps_match_reference(group, name):
    """Batch 2 x seq 32 (with the stub frames and patches), AdamW(3e-3),
    two all-reduce steps from the reference's parameters, the port
    through its fused AdamW's and attention kernel's paths (the plain
    versions on the CPU).  Losses (the aux
    loss included) to 1e-5; after the first step the moments to 1e-5 of
    each leaf's largest value and the parameters as
    ``tests/test_torch_transformer.py`` holds them (where |m| is at least
    1% of the leaf's largest, and everywhere within 2 lr a step).

    Two kinds of leaf have gradients that are small remainders of larger
    terms that cancel, so they carry those terms' rounding.  The key
    biases' gradient is zero in exact arithmetic: their moments are held
    to 1e-7 of the model's largest moment, and their parameters to the
    2 lr bound alone (``_key_biases``).  Whisper's cross-attention scores
    over 32 stub frames are nearly uniform, so the gradients on their q
    and k side (``norm_x``, ``xattn.{bq,wq,wk}``) sit 1.2e-5 to 1.8e-5 of
    the leaf's largest from the float64 gradient on both sides (the port
    and the reference in fp32, each against the port in float64): their
    moments are held to 4e-5."""
    jmodel, tree, model = _reference(name)
    batches = _batches(model.cfg, 2)
    lr = 3e-3
    jts = jbuild_train_step(
        jmodel, joptim.adamw(lr), jget_strategy("allreduce"),
        jax.make_mesh((1,), ("data",)), data_axes=("data",),
        model_axis=None)
    jstate = jts.init_state(jax.random.PRNGKey(0),
                            dtype_params=jax.tree.map(jnp.asarray, tree))
    jmetrics, jsnap = [], []
    for b in batches:
        jstate, m = jts.step_fn(jstate, jax.tree.map(jnp.asarray, b))
        jmetrics.append(jax.tree.map(float, m))
        jsnap.append([_leaves_np(jax.tree.leaves(jstate["params"]))] + [
            _leaves_np(jax.tree.leaves(jstate["opt"][k])) for k in "mv"])

    ts = build_train_step(model, optim.adamw(lr, use_fused=True),
                          get_strategy("allreduce"))
    state = ts.init_state()
    before = (dict(fused_adamw.LAUNCHES), dict(swa_attention.LAUNCHES))
    snap = []
    for b, jm in zip(batches, jmetrics):
        state, m = ts.step_fn(state, _t(b))
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=TOL)
        snap.append([_leaves_np(state["params"])] + [
            _leaves_np(state["opt"][k]) for k in "mv"])
    assert (fused_adamw.LAUNCHES, swa_attention.LAUNCHES) == before

    (p1, m1, v1), (jp1, jm1, jv1) = snap[0], jsnap[0]
    assert len(p1) == len(jp1) == ARCHS[name][2]
    names, bks = _leaf_names(tree), _key_biases(tree)
    for got_all, want_all in ((m1, jm1), (v1, jv1)):
        largest = max(np.abs(w).max() for w in want_all)
        for got, want, name, bk in zip(got_all, want_all, names, bks):
            tol = _moment_tol(name)
            np.testing.assert_allclose(
                got, want, rtol=tol, atol=1e-7 * largest if bk
                else tol * np.abs(want).max())
    for got, want, mw, bk in zip(p1, jp1, jm1, bks):
        assert np.abs(got - want).max() <= 2 * lr
        if bk:
            continue
        sure = np.abs(mw) >= 1e-2 * np.abs(mw).max()
        np.testing.assert_allclose(got[sure], want[sure], rtol=TOL,
                                   atol=TOL * np.abs(want).max())
    for step, ((p, _, _), (jp, _, _)) in enumerate(zip(snap, jsnap), 1):
        for got, want in zip(p, jp):
            assert np.abs(got - want).max() <= 2 * lr * step


# ---------------------------------------------------------------------------
# serving beyond prefill: per-row positions, the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mixtral", "rglru5", "whisper"])
def test_per_row_decode_matches_reference(name):
    """A prefill of 40 into a context of 96, then three decode steps at
    per-row positions (as the engine decodes; Whisper's sinusoidal
    position per row, RecurrentGemma's states and 64-slot rings past
    their wrap), logits and the whole cache to 1e-5."""
    jmodel, tree, model = _reference(name, remat=False)
    cfg = model.cfg
    rs = np.random.RandomState(4)
    toks = rs.randint(0, cfg.vocab_size, (2, 43)).astype(np.int32)
    b = {"tokens": toks[:, :40], **launch_train.stub_inputs(cfg, 2, rs)}
    jlogits, jcache = jax.jit(lambda p, x: jmodel.prefill(
        p, x, cache_len=96))(tree, jax.tree.map(jnp.asarray, b))
    logits, cache = model.prefill(_t(b), cache_len=96)
    _close(logits, jlogits)
    for i in range(3):
        pos = np.array([40 + i, 60 + 7 * i], np.int32)
        tok = toks[:, 40 + i:41 + i]
        jlogits, jcache = jax.jit(jmodel.decode_step)(
            tree, jnp.asarray(tok), jcache, jnp.asarray(pos))
        logits, cache = model.decode_step(torch.from_numpy(tok), cache,
                                          torch.from_numpy(pos))
        _close(logits, jlogits)
    got = transformer.cache_to_reference(cache)
    want = jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == w.dtype
        _close(a, w)


def test_engine_on_recurrentgemma_matches_reference_engine():
    """Three requests over two slots (prompts past the window of 64, so
    the local rings wrap; each admission copies RG-LRU states into a
    slot): the reference engine's tokens exactly."""
    jmodel, tree, model = _reference("rglru5", remat=False)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (70, 12, 90)]
    jeng = JServingEngine(jmodel, tree, batch_size=2, cache_len=128)
    eng = ServingEngine(model, batch_size=2, cache_len=128)
    for p, n in zip(prompts, (4, 3, 5)):
        jeng.submit(p, n)
        eng.submit(p, n)
    assert eng.run() == jeng.run()


def test_engine_scatters_enc_kv_at_the_batch_dim():
    """A Whisper cache's enc_kv leaves are (n_layers, B, ...): the engine
    writes a request's row at dim 1, as under blocks."""
    from repro_torch.serving.engine import _batch_dim, _scatter_request
    model = transformer.Model(get_config("whisper-small").reduced())
    full = model.init_cache(3, 16)
    one = model.init_cache(1, 16)
    for leaf in (one["enc_kv"]["k"], one["enc_kv"]["v"]):
        leaf.fill_(1.0)
    assert _batch_dim(("enc_kv", "k")) == _batch_dim(("blocks", 0, "k")) \
        == 1
    _scatter_request(full, one, 2)
    for leaf in full["enc_kv"].values():
        assert leaf.shape[1] == 3
        assert bool((leaf[:, 2] == 1).all()) and not bool(leaf[:, :2].any())


def test_short_vlm_prompt_raises():
    """A prompt shorter than its patch embeddings: the reference would make
    the sequence n_patches long, out of step with positions and cache
    slots; the port refuses it."""
    model = transformer.Model(get_config("pixtral-12b").reduced())
    cfg = model.cfg
    batch = {"tokens": torch.zeros((1, cfg.n_patches - 1), dtype=torch.int32),
             "patch_emb": torch.zeros((1, cfg.n_patches, cfg.d_model))}
    with pytest.raises(ValueError, match="patch embeddings"):
        model.prefill(batch)
    with pytest.raises(ValueError, match="patch embeddings"):
        model(batch)


# ---------------------------------------------------------------------------
# the loader, the entry points
# ---------------------------------------------------------------------------
def test_loader_is_byte_identical():
    imgs, labels = cifar_like(300, seed=2)
    a, b = WorkerShards(imgs, labels, 4, 16), \
        JWorkerShards(imgs, labels, 4, 16)
    assert a.batches_per_worker == b.batches_per_worker == 4
    for epoch in (0, 3):
        for wa, wb in zip(a.epoch(epoch), b.epoch(epoch)):
            for x, y in zip(wa, wb):
                for k in ("images", "labels"):
                    assert x[k].tobytes() == y[k].tobytes()
        got = list(global_batch_iter(a, epoch))
        want = list(jglobal_batch_iter(b, epoch))
        assert len(got) == len(want) == 4
        for x, y in zip(got, want):
            for k in ("images", "labels"):
                assert x[k].dtype == y[k].dtype
                assert x[k].tobytes() == y[k].tobytes()


@pytest.mark.parametrize("arch", ["whisper-small", "pixtral-12b"])
def test_entry_points_run_on_the_cpu(arch):
    lines = []
    res = launch_serve.serve(arch=arch, reduced=True, device="cpu", batch=2,
                             prompt_len=16, decode_tokens=3,
                             log=lines.append)
    assert res["tokens"].shape == (2, 4) and res["device"] == "cpu"
    assert lines[0].startswith("prefill 2x16")
    res = launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq", "16",
                             "--fused-optimizer"])
    assert res["arch"] == arch and len(res["losses"]) == 2
    assert all(map(math.isfinite, res["losses"]))
    assert not dist.is_initialized()
