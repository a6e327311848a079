"""What the serving parity files (``tests/test_torch_serving.py``,
``test_torch_serving_decode.py``, ``test_torch_serve_step.py``) share:
the reduced configurations, the reference's model and parameters beside
the port's, seeded tokens, the reference's jitted prefill and decode, and
the tolerance.

Every comparison starts from the reference's parameters
(``params_from_reference``) and numpy-seeded tokens; fp32 logits agree to
1e-5 of the largest logit (the bar of ``test_torch_transformer.py``) and
cache leaves to 1e-5 of the leaf's largest entry.  pytest does not
collect this module (its name does not start with ``test_``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jget_config
from repro.models.transformer import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.models import transformer

# (arch, reduced() arguments): SmolLM's GLOBAL layers; Gemma-3's 5 LOCAL
# (window 64) + 1 GLOBAL, with a prompt past the window so the local
# rings wrap; RWKV6's recurrent state; Qwen's qkv bias (drawn nonzero
# below); Phi-3; Mixtral's MoE (4 experts, top 2) on LOCAL layers;
# RecurrentGemma's (RG-LRU, RG-LRU, LOCAL) block and a tail of two RG-LRU
# layers; Whisper's encoder, cross-attention and enc_kv cache (biases
# drawn nonzero); Pixtral's 8 stub patches
ARCHS = {"smollm": ("smollm-135m", {}),
         "gemma6": ("gemma3-4b", {"n_layers": 6}),
         "rwkv": ("rwkv6-7b", {}),
         "qwen": ("qwen1.5-4b", {}),
         "phi3": ("phi3-mini-3.8b", {}),
         "mixtral": ("mixtral-8x7b", {}),
         "rglru5": ("recurrentgemma-2b", {"n_layers": 5}),
         "whisper": ("whisper-small", {}),
         "pixtral": ("pixtral-12b", {})}
B, S, CACHE_LEN = 2, 80, 96
TOL = 1e-5


def _reference(name, use_kernel=False, kv_quant=False, seed=0):
    arch, kw = ARCHS[name]
    jcfg, cfg = jget_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    jmodel = jbuild_model(jcfg, use_pallas=use_kernel, remat=False,
                          kv_quant=kv_quant)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    if jcfg.qkv_bias:
        # the init's biases are zero: draw them, so the bias path counts
        _draw_biases(tree, np.random.RandomState(seed + 1))
    model = transformer.Model(cfg, use_kernel=use_kernel, kv_quant=kv_quant)
    model.load_state_dict(transformer.params_from_reference(tree))
    return jmodel, tree, model


def _draw_biases(tree, rs):
    """Every ``bq``/``bk``/``bv`` leaf of the tree drawn from ``rs``."""
    for key in sorted(tree) if isinstance(tree, dict) else range(len(tree)):
        node = tree[key]
        if isinstance(node, (dict, list)):
            _draw_biases(node, rs)
        elif key in ("bq", "bk", "bv"):
            tree[key] = rs.randn(*node.shape).astype(np.float32)


def _batch(cfg, toks):
    """A prompt batch (numpy): the tokens, a VLM's stub patch embeddings
    and an encoder-decoder's stub frames, ``0.1 * randn`` from a fixed
    seed as the reference's tests draw them."""
    rs = np.random.RandomState(7)
    out = {"tokens": toks}
    if cfg.family == "vlm":
        out["patch_emb"] = (0.1 * rs.randn(toks.shape[0], cfg.n_patches,
                                           cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = (0.1 * rs.randn(toks.shape[0], cfg.encoder_seq,
                                        cfg.d_model)).astype(np.float32)
    return out


def _prefill(model, toks, **kw):
    return model.prefill({k: torch.as_tensor(v) for k, v in
                          _batch(model.cfg, toks).items()}, **kw)


def _tokens(cfg, n=S + 8, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, cfg.vocab_size, (B, n)).astype(np.int32)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _close_trees(got_cache, want_cache, tol=TOL):
    got = transformer.cache_to_reference(got_cache)
    want = jax.tree.map(np.asarray, want_cache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        _close(a, b, tol)


def _jprefill(jmodel, tree, toks, cache_len=CACHE_LEN, swa_variant=False):
    return jax.jit(lambda p, b: jmodel.prefill(
        p, b, cache_len=cache_len, swa_variant=swa_variant))(
        tree, jax.tree.map(jnp.asarray, _batch(jmodel.cfg, toks)))


def _jdecode(jmodel, tree, tok, cache, pos, swa_variant=False):
    return jax.jit(lambda p, t, c, i: jmodel.decode_step(
        p, t, c, i, swa_variant=swa_variant))(
        tree, jnp.asarray(tok), cache, jnp.asarray(pos, jnp.int32))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree
