"""Parity of the port's serving path with the JAX reference on the CPU:
prefill (logits and the whole cache tree) and single-token decode for the
dense, sliding-window, RWKV, MoE, RG-LRU, encoder-decoder and VLM
families, both attention paths (the
reference's Pallas kernel in interpret mode against the port's kernel
wrapper, which takes its plain version on the CPU), sequential decode,
per-slot positions, the sliding-window variant, the int8 KV cache, the
cache bridge and the serve step's meta inputs.

Every comparison starts from the reference's parameters
(``params_from_reference``) and numpy-seeded tokens; fp32 logits agree to
1e-5 of the largest logit (the bar of ``test_torch_transformer.py``) and
cache leaves to 1e-5 of the leaf's largest entry."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import INPUT_SHAPES as JINPUT_SHAPES  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import build_serve_step as jbuild_serve_step  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import kvquant as jkvquant  # noqa: E402
from repro.models.transformer import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.core import build_serve_step  # noqa: E402
from repro_torch.kernels import swa_attention as tswa  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention, kvquant, transformer  # noqa: E402

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


# ---------------------------------------------------------------------------
# prefill + decode, per layer kind
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_and_decode_match_reference(name, use_kernel):
    """Last-token logits and every cache leaf after a prefill of 80 tokens
    into a context of 96, then one decode step's logits and cache."""
    jmodel, tree, model = _reference(name, use_kernel)
    toks = _tokens(model.cfg)
    jlogits, jcache = _jprefill(jmodel, tree, toks[:, :S])
    before = dict(tswa.LAUNCHES)
    logits, cache = _prefill(model, toks[:, :S], cache_len=CACHE_LEN)
    assert tswa.LAUNCHES == before      # the CPU runs the plain version
    assert logits.shape == (B, 1, model.padded_vocab)
    _close(logits, jlogits)
    _close_trees(cache, jcache)

    jlogits, jcache = _jdecode(jmodel, tree, toks[:, S:S + 1], jcache, S)
    logits, cache = model.decode_step(torch.as_tensor(toks[:, S:S + 1]),
                                      cache, S)
    _close(logits, jlogits)
    _close_trees(cache, jcache)


@pytest.mark.parametrize("name", ["smollm", "gemma6", "rwkv"])
def test_sequential_decode_matches_reference(name):
    """Eight decode steps in a row after the prefill, the gemma local
    rings wrapping further; logits at every step."""
    jmodel, tree, model = _reference(name)
    toks = _tokens(model.cfg)
    _, jcache = _jprefill(jmodel, tree, toks[:, :S])
    _, cache = model.prefill({"tokens": torch.as_tensor(toks[:, :S])},
                             cache_len=CACHE_LEN)
    for i in range(8):
        tok = toks[:, S + i:S + i + 1]
        jlogits, jcache = _jdecode(jmodel, tree, tok, jcache, S + i)
        logits, cache = model.decode_step(torch.as_tensor(tok), cache,
                                          torch.tensor(S + i))
        _close(logits, jlogits)
    _close_trees(cache, jcache)


@pytest.mark.parametrize("name", ["smollm", "gemma6", "rwkv"])
def test_per_slot_positions_match_reference(name):
    """(B,) positions, as the engine decodes: each row writes its own ring
    slot and masks at its own position (one past the prompt, and ten
    positions on, past the wrap of gemma's 64-slot rings)."""
    jmodel, tree, model = _reference(name)
    toks = _tokens(model.cfg)
    _, jcache = _jprefill(jmodel, tree, toks[:, :S])
    _, cache = model.prefill({"tokens": torch.as_tensor(toks[:, :S])},
                             cache_len=CACHE_LEN)
    pos = np.array([S, S + 10], np.int32)
    jlogits, jcache = _jdecode(jmodel, tree, toks[:, S:S + 1], jcache, pos)
    logits, cache = model.decode_step(torch.as_tensor(toks[:, S:S + 1]),
                                      cache, torch.as_tensor(pos))
    _close(logits, jlogits)
    _close_trees(cache, jcache)


def test_swa_variant_matches_reference():
    """The long-context variant: every GLOBAL layer becomes LOCAL (window
    64 < the prompt), in prefill and decode."""
    jmodel, tree, model = _reference("smollm")
    toks = _tokens(model.cfg)
    jlogits, jcache = _jprefill(jmodel, tree, toks[:, :S], swa_variant=True)
    logits, cache = model.prefill({"tokens": torch.as_tensor(toks[:, :S])},
                                  cache_len=CACHE_LEN, swa_variant=True)
    assert cache["blocks"][0]["k"].shape[2] == model.cfg.window
    _close(logits, jlogits)
    _close_trees(cache, jcache)
    jlogits, _ = _jdecode(jmodel, tree, toks[:, S:S + 1], jcache, S,
                          swa_variant=True)
    logits, _ = model.decode_step(torch.as_tensor(toks[:, S:S + 1]), cache,
                                  S, swa_variant=True)
    _close(logits, jlogits)


def test_prompt_shorter_than_the_cache_and_one_token():
    """A prompt of 1 token and one of 5 into a 96-slot cache: the unfilled
    slots stay zero and are masked."""
    jmodel, tree, model = _reference("gemma6")
    for n in (1, 5):
        toks = _tokens(model.cfg, n + 1, seed=n)
        jlogits, jcache = _jprefill(jmodel, tree, toks[:, :n])
        logits, cache = model.prefill({"tokens": torch.as_tensor(
            toks[:, :n])}, cache_len=CACHE_LEN)
        _close(logits, jlogits)
        _close_trees(cache, jcache)
        jlogits, _ = _jdecode(jmodel, tree, toks[:, n:], jcache, n)
        logits, _ = model.decode_step(torch.as_tensor(toks[:, n:]), cache, n)
        _close(logits, jlogits)


def test_decode_writes_the_cache_in_place():
    """decode_step writes one slot a layer into the tensors it was given
    (no copy of the cache), and returns the same tree."""
    _, _, model = _reference("gemma6")
    toks = _tokens(model.cfg)
    _, cache = model.prefill({"tokens": torch.as_tensor(toks[:, :S])},
                             cache_len=CACHE_LEN)
    leaves = [t for _, t in _flat(cache)]
    ptrs = [t.data_ptr() for t in leaves]
    before = [t.clone() for t in leaves]
    _, out = model.decode_step(torch.as_tensor(toks[:, S:S + 1]), cache, S)
    assert out is cache
    after = [t for _, t in _flat(out)]
    assert [t.data_ptr() for t in after] == ptrs
    for (path, t), old in zip(_flat(out), before):
        L = t.shape[2]
        changed = (t != old).flatten(3).any(-1)        # (blocks, B, L)
        assert changed.sum() <= changed.shape[0] * B, path
        assert not changed[:, :, [s for s in range(L) if s != S % L]].any()


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# decode attention and the ring cache, function by function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("pos", [5, 63, 64 + 7, "per_row"])
def test_decode_attention_and_cache_update_match_reference(window, pos):
    Bq, L, KV, G, hd = 3, 64, 2, 3, 32
    rs = np.random.RandomState(0)
    q = rs.randn(Bq, 1, KV * G, hd).astype(np.float32)
    k, v = (rs.randn(Bq, L, KV, hd).astype(np.float32) for _ in range(2))
    kn, vn = (rs.randn(Bq, 1, KV, hd).astype(np.float32) for _ in range(2))
    p = np.array([3, 64 + 20, 200], np.int32) if pos == "per_row" \
        else np.int32(pos)
    jk, jv = jattention.cache_update(jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(kn), jnp.asarray(vn),
                                     jnp.asarray(p))
    tk, tv = torch.as_tensor(k.copy()), torch.as_tensor(v.copy())
    ptrs = (tk.data_ptr(), tv.data_ptr())
    gk, gv = attention.cache_update(tk, tv, torch.as_tensor(kn),
                                    torch.as_tensor(vn), torch.as_tensor(p))
    assert (gk.data_ptr(), gv.data_ptr()) == ptrs
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))
    want = jattention.decode_attention(jnp.asarray(q), jk, jv,
                                       jnp.asarray(p), window=window)
    got = attention.decode_attention(torch.as_tensor(q), gk, gv,
                                     torch.as_tensor(p), window=window)
    _close(got, want)


def test_decode_attention_bf16_accumulates_in_fp32():
    """A bf16 cache: scores and p.v accumulate in fp32 from the bf16
    values (p rounded to bf16 first), as the reference's
    ``preferred_element_type``; the output is rounded once to bf16."""
    Bq, L, KV, G, hd = 2, 40, 1, 4, 64
    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(Bq, n, h, hd).astype(np.float32)
               for n, h in ((1, KV * G), (L, KV), (L, KV)))
    bf = jnp.bfloat16
    want = jattention.decode_attention(
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
        jnp.asarray(30))
    got = attention.decode_attention(
        *(torch.as_tensor(a).bfloat16() for a in (q, k, v)), 30)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------
def _half_boundaries(rs, n=200, hd=32):
    """Rows whose max is 127 s and whose other entries are (k + 0.5) s:
    quantization rounds each exactly on a .5 boundary, half to even."""
    b = np.zeros((n, hd), np.float32)
    for i in range(n):
        s = np.float32(rs.uniform(0.001, 10))
        b[i, 0] = np.float32(127) * s
        b[i, 1:] = (rs.randint(-126, 126, hd - 1) + np.float32(0.5)) * s
    b[1] = 1e-12                       # below the 1e-8 scale floor
    return b


@pytest.mark.parametrize("case", ["random", "half_boundaries"])
def test_quantize_kv_is_bit_exact(case):
    """Payloads and fp16 scales equal the compiled reference bit for bit
    (its division by 127.0 is a product with fp32(1/127) under jit)."""
    rs = np.random.RandomState(0)
    if case == "random":
        x = rs.randn(8, 16, 2, 32).astype(np.float32) * rs.uniform(
            0.01, 100, (8, 16, 2, 1)).astype(np.float32)
    else:
        x = _half_boundaries(rs)
    jq, js = map(np.asarray, jax.jit(jkvquant.quantize_kv)(jnp.asarray(x)))
    q, s = kvquant.quantize_kv(torch.as_tensor(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float16
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy().view(np.uint16),
                                  js.view(np.uint16))
    np.testing.assert_array_equal(kvquant.dequantize_kv(q, s).numpy(),
                                  np.asarray(jkvquant.dequantize_kv(jq, js)))


def test_compiled_quantize_differs_from_a_division():
    """The reason for the product: dividing by 127 (the reference's source,
    as eager jnp runs it) lands .5 boundaries elsewhere."""
    x = _half_boundaries(np.random.RandomState(0))
    jq, _ = jax.jit(jkvquant.quantize_kv)(jnp.asarray(x))
    eager, _ = jkvquant.quantize_kv(jnp.asarray(x))
    assert (np.asarray(eager) != np.asarray(jq)).sum() > 0
    q, _ = kvquant.quantize_kv(torch.as_tensor(x))
    assert (q.numpy() != np.asarray(jq)).sum() == 0


def test_quant_cache_update_and_decode_attention_quant_match_reference():
    Bq, L, KV, G, hd = 2, 48, 2, 2, 32
    rs = np.random.RandomState(3)
    jcache = {n: jkvquant.init_quant_cache(Bq, L, KV, hd) for n in "kv"}
    cache = {n: kvquant.init_quant_cache(Bq, L, KV, hd) for n in "kv"}
    for pos in range(L + 5):            # fills the ring and wraps it
        new = {n: rs.randn(Bq, 1, KV, hd).astype(np.float32) for n in "kv"}
        for n in "kv":
            jcache[n] = jax.jit(jkvquant.quant_cache_update)(
                jcache[n], jnp.asarray(new[n]), jnp.int32(pos))
            kvquant.quant_cache_update(cache[n], torch.as_tensor(new[n]),
                                       pos)
    for n in "kv":
        np.testing.assert_array_equal(cache[n]["q"].numpy(),
                                      np.asarray(jcache[n]["q"]))
        np.testing.assert_array_equal(cache[n]["scale"].numpy(),
                                      np.asarray(jcache[n]["scale"]))
    q = rs.randn(Bq, 1, KV * G, hd).astype(np.float32)
    for window in (None, 16):
        want = jattention.decode_attention_quant(
            jnp.asarray(q), jcache["k"], jcache["v"], jnp.asarray(L + 4),
            window=window)
        got = attention.decode_attention_quant(
            torch.as_tensor(q), cache["k"], cache["v"], L + 4, window=window)
        _close(got, want)


@pytest.mark.parametrize("name", ["smollm", "gemma6"])
def test_kv_quant_model_matches_reference(name):
    """``Model(kv_quant=True)``: prefill logits, and the quantized cache
    within one int8 step of the reference's (the two fp32 k and v differ
    in their last bits, which may move a value across a rounding
    boundary); decode from the reference's own cache to 1e-5."""
    jmodel, tree, model = _reference(name, kv_quant=True)
    toks = _tokens(model.cfg)
    jlogits, jcache = _jprefill(jmodel, tree, toks[:, :S])
    logits, cache = model.prefill({"tokens": torch.as_tensor(toks[:, :S])},
                                  cache_len=CACHE_LEN)
    _close(logits, jlogits)
    got = transformer.cache_to_reference(cache)
    want = jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(got["blocks"], want["blocks"]):
        for n in "kv":
            assert g[n]["q"].dtype == np.int8
            deq = jkvquant.dequantize_kv
            step = np.asarray(w[n]["scale"], np.float32)
            assert np.all(np.abs(np.asarray(deq(g[n]["q"], g[n]["scale"]))
                                 - np.asarray(deq(w[n]["q"], w[n]["scale"])))
                          <= 1.01 * step + 1e-6)
    jlogits, _ = _jdecode(jmodel, tree, toks[:, S:S + 1], jcache, S)
    logits, _ = model.decode_step(
        torch.as_tensor(toks[:, S:S + 1]),
        transformer.cache_from_reference(want), S)
    _close(logits, jlogits)


# ---------------------------------------------------------------------------
# the cache bridge, the serve step's inputs, the input shapes, the launcher
# ---------------------------------------------------------------------------
# an RWKV cache holds no attention ring, so nothing to quantize there;
# RecurrentGemma's cache mixes RG-LRU states and rings, Whisper's holds
# enc_kv, Pixtral's prefill takes patch embeddings
CACHE_KINDS = [("gemma6", False), ("gemma6", True), ("rwkv", False),
               ("rglru5", False), ("whisper", False), ("whisper", True),
               ("pixtral", False)]


@pytest.mark.parametrize("name,kv_quant", CACHE_KINDS)
def test_cache_bridge_round_trips(name, kv_quant):
    jmodel, tree, model = _reference(name, kv_quant=kv_quant)
    _, jcache = _jprefill(jmodel, tree, _tokens(model.cfg)[:, :S])
    want = jax.tree.map(np.asarray, jcache)
    back = transformer.cache_to_reference(
        transformer.cache_from_reference(want))
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,kv_quant", CACHE_KINDS)
def test_serve_step_meta_inputs_match_reference(name, kv_quant):
    """``make_inputs`` gives meta tensors of the shapes and dtypes of the
    reference's ``ShapeDtypeStruct``s (its serve step built on a one-device
    pure-DP mesh), the cache tree included."""
    jmodel, _, model = _reference(name, kv_quant=kv_quant)
    jss = jbuild_serve_step(jmodel, jax.make_mesh((1,), ("data",)),
                            model_axis=None, batch_size=B,
                            cache_len=CACHE_LEN)
    ss = build_serve_step(model, batch_size=B, cache_len=CACHE_LEN)
    jb, b = jss.make_inputs("prefill", S), ss.make_inputs("prefill", S)
    assert sorted(b) == sorted(jb)
    for key, want in jb.items():
        assert b[key].device.type == "meta"
        assert tuple(b[key].shape) == want.shape
        assert str(b[key].dtype).split(".")[-1] == str(want.dtype)
    assert b["tokens"].dtype == torch.int32
    (jt, jc, jp), (t, c, p) = jss.make_inputs("decode", S), \
        ss.make_inputs("decode", S)
    assert (tuple(t.shape), tuple(p.shape)) == (jt.shape, jp.shape)
    assert t.dtype == p.dtype == torch.int32
    flat = list(_flat(c))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jc)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, c))
    for (_, got), want in zip(flat, jax.tree.leaves(jc)):
        assert got.device.type == "meta"
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)


def test_serve_step_runs_prefill_and_decode():
    jmodel, tree, model = _reference("smollm")
    ss = build_serve_step(model, batch_size=B, cache_len=CACHE_LEN)
    toks = _tokens(model.cfg)
    jlogits, jcache = _jprefill(jmodel, tree, toks[:, :S])
    logits, cache = ss.prefill_fn({"tokens": torch.as_tensor(toks[:, :S])})
    _close(logits, jlogits)
    jlogits, _ = _jdecode(jmodel, tree, toks[:, S:S + 1], jcache, S)
    logits, _ = ss.decode_fn(torch.as_tensor(toks[:, S:S + 1]), cache, S)
    _close(logits, jlogits)


def test_input_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JINPUT_SHAPES.items()}


def test_launch_serve_runs_on_the_cpu():
    lines = []
    out = launch_serve.main(["--arch", "smollm-135m", "--reduced",
                             "--device", "cpu", "--batch", "2",
                             "--prompt-len", "16", "--decode-tokens", "4"])
    assert out["tokens"].shape == (2, 5) and out["device"] == "cpu"
    res = launch_serve.serve(arch="rwkv6-7b", reduced=True, device="cpu",
                             batch=2, prompt_len=16, decode_tokens=3,
                             log=lines.append)
    assert res["tokens"].shape == (2, 4)
    assert lines[0].startswith("prefill 2x16") and \
        lines[-1].startswith("sample:")


def test_launch_serve_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "smollm-135m", "--reduced"])

