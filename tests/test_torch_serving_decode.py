"""Parity of the port's decoding with the JAX reference on the CPU:
eight decode steps in a row and per-slot positions (SmolLM, Gemma-3's
wrapping local rings, RWKV), decode attention and the ring cache update
function by function (fp32 and a bf16 cache), and the int8 KV cache
(quantization bit for bit, the quantized ring, the quantized model).
Helpers and tolerance: ``torch_serving_parity.py``."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jattention  # noqa: E402
from repro.models import kvquant as jkvquant  # noqa: E402
from repro_torch.models import attention, kvquant, transformer  # noqa: E402
from torch_serving_parity import (CACHE_LEN, S, _close,  # noqa: E402
                                  _close_trees, _jdecode, _jprefill,
                                  _reference, _tokens)


# ---------------------------------------------------------------------------
# sequential decode and per-slot positions
# ---------------------------------------------------------------------------
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
