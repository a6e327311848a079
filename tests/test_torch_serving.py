"""Parity of the port's serving path with the JAX reference on the CPU:
prefill (logits and the whole cache tree) and one decode step for the
dense, sliding-window, RWKV, MoE, RG-LRU, encoder-decoder and VLM
families, both attention paths (the reference's Pallas kernel in
interpret mode against the port's kernel wrapper, which takes its plain
version on the CPU); the sliding-window variant, prompts shorter than
the cache, and decode writing the cache in place.  Sequential decode,
per-slot positions, decode attention and the int8 KV cache are in
``test_torch_serving_decode.py``; the cache bridge, the serve step and
the launcher in ``test_torch_serve_step.py``; the helpers and the
tolerance in ``torch_serving_parity.py``."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

from repro_torch.kernels import swa_attention as tswa  # noqa: E402
from torch_serving_parity import (ARCHS, B, CACHE_LEN, S, _close,  # noqa: E402
                                  _close_trees, _flat, _jdecode, _jprefill,
                                  _prefill, _reference, _tokens)


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
