"""Parity of the port's serving plumbing with the JAX reference on the
CPU: the cache bridge both ways for every cache kind (int8 included),
the serve step's meta inputs and its prefill and decode, the input
shapes, and the ``launch.serve`` entry point on the CPU.  Helpers and
tolerance: ``torch_serving_parity.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import INPUT_SHAPES as JINPUT_SHAPES  # noqa: E402
from repro.core import build_serve_step as jbuild_serve_step  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.core import build_serve_step  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from torch_serving_parity import (B, CACHE_LEN, S, _close, _flat,  # noqa: E402
                                  _jdecode, _jprefill, _reference, _tokens)


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
