"""The port's LM kernels on the CPU: the plain versions of sliding-window
attention and fused AdamW against the JAX oracles and the Pallas kernels
(interpret mode), the attention gradient, and the wrappers' dispatch.  The
Hopper kernels themselves are held against these plain versions on a GPU
in ``test_torch_cuda.py``."""
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.analysis import analyze_sources  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.kernels import fused_adamw as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import swa_attention as jswa  # noqa: E402
from repro.models.transformer import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import fused_adamw as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import swa_attention as tswa  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import bias_corrections  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# the reference's own cases (tests/test_kernels.py:SWA_CASES)
SWA_CASES = [
    # (B, S, H, KV, hd, window, dtype)
    (2, 256, 4, 2, 64, None, "float32"),
    (1, 512, 8, 8, 128, 128, "float32"),
    (2, 256, 4, 1, 32, 64, "bfloat16"),
    (1, 128, 2, 2, 64, None, "bfloat16"),
    (1, 256, 6, 3, 32, 32, "float32"),
    (3, 128, 4, 4, 128, 96, "float32"),
]


def _qkv(B, S, H, KV, hd, dtype, seed=0):
    """The same values in both packages (bf16 rounded once, by torch)."""
    rs = np.random.RandomState(seed)
    ts = [torch.from_numpy(rs.randn(B, S, n, hd).astype(np.float32))
          .to(getattr(torch, dtype)) for n in (H, KV, KV)]
    js = [jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype))
          for t in ts]
    return ts, js


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,H,KV,hd,window,dtype", SWA_CASES)
def test_swa_plain_matches_oracle_and_pallas(B, S, H, KV, hd, window,
                                             dtype):
    """fp32 softmax attention over the same inputs, in another order:
    2e-5 in fp32 and 2e-2 (a bf16 rounding step) in bf16, the reference
    test's tolerances."""
    (q, k, v), (jq, jk, jv) = _qkv(B, S, H, KV, hd, dtype)
    got = tswa.swa_attention_fwd(q, k, v, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_array_equal(
        _np(got), _np(tref.swa_attention(q, k, v, window=window)))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (jops.swa_attention(jq, jk, jv, window=window),
                 jref.swa_attention(jq, jk, jv, window=window)):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol)


def test_swa_plain_matches_pallas_kernel_at_smollm_heads():
    """SmolLM's grouping (9 heads on 3 kv heads, hd 64), causal, against
    the Pallas kernel called directly in interpret mode."""
    (q, k, v), (jq, jk, jv) = _qkv(2, 128, 9, 3, 64, "float32", seed=3)
    want = jswa.swa_attention_fwd(jq, jk, jv, q_block=128, kv_block=128,
                                  interpret=True)
    np.testing.assert_allclose(_np(tswa.swa_attention_fwd(q, k, v)),
                               _np(want), atol=2e-5)


def test_swa_plain_matches_pallas_kernel_at_gemma3_head_dim():
    """Gemma-3's head_dim 320 (8 heads on 4 kv heads), window 64, against
    the Pallas kernel called directly in interpret mode: 2e-5, as at
    SmolLM's heads."""
    (q, k, v), (jq, jk, jv) = _qkv(1, 128, 8, 4, 320, "float32", seed=4)
    want = jswa.swa_attention_fwd(jq, jk, jv, window=64, q_block=64,
                                  kv_block=64, interpret=True)
    got = tswa.swa_attention_fwd(q, k, v, window=64)
    assert got.shape == (1, 128, 8, 320)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["chunked", "kernel"])
def test_gemma3_logits_match_reference_at_head_dim_320(use_kernel):
    """Six layers (one 5:1 local/global group) at a narrow width whose
    head_dim, d_model / n_heads = 640 / 2, is Gemma-3's 320; one kv head,
    window 64, vocab 512, fp32, seq 128.  The kernel path (the plain
    attention on the CPU) against ``Model(use_pallas=True)`` (the Pallas
    kernel in interpret mode) and the chunked path against the
    reference's: to 1e-5 of the largest logit, the tolerance of
    ``test_torch_transformer.test_logits_match_reference``."""
    narrow = dict(n_layers=6, d_model=640, n_heads=2, n_kv_heads=1,
                  head_dim=None, d_ff=1280, vocab_size=512, window=64,
                  dtype="float32")
    jcfg = dataclasses.replace(jget_config("gemma3-4b"), **narrow)
    cfg = dataclasses.replace(get_config("gemma3-4b"), **narrow)
    assert cfg.head_dim == jcfg.head_dim == 320
    jmodel = jbuild_model(jcfg, use_pallas=use_kernel)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(7)))
    model = transformer.Model(cfg, use_kernel=use_kernel)
    model.load_state_dict(transformer.params_from_reference(tree))
    tokens = np.random.RandomState(7).randint(0, 512, (2, 128)).astype(
        np.int32)
    want, _ = jmodel.apply(tree, {"tokens": jnp.asarray(tokens)})
    want = np.asarray(want)
    with torch.no_grad():
        got, _ = model({"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape == (2, 128, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_swa_gradient_matches_jax():
    """The gradient through ``ops.swa_attention`` (its backward recomputes
    through the chunked flash attention) against ``jax.grad`` through the
    reference's, window 64: 1e-4, the reference test's tolerance."""
    (q, k, v), (jq, jk, jv) = _qkv(1, 256, 4, 2, 64, "float32", seed=1)
    jg = jax.grad(lambda *a: jnp.sum(jnp.tanh(jops.swa_attention(
        *a, window=64))), argnums=(0, 1, 2))(jq, jk, jv)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.sum(torch.tanh(tops.swa_attention(*qkv, window=64))).backward()
    for t, want in zip(qkv, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=1e-4)
    # and against plain autograd through the naive version
    qkv2 = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.sum(torch.tanh(tref.swa_attention(*qkv2, window=64))).backward()
    for a, b in zip(qkv, qkv2):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=1e-4)


def test_swa_wrapper_validates_and_refuses_devices_without_a_kernel():
    q = torch.zeros(1, 8, 4, 64)
    with pytest.raises(ValueError, match="divisible"):
        tswa.swa_attention_fwd(q, torch.zeros(1, 8, 3, 64),
                               torch.zeros(1, 8, 3, 64))
    with pytest.raises(ValueError, match="window"):
        tswa.swa_attention_fwd(q, q, q, window=0)
    meta = torch.empty((1, 8, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tswa.swa_attention_fwd(meta, meta, meta)


# ---------------------------------------------------------------------------
# fused AdamW
# ---------------------------------------------------------------------------
KW = dict(lr=3e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.1)


def _adamw_inputs(n, dtype, seed=0):
    rs = np.random.RandomState(seed)
    g = rs.randn(n).astype(np.float32)
    m = (rs.randn(n) * 0.1).astype(np.float32)
    v = (rs.rand(n) * 0.01).astype(np.float32)
    p = rs.randn(n).astype(np.float32)
    tg, tp = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (g, p))
    jg, jp = (jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype))
              for t in (tg, tp))
    # copies: the port updates m and v in place
    return (tg, torch.from_numpy(m.copy()), torch.from_numpy(v.copy()), tp), \
        (jg, jnp.asarray(m), jnp.asarray(v), jp)


def _close_moments(got, want):
    """XLA may contract ``b1*m + (1-b1)*g`` into one fma where the port
    rounds the product first: agreement to 1e-6 of the largest moment."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n", [7, 100, 257, 4096, 65537])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_adamw_plain_matches_oracle_and_pallas(n, dtype):
    """The same fp32 operations at step 3's bias corrections; XLA may
    contract a multiply-add, so m' and v' agree to 1e-6 of the largest
    value and u to 1e-6 relative (and 1e-6 of the lr) in fp32; in bf16 u
    rounds once to the parameter dtype, one bf16 step (2^-7 relative at
    most) apart."""
    (g, m, v, p), (jg, jm, jv, jp) = _adamw_inputs(n, dtype)
    c1, c2 = bias_corrections(KW["b1"], KW["b2"], 3, "cpu")
    before = dict(tfa.LAUNCHES)
    u, m2, v2 = tfa.fused_adamw_flat(g, m, v, p, c1, c2, **KW)
    assert tfa.LAUNCHES == before
    assert u.dtype == p.dtype and m2 is m and v2 is v
    ju, jm2, jv2 = jops.fused_adamw(jg, jm, jv, jp, c1=float(c1),
                                    c2=float(c2), **KW)
    wu, wm, wv = jref.fused_adamw_flat(jg, jm, jv, jp, jnp.float32(c1),
                                       jnp.float32(c2), **KW)
    for got, want in ((m, jm2), (v, jv2), (m, wm), (v, wv)):
        _close_moments(got, want)
    rtol = 2 ** -7 if dtype == "bfloat16" else 1e-6   # a bf16 step
    for want in (ju, wu):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(_np(u), want, atol=1e-6 * KW["lr"],
                                   rtol=rtol)


def test_fused_adamw_plain_is_the_kernels_arithmetic():
    """The plain version's u, m', v' against a float64 evaluation of the
    kernel's operations, each rounded to fp32 in the kernel's order."""
    (g, m, v, p), _ = _adamw_inputs(1000, "float32", seed=2)
    c1, c2 = bias_corrections(0.9, 0.95, 2, "cpu")
    u, m2, v2 = tref.fused_adamw_flat(g, m, v, p, c1, c2, **KW)
    f = lambda x: np.asarray(x, np.float64).astype(np.float32) \
        .astype(np.float64)
    g64, p64 = f(g), f(p)
    mn = f(f(f(0.9) * f(m)) + f(f(1 - 0.9) * g64))
    vn = f(f(f(0.95) * f(v)) + f(f(f(1 - 0.95) * g64) * g64))
    den = f(f(np.sqrt(f(vn / f(c2)))) + f(1e-8))
    t = f(f(f(mn / f(c1)) / den) + f(f(0.1) * p64))
    want = f(f(-3e-3) * t)
    np.testing.assert_array_equal(m2.numpy(), mn.astype(np.float32))
    np.testing.assert_array_equal(v2.numpy(), vn.astype(np.float32))
    np.testing.assert_array_equal(u.numpy(), want.astype(np.float32))


def test_fused_adamw_pallas_tile_edges_match_plain():
    """The Pallas kernel at a tile smaller than the leaf (several grid
    steps and a padded tail) against the plain version."""
    (g, m, v, p), (jg, jm, jv, jp) = _adamw_inputs(3000, "float32", seed=4)
    c1, c2 = bias_corrections(0.9, 0.95, 1, "cpu")
    ju, jm2, jv2 = jfa.fused_adamw_flat(
        jg, jm, jv, jp, jnp.float32(c1), jnp.float32(c2), tile=(8, 128),
        interpret=True, **KW)
    u, _, _ = tfa.fused_adamw_flat(g, m, v, p, c1, c2, **KW)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-6,
                               atol=1e-6 * KW["lr"])
    _close_moments(m, jm2)
    _close_moments(v, jv2)


def test_fused_adamw_wrapper_validates_and_refuses_other_devices():
    (g, m, v, p), _ = _adamw_inputs(16, "float32")
    c1, c2 = bias_corrections(0.9, 0.95, 1, "cpu")
    with pytest.raises(ValueError, match="1-D"):
        tfa.fused_adamw_flat(g[:8], m, v, p, c1, c2, **KW)
    with pytest.raises(TypeError, match="fp32"):
        tfa.fused_adamw_flat(g, m.double(), v, p, c1, c2, **KW)
    with pytest.raises(TypeError, match="c1"):
        tfa.fused_adamw_flat(g, m, v, p, 0.1, c2, **KW)
    meta = [t.to("meta") for t in (g, m, v, p, c1, c2)]
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.fused_adamw_flat(*meta, **KW)


def test_ops_fused_adamw_keeps_leaf_shapes():
    (g, m, v, p), _ = _adamw_inputs(24, "bfloat16", seed=5)
    c1, c2 = bias_corrections(0.9, 0.95, 1, "cpu")
    g, m, v, p = (t.reshape(2, 3, 4) for t in (g, m, v, p))
    u, m2, v2 = tops.fused_adamw(g, m, v, p, c1=c1, c2=c2, **KW)
    assert u.shape == p.shape and u.dtype == torch.bfloat16
    assert m2 is m and v2 is v


# ---------------------------------------------------------------------------
# the kernel-ref-parity lint rule covers the new kernel modules
# ---------------------------------------------------------------------------
def _lint_sources():
    paths = sorted((ROOT / "src" / "repro_torch" / "kernels").glob("*.py"))
    paths.append(Path(__file__).resolve())
    return {p.relative_to(ROOT).as_posix(): p.read_text() for p in paths}


def _parity_findings(sources):
    res = analyze_sources(sources, rules=["kernel-ref-parity"])
    return {(f.path.rsplit("/", 1)[-1], f.message) for f in res.findings}


NEW_KERNELS = [("swa_attention.py", "swa_attention_fwd"),
               ("fused_adamw.py", "fused_adamw_flat"),
               ("ops.py", "swa_attention"), ("ops.py", "fused_adamw")]


def _about(findings, module, fn):
    return [msg for m, msg in findings if m == module and f"'{fn}'" in msg]


def test_lint_names_each_new_kernel_with_its_twin():
    """With this file as the parity test, the rule finds nothing to say
    about the new kernels; without their twins in ref.py, it names each
    public function of both new kernel modules (and their ``ops``
    entries)."""
    sources = _lint_sources()
    clean = _parity_findings(sources)
    ref_path = "src/repro_torch/kernels/ref.py"
    cut = sources[ref_path]
    cut = cut[:cut.index("def swa_attention(")]
    got = _parity_findings({**sources, ref_path: cut})
    for module, fn in NEW_KERNELS:
        assert not _about(clean, module, fn), _about(clean, module, fn)
        assert any("no reference twin" in msg
                   for msg in _about(got, module, fn)), (module, fn, got)
