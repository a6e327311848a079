"""Parity of the port's RWKV6 slice with the JAX reference on the CPU, at
reduced width: the WKV recurrence (the plain chunked twin of the Hopper
kernel and the exact oracle against the reference's Pallas kernel in
interpret mode and its oracle), the chunked core with a state and a ragged
T, the time-mix block (kernel gate, decode step, state carry), the model's
logits and gradients against ``Model(use_pallas=True)``, three train steps
against the reference's ``build_train_step`` on a one-device pure-DP mesh,
and the entry point.  The kernel itself is held against the twin on a GPU
in ``test_torch_cuda.py``."""
import dataclasses
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.analysis import analyze_sources  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import build_train_step as jbuild_train_step  # noqa: E402
from repro.core import get_strategy as jget_strategy  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models.transformer import build_model as jbuild_model  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import build_train_step, get_strategy  # noqa: E402
from repro_torch.data import lm_batches, token_stream  # noqa: E402
from repro_torch.kernels import fused_adamw, wkv6  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import rwkv6, transformer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCH = "rwkv6-7b"

# the reference's own cases (tests/test_kernels.py:WKV_CASES), then strong
# decay: logw = -exp(N(mu, 0.5)) with mu 1.5 and 3, where the Pallas
# body's exp of the unmasked pairwise difference overflows for s >= t
WKV_CASES = [
    # (B, T, H, N, chunk, dtype, mu)
    (2, 64, 2, 32, 16, "float32", -2.0),
    (1, 128, 4, 64, 64, "float32", -2.0),
    (2, 96, 3, 16, 32, "float32", -2.0),   # chunk halves to divide T
    (1, 64, 2, 32, 16, "bfloat16", -2.0),
]
STRONG_CASES = [(1, 64, 2, 32, 64, "float32", 1.5),
                (2, 128, 2, 16, 64, "float32", 3.0)]


def _wkv_inputs(B, T, H, N, dtype, mu, seed=0):
    """The reference test's draws (numpy), rounded once by torch; the
    same values in both packages."""
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(B, T, H, N) * 0.5 for _ in range(3)]
    arrs.append(-np.exp(rs.randn(B, T, H, N) * 0.5 + mu))
    arrs.append(rs.randn(H, N) * 0.5)
    ts = [torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
          for a in arrs]
    js = [jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype))
          for t in ts]
    return ts, js


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("B,T,H,N,chunk,dtype,mu", WKV_CASES)
def test_wkv_plain_matches_pallas_and_oracle(B, T, H, N, chunk, dtype, mu):
    """The port's ``ops.wkv6`` (the plain chunked twin on the CPU) and its
    exact recurrence against the reference's Pallas kernel (interpret
    mode) and its oracle: 1e-4 in fp32 (the reference test's), 5e-2 in
    bf16."""
    (r, k, v, lw, u), js = _wkv_inputs(B, T, H, N, dtype, mu)
    before = dict(wkv6.LAUNCHES)
    got = tops.wkv6(r, k, v, lw, u, chunk=chunk)
    exact = tref.wkv6(r, k, v, lw, u)
    assert wkv6.LAUNCHES == before
    assert got.dtype == exact.dtype == r.dtype and got.shape == r.shape
    pallas = jops.wkv6(*js, chunk=chunk)
    oracle = jref.wkv6(*js)
    tol = 5e-2 if dtype == "bfloat16" else 1e-4
    for mine in (got, exact):
        for theirs in (pallas, oracle):
            np.testing.assert_allclose(_np(mine), _np(theirs), atol=tol)


@pytest.mark.parametrize("B,T,H,N,chunk,dtype,mu", STRONG_CASES)
def test_wkv_plain_is_finite_and_exact_under_strong_decay(B, T, H, N, chunk,
                                                           dtype, mu):
    """Strong decay (per-step decay factors down to exp(-e^4.5)): the
    twin masks the pairwise difference before the exp and takes Lprev as
    the exclusive sum, so it stays finite and within 1e-4 of the exact
    recurrence (the reference's oracle and the port's).  The reference's
    Pallas kernel is not the yardstick at this decay: in interpret mode
    it returns NaN at mu 3 (its exp of the unmasked difference overflows
    to inf, times a mask of 0), which this test records."""
    (r, k, v, lw, u), js = _wkv_inputs(B, T, H, N, dtype, mu, seed=7)
    got = tref.wkv6_chunked(r, k, v, lw, u, chunk=chunk)
    assert bool(torch.isfinite(got).all())
    oracle = _np(jref.wkv6(*js))
    np.testing.assert_allclose(_np(got), oracle, atol=1e-4)
    np.testing.assert_allclose(_np(tref.wkv6(r, k, v, lw, u)), oracle,
                               atol=1e-5)
    pallas_finite = np.isfinite(_np(jops.wkv6(*js, chunk=chunk))).all()
    assert pallas_finite == (mu < 3)


@pytest.mark.parametrize("T,chunk", [(37, 16), (48, 128), (64, 16)])
def test_wkv_chunked_matches_reference_with_state(T, chunk):
    """``wkv_chunked`` against ``wkv_chunked_jnp`` from a random state,
    a ragged T included: y and the final state to 1e-5."""
    (r, k, v, lw, u), js = _wkv_inputs(2, T, 3, 16, "float32", -2.0, seed=3)
    S0 = np.random.RandomState(4).randn(2, 3, 16, 16).astype(np.float32)
    y, S = rwkv6.wkv_chunked(r, k, v, lw, u, torch.from_numpy(S0),
                             chunk=chunk)
    jy, jS = jrwkv.wkv_chunked_jnp(*js, jnp.asarray(S0), chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(jy), atol=1e-5)
    np.testing.assert_allclose(_np(S), _np(jS), atol=1e-5)


@pytest.mark.parametrize("B,T,H,N,chunk,dtype,mu", STRONG_CASES)
def test_wkv_chunked_under_strong_decay(B, T, H, N, chunk, dtype, mu):
    """The model's own chunked form (the kernel's backward recompute and
    the kernel-free forward) under strong decay from a zero state: finite
    and within 1e-4 of the exact recurrence.  ``wkv_chunked_jnp`` is
    finite here but not the yardstick: its Lprev = L - logw misses
    L_{t-1} by an ulp of a large |L|, 2.9e-4 off the oracle at mu 3.  The
    model keeps its own chunk step: the kernel's plain twin in ``ref.py``
    is not the model's code."""
    (r, k, v, lw, u), js = _wkv_inputs(B, T, H, N, dtype, mu, seed=7)
    y, _ = rwkv6.wkv_chunked(r, k, v, lw, u, torch.zeros(B, H, N, N),
                             chunk=chunk)
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(_np(y), _np(jref.wkv6(*js)), atol=1e-4)
    jy, _ = jrwkv.wkv_chunked_jnp(*js, jnp.zeros((B, H, N, N)), chunk=chunk)
    assert np.isfinite(_np(jy)).all()
    assert all(m is not tref for m in vars(rwkv6).values())


# ---------------------------------------------------------------------------
# the time-mix block (mirrors tests/test_rwkv_rglru.py)
# ---------------------------------------------------------------------------
def _block(d_model=128, seed=0):
    jcfg = jget_config(ARCH).reduced(d_model=d_model)
    cfg = get_config(ARCH).reduced(d_model=d_model)
    jp = jrwkv.rwkv_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rs = np.random.RandomState(seed)
    # random bonus and decays: the init's (u = 0, w ~ 0.9975) barely
    # exercise the recurrence
    jp = dict(jp, bonus_u=jnp.asarray(rs.randn(*jp["bonus_u"].shape) * 0.5,
                                      jnp.float32),
              decay_base=jnp.asarray(rs.randn(d_model) - 1.0, jnp.float32))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, p


def _x(B, T, d, seed):
    x = (0.5 * np.random.RandomState(seed).randn(B, T, d)).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def test_rwkv_init_matches_reference_leaves():
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    want = jrwkv.rwkv_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    got = rwkv6.rwkv_init(torch.Generator().manual_seed(0), cfg,
                          torch.float32)
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
    for name in ("decay_base", "bonus_u", "mix"):
        np.testing.assert_array_equal(got[name].numpy(), want[name])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rwkv_apply_matches_reference(use_kernel):
    """T 64 takes the kernel's gate (its twin here), T 37 the chunked
    path either way: output and state to 1e-5 of the reference's."""
    jcfg, cfg, jp, p = _block()
    for T in (64, 37):
        x, jx = _x(2, T, cfg.d_model, seed=T)
        y, st = rwkv6.rwkv_apply(p, x, cfg, use_kernel=use_kernel)
        jy, jst = jrwkv.rwkv_apply(jp, jx, jcfg, use_kernel=use_kernel)
        np.testing.assert_allclose(_np(y), _np(jy), atol=1e-5)
        np.testing.assert_allclose(_np(st["S"]), _np(jst["S"]), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_array_equal(_np(st["x_last"]), _np(jst["x_last"]))
        y2, none = rwkv6.rwkv_apply(p, x, cfg, use_kernel=use_kernel,
                                    with_state=False)
        assert none is None
        torch.testing.assert_close(y2, y, rtol=0, atol=0)


def test_rwkv_chunked_equals_stepwise_and_decode_matches_reference():
    """Chunked (chunk 16, T 37) against the exact decode recurrence token
    by token (2e-4, the reference test's), and each decode step against
    the reference's (1e-5)."""
    jcfg, cfg, jp, p = _block()
    B, T = 2, 37
    x, jx = _x(B, T, cfg.d_model, seed=1)
    y_par, st_par = rwkv6.rwkv_apply(p, x, cfg, chunk=16)
    st = rwkv6.rwkv_init_state(cfg, B, x.dtype)
    jst = jrwkv.rwkv_init_state(jcfg, B, jnp.float32)
    ys = []
    for t in range(T):
        y_t, st = rwkv6.rwkv_decode_step(p, x[:, t:t + 1], cfg, st)
        jy_t, jst = jrwkv.rwkv_decode_step(jp, jx[:, t:t + 1], jcfg, jst)
        np.testing.assert_allclose(_np(y_t), _np(jy_t), atol=1e-5)
        ys.append(y_t)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(y_par), atol=2e-4)
    np.testing.assert_allclose(_np(st["S"]), _np(st_par["S"]), atol=2e-4)
    np.testing.assert_allclose(_np(st["S"]), _np(jst["S"]), atol=1e-5,
                               rtol=1e-5)


def test_rwkv_state_carry_across_segments():
    """apply(x) == apply(x[:, :19]) then apply(x[:, 19:], state)."""
    _, cfg, _, p = _block()
    x, _ = _x(1, 48, cfg.d_model, seed=2)
    y_full, _ = rwkv6.rwkv_apply(p, x, cfg, chunk=16)
    y1, st = rwkv6.rwkv_apply(p, x[:, :19], cfg, chunk=16)
    y2, _ = rwkv6.rwkv_apply(p, x[:, 19:], cfg, state=st, chunk=16)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y_full),
                               atol=2e-4)


def test_kernel_function_gradient_matches_chunked_autograd():
    """The kernel's autograd Function (forward: ``ops.wkv6``; backward:
    the chunk-128 recompute) against plain autograd through
    ``wkv_chunked`` and through the reference's custom VJP: 1e-4."""
    (r, k, v, lw, u), js = _wkv_inputs(2, 64, 2, 32, "float32", -2.0, seed=5)
    gy = np.random.RandomState(6).randn(2, 64, 2, 32).astype(np.float32)
    a = [t.clone().requires_grad_() for t in (r, k, v, lw, u)]
    b = [t.clone().requires_grad_() for t in (r, k, v, lw, u)]
    y = rwkv6._WkvKernel.apply(*a)
    y.backward(torch.from_numpy(gy))
    S0 = torch.zeros(2, 2, 32, 32)
    rwkv6.wkv_chunked(*b, S0, chunk=128)[0].backward(torch.from_numpy(gy))
    _, vjp = jax.vjp(jrwkv._wkv_kernel_vjp, *js)
    jg = vjp(jnp.asarray(gy))
    for x, z, want in zip(a, b, jg):
        np.testing.assert_allclose(_np(x.grad), _np(z.grad), atol=1e-5)
        np.testing.assert_allclose(_np(x.grad), _np(want), atol=1e-4)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_model():
    """Reduced rwkv6-7b (2 layers, d_model 256, 8 heads of 32), the
    reference's ``Model(use_pallas=True)`` at T 64: parameters, logits
    and the gradient of mean(logits^2)."""
    jcfg = jget_config(ARCH).reduced()
    jmodel = jbuild_model(jcfg, remat=False, use_pallas=True)
    tree = jmodel.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    # random bonus and decays, as in _block
    blk = tree["blocks"][0]["rwkv"]
    blk["bonus_u"] = jnp.asarray(rs.randn(*blk["bonus_u"].shape) * 0.5,
                                 jnp.float32)
    blk["decay_base"] = jnp.asarray(rs.randn(*blk["decay_base"].shape)
                                    - 1.0, jnp.float32)
    tokens = rs.randint(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}

    def loss(p):
        logits, _ = jmodel.apply(p, batch)
        return jnp.mean(logits.astype(jnp.float32) ** 2)
    logits, _ = jmodel.apply(tree, batch)
    grads = jax.grad(loss)(tree)
    return (jax.tree.map(np.asarray, tree), tokens, np.asarray(logits),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


@pytest.mark.parametrize("remat", [True, False])
def test_model_logits_and_grads_match_reference(reference_model, remat):
    """The port's ``Model(use_kernel=True)`` (the kernel's twin on the
    CPU, its backward the chunk-128 recompute) against the reference's
    ``Model(use_pallas=True)``: logits and every gradient leaf to 1e-4,
    with remat on and off."""
    tree, tokens, want, jgrads = reference_model
    cfg = get_config(ARCH).reduced()
    model = transformer.Model(cfg, use_kernel=True, remat=remat)
    model.load_state_dict(transformer.params_from_reference(tree))
    before = dict(wkv6.LAUNCHES)
    logits, aux = model({"tokens": torch.from_numpy(tokens)})
    assert logits.shape == want.shape == (2, 64, 512) and float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), want, atol=1e-4)
    leaves = transformer.reference_leaves(model)
    grads = torch.autograd.grad(torch.mean(logits.float() ** 2), leaves)
    assert wkv6.LAUNCHES == before
    assert len(grads) == len(jgrads) == 17
    for g, jg in zip(grads, jgrads):
        assert tuple(g.shape) == jg.shape
        np.testing.assert_allclose(_np(g), jg, atol=1e-4)


# ---------------------------------------------------------------------------
# train steps and the entry point
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


def test_three_train_steps_match_reference(group):
    """Reduced rwkv6-7b, batch 4 x seq 64 from the same ``lm_batches``,
    AdamW(3e-3) through the fused path, three all-reduce steps on one
    rank from the reference's parameters: the port with the kernels'
    paths (plain versions on the CPU) against the reference with
    ``use_pallas=True`` and its Pallas AdamW, on the pure-DP mesh.

    fp32.  Losses of all three steps to 1e-5; after the first step the
    moments to 1e-5 of each leaf's largest value, and the parameters the
    way ``tests/test_torch_transformer.py`` holds them: where |m| is at
    least 1% of the leaf's largest (AdamW's first update is +-lr wherever
    a gradient element is within fp32 noise of zero) and everywhere
    within the update bound (2 lr a step)."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jmodel = jbuild_model(jcfg, use_pallas=True)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    it = lm_batches(token_stream(4 * 64 * 64, cfg.vocab_size), 4, 64)
    batches = [next(it) for _ in range(3)]
    lr = 3e-3

    jts = jbuild_train_step(
        jmodel, joptim.adamw(lr, use_fused=True), jget_strategy("allreduce"),
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

    model = transformer.Model(cfg, use_kernel=True)
    model.load_state_dict(transformer.params_from_reference(tree))
    ts = build_train_step(model, optim.adamw(lr, use_fused=True),
                          get_strategy("allreduce"))
    state = ts.init_state()
    before = (dict(fused_adamw.LAUNCHES), dict(wkv6.LAUNCHES))
    snap = []
    for b, jm in zip(batches, jmetrics):
        state, m = ts.step_fn(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-5)
        snap.append([_leaves_np(state["params"])] + [
            _leaves_np(state["opt"][k]) for k in "mv"])
    assert (fused_adamw.LAUNCHES, wkv6.LAUNCHES) == before

    (p1, m1, v1), (jp1, jm1, jv1) = snap[0], jsnap[0]
    assert len(p1) == len(jp1) == 17
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


def test_entry_point_trains_reduced_rwkv_on_cpu():
    res = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--layers", "2", "--steps", "3", "--batch", "4",
                             "--seq", "64", "--fused-optimizer"])
    assert res["arch"] == ARCH and res["params"] == 1_463_040
    assert len(res["losses"]) == 3 and all(map(math.isfinite,
                                               res["losses"]))
    one = launch_train.train(arch=ARCH, reduced=True, n_layers=1, steps=1,
                             batch=2, seq=32, device="cpu", log=None)
    assert one["params"] == 862_720
    assert not dist.is_initialized()


def test_depth_cut_refuses_a_cnn_and_missing_cuda():
    with pytest.raises(ValueError, match="depth of a CNN"):
        launch_train.train(arch="mobilenet-cifar", reduced=True,
                           n_layers=2, steps=1, device="cpu", log=None)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.train(arch=ARCH, reduced=True, steps=1)


# ---------------------------------------------------------------------------
# the kernel-ref-parity lint rule covers the new kernel module
# ---------------------------------------------------------------------------
def test_lint_names_the_wkv_kernel_with_its_twin():
    """With this file as the parity test the rule finds nothing to say
    about ``wkv6.wkv6_chunked`` and ``ops.wkv6``; with the RWKV twins cut
    from ref.py it names both."""
    paths = sorted((ROOT / "src" / "repro_torch" / "kernels").glob("*.py"))
    paths.append(Path(__file__).resolve())
    sources = {p.relative_to(ROOT).as_posix(): p.read_text() for p in paths}

    def findings(srcs):
        res = analyze_sources(srcs, rules=["kernel-ref-parity"])
        return {(f.path.rsplit("/", 1)[-1], f.message) for f in res.findings}

    def about(found, module, fn):
        return [msg for m, msg in found if m == module and f"'{fn}'" in msg]
    ref_path = "src/repro_torch/kernels/ref.py"
    cut = sources[ref_path]
    cut = cut[:cut.index("def wkv6(")]
    clean, got = findings(sources), findings({**sources, ref_path: cut})
    for module, fn in (("wkv6.py", "wkv6_chunked"), ("ops.py", "wkv6")):
        assert not about(clean, module, fn), about(clean, module, fn)
        assert any("no reference twin" in msg
                   for msg in about(got, module, fn)), (module, fn, got)
