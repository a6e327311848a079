"""Parity of the port's RG-LRU block (``models.rglru``) with the JAX
reference on the CPU, at the reference test's size (RecurrentGemma reduced
to d_model 128, B 2, T 29): the full-sequence form from a zero state and
from a carried state, the decode step, and the gradients, each to 1e-5 of
the largest value; the doubling scan against its own step loop (atol 2e-4,
the reference's bar for its scan against its steps) and against an exact
loop at every length up to 70; and the sinusoidal positions of the
encoder-decoder against the reference's."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers, rglru  # noqa: E402

B, T = 2, 29
TOL = 1e-5


def _setup(seed=0):
    jcfg = jget_config("recurrentgemma-2b").reduced(d_model=128)
    cfg = get_config("recurrentgemma-2b").reduced(d_model=128)
    p = jax.tree.map(np.asarray, jrglru.rglru_init(jax.random.PRNGKey(seed),
                                                  jcfg, jnp.float32))
    rs = np.random.RandomState(seed + 3)
    x = (0.5 * rs.randn(B, T, cfg.d_model)).astype(np.float32)
    state = {"h": rs.randn(B, cfg.rglru_width).astype(np.float32),
             "conv": (0.5 * rs.randn(B, cfg.conv_width - 1, cfg.rglru_width))
             .astype(np.float32)}
    return jcfg, cfg, p, x, state


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_rglru_apply_matches_reference(carried):
    jcfg, cfg, p, x, state = _setup()
    jstate = jax.tree.map(jnp.asarray, state) if carried else None
    want_y, want_s = jrglru.rglru_apply(jax.tree.map(jnp.asarray, p),
                                        jnp.asarray(x), jcfg, state=jstate)
    got_y, got_s = rglru.rglru_apply(_t(p), torch.from_numpy(x), cfg,
                                     state=_t(state) if carried else None)
    _close(got_y, want_y)
    for k in ("h", "conv"):
        assert got_s[k].dtype == torch.float32
        _close(got_s[k], want_s[k])


def test_rglru_decode_step_matches_reference():
    """Five decode steps from a carried state."""
    jcfg, cfg, p, x, state = _setup()
    jp = jax.tree.map(jnp.asarray, p)
    js, ts = jax.tree.map(jnp.asarray, state), _t(state)
    for t in range(5):
        want_y, js = jrglru.rglru_decode_step(jp, jnp.asarray(x[:, t:t + 1]),
                                              jcfg, js)
        got_y, ts = rglru.rglru_decode_step(
            _t(p), torch.from_numpy(x[:, t:t + 1]), cfg, ts)
        _close(got_y, want_y)
    for k in ("h", "conv"):
        _close(ts[k], js[k])


def test_rglru_scan_equals_its_step_loop():
    """The reference's own check, on the port: the sequence form against
    T decode steps from the same carried state."""
    _, cfg, p, x, state = _setup()
    tp = _t(p)
    y_par, s_par = rglru.rglru_apply(tp, torch.from_numpy(x), cfg,
                                     state=_t(state))
    s, ys = _t(state), []
    for t in range(T):
        y, s = rglru.rglru_decode_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                       cfg, s)
        ys.append(y)
    torch.testing.assert_close(y_par, torch.cat(ys, 1), rtol=0, atol=2e-4)
    torch.testing.assert_close(s_par["h"], s["h"], rtol=0, atol=2e-4)
    torch.testing.assert_close(s_par["conv"], s["conv"], rtol=0, atol=2e-4)


def test_rglru_gradients_match_reference():
    jcfg, cfg, p, x, state = _setup()
    w = np.random.RandomState(9).randn(B, T, cfg.d_model).astype(np.float32)

    def jloss(p_, x_, h_):
        y, s = jrglru.rglru_apply(p_, x_, jcfg,
                                  state={"h": h_, "conv": state["conv"]})
        return jnp.sum(y * w) + jnp.sum(s["h"])
    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jnp.asarray(state["h"]))

    tp = {k: v.requires_grad_() for k, v in _t(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(state["h"]).requires_grad_()
    y, s = rglru.rglru_apply(tp, tx, cfg, state={
        "h": th, "conv": torch.from_numpy(state["conv"])})
    (torch.sum(y * torch.from_numpy(w)) + torch.sum(s["h"])).backward()
    _close(tx.grad, jg[1])
    _close(th.grad, jg[2])
    for k in sorted(p):
        _close(tp[k].grad, jg[0][k])


def test_linear_scan_at_every_length():
    """h_t = a_t h_{t-1} + b_t at T = 1 .. 70 (each power of two and the
    lengths around them) against a float64 loop, at decays down to
    exp(-17) a step."""
    rs = np.random.RandomState(0)
    for n in range(1, 71):
        a = np.exp(-17 * rs.rand(2, n, 3))
        b = rs.randn(2, n, 3)
        want, h = np.zeros_like(b), np.zeros((2, 3))
        for t in range(n):
            h = a[:, t] * h + b[:, t]
            want[:, t] = h
        got = rglru.linear_scan(torch.from_numpy(a).float(),
                                torch.from_numpy(b).float())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [64, 768])
def test_sinusoidal_positions_match_reference(d):
    """The table is float64 numpy in both, cast: equal.  The traced form's
    fp32 ``10000 ** (2 i / d)`` differs from XLA's power in the last bit
    at a few i, and the angle (up to 1499 radians, whose fp32 ulp is
    1.2e-4) carries it: 1e-4."""
    np.testing.assert_array_equal(
        layers.sinusoidal_positions(1500, d).numpy(),
        np.asarray(jlayers.sinusoidal_positions(1500, d)))
    for pos in (np.int32(0), np.int32(447), np.array([3, 1499], np.int32)):
        np.testing.assert_allclose(
            layers.sinusoidal_position_at(torch.from_numpy(
                np.asarray(pos)), d).numpy(),
            np.asarray(jlayers.sinusoidal_position_at(jnp.asarray(pos), d)),
            rtol=0, atol=1e-4)
