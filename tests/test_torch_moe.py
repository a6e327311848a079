"""Parity of the port's MoE layer (``models.moe``) with the JAX reference on
the CPU, at reduced width (Mixtral reduced: 4 experts, top 2, fp32): the
output and the load-balance loss to 1e-5, the dispatch (which slots keep
their place in their expert's buffer) exactly, at the default capacity
factor 1.25, at 0.5 where tokens are dropped, and with a zero router,
where every probability ties and the lower expert indices must win; the
gradients against ``jax.grad``; and the expert-parallel form on 4 gloo
ranks against the reference's ``moe_apply`` on each rank's shard, atol
2e-5 (the reference's own bar, ``tests/test_moe_ep.py``)."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
TOL = 1e-5


def _cfgs(**kw):
    return (dataclasses.replace(jget_config("mixtral-8x7b").reduced(), **kw),
            dataclasses.replace(get_config("mixtral-8x7b").reduced(), **kw))


def _params(jcfg, zero_router=False, seed=0):
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed),
                                              jcfg, jnp.float32))
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    return p


def _x(B, S, d, seed=1):
    return (0.3 * np.random.RandomState(seed).randn(B, S, d)) \
        .astype(np.float32)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jkeep(p, x, cfg):
    """The reference's keep mask, from its own routing lines."""
    T = x.shape[0] * x.shape[1]
    E, k = cfg.n_experts, cfg.experts_per_token
    probs = jax.nn.softmax(jnp.asarray(x).reshape(T, -1) @ p["router"], -1)
    _, idx = jax.lax.top_k(probs, k)
    eh = jax.nn.one_hot(idx.reshape(T * k), E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(eh, axis=0) - eh) * eh, axis=-1)
    return np.asarray(pos < jmoe_capacity(cfg, T)), np.asarray(idx)


def jmoe_capacity(cfg, T):
    c = int(cfg.capacity_factor * cfg.experts_per_token * T
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


CASES = {"default": dict(kw={}, zero=False, B=2, S=24),
         "drops": dict(kw={"capacity_factor": 0.5}, zero=False, B=2, S=24),
         "ties": dict(kw={"capacity_factor": 0.5}, zero=True, B=2, S=12)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_reference(case):
    c = CASES[case]
    jcfg, cfg = _cfgs(**c["kw"])
    p = _params(jcfg, c["zero"])
    x = _x(c["B"], c["S"], cfg.d_model)
    want_y, want_aux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x), jcfg)
    got_y, got_aux = moe.moe_apply(_t(p), torch.from_numpy(x), cfg)
    _close(got_y, want_y)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=TOL)

    T = c["B"] * c["S"]
    assert moe.capacity(cfg, T) == jmoe_capacity(cfg, T)
    jkeep, jidx = _jkeep(p, x, cfg)
    gate, dest, keep, buf, C, _ = moe._route(
        _t(p), torch.from_numpy(x).reshape(T, -1), cfg)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    # a kept slot's row lies in its expert's buffer
    np.testing.assert_array_equal((dest // C).numpy()[jkeep],
                                  jidx.reshape(-1)[jkeep])
    if case == "default":
        assert keep.all()
    else:
        assert not keep.all()       # capacity 0.5 drops slots
    if c["zero"]:
        # every probability ties: experts 0 and 1 for every token
        assert (jidx == [0, 1]).all()


def test_moe_gradients_match_reference():
    """d/dx and d/dparams of sum(y * w) + aux, the capacity dropping."""
    jcfg, cfg = _cfgs(capacity_factor=0.5)
    p = _params(jcfg)
    x = _x(2, 24, cfg.d_model)
    w = np.random.RandomState(5).randn(*x.shape).astype(np.float32)

    def jloss(p_, x_):
        y, aux = jmoe.moe_apply(p_, x_, jcfg)
        return jnp.sum(y * w) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))

    tp = {k: v.requires_grad_() for k, v in _t(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply(tp, tx, cfg)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    _close(tx.grad, jgx)
    for k in sorted(p):
        _close(tp[k].grad, jgp[k])


def test_expert_ffn_chunks_by_2048_only_where_it_divides():
    """A capacity of 4096 runs in two chunks of 2048, one of 2056 in one
    shot: both equal the unchunked product."""
    jcfg, cfg = _cfgs()
    p = _t(_params(jcfg))
    rs = np.random.RandomState(3)
    for C in (4096, 2056):
        buf = torch.from_numpy(rs.randn(cfg.n_experts, C, cfg.d_model)
                               .astype(np.float32) * 0.1)
        got = moe._expert_ffn_chunked(p, buf)
        want = moe._ffn(buf, p["w_gate"], p["w_up"], p["w_down"])
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# expert parallelism on 4 gloo ranks
# ---------------------------------------------------------------------------
_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
import dataclasses
from repro_torch.configs import get_config
from repro_torch.models import moe

rank, W, inp, out, init = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4], sys.argv[5])
d = np.load(inp)
cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                          n_experts=4, experts_per_token=2)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=W)
p = {k: torch.from_numpy(d[k]) for k in ("router", "w_gate", "w_up",
                                         "w_down")}
B = d["x"].shape[0] // W
x = torch.from_numpy(d["x"][rank * B:(rank + 1) * B].copy())
x.requires_grad_()
y, aux = moe.moe_apply_ep(p, x, cfg)
w = torch.from_numpy(d["w"][rank * B:(rank + 1) * B].copy())
torch.sum(y * w).backward()
np.savez(out, y=y.detach().numpy(), aux=aux.detach().numpy(),
         gx=x.grad.numpy())
dist.destroy_process_group()
"""


@pytest.mark.parametrize("W", [4, 2])
def test_moe_apply_ep_on_gloo_ranks_matches_reference(tmp_path, W):
    """The reference test's set-up (reduced Mixtral, 4 experts, B 8 x S 16
    split over the ranks) on 4 ranks (one expert a rank) and on 2 (two,
    so each exchanged block holds several experts' buffers): each rank's
    output, aux and input gradient against the reference's
    ``moe_apply`` and ``jax.grad`` on its shard; the gradient crosses
    both exchanges backwards."""
    jcfg, _ = _cfgs(n_experts=4, experts_per_token=2)
    p = _params(jcfg)
    x = _x(8, 16, jcfg.d_model)
    w = np.random.RandomState(6).randn(*x.shape).astype(np.float32)
    inp = str(tmp_path / "inputs.npz")
    np.savez(inp, x=x, w=w, **p)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r), str(W), inp,
         str(tmp_path / f"rank{r}.npz"), f"file://{tmp_path}/pg"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(W)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    jp = jax.tree.map(jnp.asarray, p)
    B = x.shape[0] // W
    for r in range(W):
        got = np.load(tmp_path / f"rank{r}.npz")
        xs, ws = jnp.asarray(x[r * B:(r + 1) * B]), w[r * B:(r + 1) * B]
        want_y, want_aux = jmoe.moe_apply(jp, xs, jcfg)
        np.testing.assert_allclose(got["y"], np.asarray(want_y), atol=2e-5)
        np.testing.assert_allclose(float(got["aux"]), float(want_aux),
                                   rtol=TOL)
        want_gx = jax.grad(lambda x_: jnp.sum(
            jmoe.moe_apply(jp, x_, jcfg)[0] * ws))(xs)
        np.testing.assert_allclose(got["gx"], np.asarray(want_gx),
                                   atol=2e-5)


def test_moe_apply_ep_on_one_rank_equals_moe_apply(tmp_path):
    """One rank owns every expert: the exchanges are copies, and the
    result is ``moe_apply``'s bit for bit."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        jcfg, cfg = _cfgs(capacity_factor=0.5)
        p = _t(_params(jcfg))
        x = torch.from_numpy(_x(2, 24, cfg.d_model))
        y, aux = moe.moe_apply_ep(p, x, cfg)
        want_y, want_aux = moe.moe_apply(p, x, cfg)
        assert torch.equal(y, want_y) and torch.equal(aux, want_aux)
    finally:
        dist.destroy_process_group()
