"""Parity of the port's ``QuantizedScatterReduce`` (``core.compression``)
with the JAX reference on the CPU: the int8 quantizer bit for bit, the
wire-byte formula, two syncs over two and three gloo ranks against the
reference on as many host devices (subprocesses, the pattern of
test_torch_strategies_multirank.py), and training that lowers the loss.

The reference always runs its sync compiled, and XLA compiles it with
two rewrites that the port performs by hand: a division by a constant
becomes a product with the constant's fp32 reciprocal (``max / 127.0``,
``sum / W``), and ``a + q * s`` becomes one fused multiply-add (the
residual, the reduction over ranks).  The quantizer is therefore held
against the compiled ``_quant``; ``test_compiled_quant_differs_from_eager``
shows that the eager one divides and can land one ulp away."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.core import get_strategy as jget_strategy  # noqa: E402
from repro.core.compression import _dequant as jdequant  # noqa: E402
from repro.core.compression import _quant as jquant  # noqa: E402
from repro.serverless.archs import \
    COMPRESSION_SCHEMES as JCOMPRESSION_SCHEMES  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import build_train_step, get_strategy  # noqa: E402
from repro_torch.core.compression import (QuantizedScatterReduce,  # noqa: E402
                                          _dequant, _quant)
from repro_torch.data import cifar_like  # noqa: E402
from repro_torch.models import build_cnn  # noqa: E402
from repro_torch.serverless.archs import (COMPRESSION_SCHEMES,  # noqa: E402
                                          get_arch)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# W x 512 floats fill whole rows: (1024,) needs no padding at W = 2 and
# (1536,) none at W = 3; the other leaves leave a padded tail, and the
# zeros leaf quantizes all-zero rows
LEAF_SHAPES = [(3, 3, 1, 40), (1024,), (1536,), (1500,), (16, 16), (7,),
               (2, 515), (600,)]
ZERO_LEAF = 7


def _rows(case):
    rs = np.random.RandomState(5)
    if case == "randn":
        return rs.randn(4, 3, 512).astype(np.float32)
    if case == "lognormal":
        return (rs.randn(4, 3, 512) * rs.lognormal(0, 4, (4, 3, 512))
                ).astype(np.float32)
    if case == "ties":
        # max |x| = 127 s gives scale = s exactly, so x / scale lands on
        # k + 0.5: round half to even on both sides
        s = np.float32(0.25)
        k = rs.randint(-126, 126, (4, 3, 512)).astype(np.float32)
        x = (k + np.float32(0.5)) * s
        x[..., 0] = 127 * s
        return x.astype(np.float32)
    if case == "zero_row":
        x = rs.randn(4, 3, 512).astype(np.float32)
        x[1, 2] = 0.0
        x[3] = 0.0
        return x
    if case == "tiny":
        return (rs.randn(4, 3, 512) * 1e-36).astype(np.float32)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["randn", "lognormal", "ties", "zero_row",
                                  "tiny"])
def test_quant_dequant_bit_exact(case):
    x = _rows(case)
    jq, js = jax.jit(jquant)(jnp.asarray(x))
    q, s = _quant(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_dequant(q, s).numpy(),
                                  np.asarray(jdequant(jq, js)))
    if case == "ties":
        assert np.any(np.abs(x / s.numpy() % 1) == 0.5)
    if case == "zero_row":
        assert not q[3].any() and float(s[3].max()) == np.float32(1e-30)


def test_compiled_quant_differs_from_eager():
    """XLA's rewrite of ``max / 127.0``: eager, the reference divides
    (torch's true division agrees); compiled, it multiplies by
    fp32(1/127), and some scales move by one ulp.  The port follows the
    compiled form, the one every reference sync runs."""
    x = jnp.asarray(_rows("lognormal"))
    _, eager = jquant(x)
    _, compiled = jax.jit(jquant)(x)
    amax = np.abs(np.asarray(x)).max(-1, keepdims=True)
    np.testing.assert_array_equal(np.asarray(eager),
                                  np.maximum(amax / np.float32(127),
                                             np.float32(1e-30)))
    np.testing.assert_array_equal(np.asarray(compiled),
                                  amax * np.float32(1 / 127))
    moved = np.asarray(eager) != np.asarray(compiled)
    assert moved.any()
    ulp = np.spacing(np.asarray(eager)[moved])
    np.testing.assert_array_equal(
        np.abs(np.asarray(eager) - np.asarray(compiled))[moved], ulp)


@pytest.mark.parametrize("n_workers", [2, 4, 16])
def test_comm_bytes_match_reference_and_int8_scheme(n_workers):
    """The strategy's formula equals the reference's, and bills exactly
    the per-byte factor of the registry's int8 scheme in both packages."""
    grads = [np.zeros(s, np.float32) for s in LEAF_SHAPES]
    G = sum(g.nbytes for g in grads)
    port = get_strategy("quantized_scatterreduce")
    assert port.comm_bytes(grads, n_workers) == \
        jget_strategy("quantized_scatterreduce").comm_bytes(grads, n_workers)
    assert port.comm_bytes([torch.from_numpy(g) for g in grads],
                           n_workers) == port.comm_bytes(grads, n_workers)
    for schemes in (COMPRESSION_SCHEMES, JCOMPRESSION_SCHEMES):
        assert port.comm_bytes(grads, n_workers) == int(
            2 * G * schemes["int8"](0.3) * (n_workers - 1) / n_workers)


_PORT = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.core import get_strategy

rank, inp, out, init = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
W, n = {W}, {n}
d = np.load(inp)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=W)
s = get_strategy("quantized_scatterreduce")
res = {{}}
state = None
for step in (0, 1):
    grads = [torch.from_numpy(d[f"g{{step}}_{{rank}}_{{i}}"])
             for i in range(n)]
    if state is None:
        state = s.init_state(grads)
    synced, state, _ = s.sync(grads, state)
    for i in range(n):
        res[f"{{step}}/out/{{i}}"] = synced[i].numpy()
        res[f"{{step}}/resid/{{i}}"] = state[i].numpy()
np.savez(out, **res)
dist.destroy_process_group()
"""

_REFERENCE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.core import get_strategy

inp, out = sys.argv[1], sys.argv[2]
W, n = {W}, {n}
d = np.load(inp)
mesh = jax.make_mesh((W,), ("data",))
s = get_strategy("quantized_scatterreduce")


def body(g, st):
    o, new, _ = s.sync([x[0] for x in g], [x[0] for x in st], "data")
    return [x[None] for x in o], [x[None] for x in new]


fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=(P("data"), P("data")),
                       axis_names={{"data"}}))
res = {{}}
state = None
for step in (0, 1):
    grads = [jnp.asarray(np.stack([d[f"g{{step}}_{{r}}_{{i}}"]
                                   for r in range(W)])) for i in range(n)]
    if state is None:
        state = [jnp.zeros(g.shape, jnp.float32) for g in grads]
    synced, state = fn(grads, state)
    for i in range(n):
        res[f"{{step}}/out/{{i}}"] = np.asarray(synced[i])
        res[f"{{step}}/resid/{{i}}"] = np.asarray(state[i])
np.savez(out, **res)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module", params=[2, 3], ids=["W2", "W3"])
def results(tmp_path_factory, request):
    W = request.param
    tmp = tmp_path_factory.mktemp(f"qsr{W}")
    inp = str(tmp / "inputs.npz")
    rs = np.random.RandomState(11)
    arrays = {}
    for step in (0, 1):
        for r in range(W):
            for i, s in enumerate(LEAF_SHAPES):
                g = rs.randn(*s) * rs.lognormal(size=s)
                arrays[f"g{step}_{r}_{i}"] = (
                    g * (i != ZERO_LEAF)).astype(np.float32)
    np.savez(inp, **arrays)
    fmt = dict(W=W, n=len(LEAF_SHAPES))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE.format(**fmt)),
         inp, str(tmp / "reference.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={W}",
                 JAX_PLATFORMS="cpu"))]
    for r in range(W):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_PORT.format(**fmt)),
             str(r), inp, str(tmp / f"port{r}.npz"), f"file://{tmp}/pg"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(OMP_NUM_THREADS="2")))
    for p in procs:
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-3000:]
    return (np.load(tmp / "reference.npz"),
            [np.load(tmp / f"port{r}.npz") for r in range(W)])


@pytest.mark.parametrize("leaf", range(len(LEAF_SHAPES)),
                         ids=[str(s) for s in LEAF_SHAPES])
def test_two_rank_sync_matches_reference_bit_for_bit(results, leaf):
    """Two syncs in a row (the second feeds the first's residual back):
    every rank's synced output and new residual equal the reference's,
    padded tails and all-zero rows included.  W = 3 takes the
    reciprocal of a divisor that is not a power of two."""
    ref, ports = results
    for r, port in enumerate(ports):
        for step in (0, 1):
            for what in ("out", "resid"):
                key = f"{step}/{what}/{leaf}"
                assert port[key].shape == LEAF_SHAPES[leaf]
                np.testing.assert_array_equal(port[key], ref[key][r])
    if leaf == ZERO_LEAF:
        assert not ports[0][f"1/out/{ZERO_LEAF}"].any()


@pytest.fixture
def group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    yield None
    dist.destroy_process_group()


def test_one_rank_round_trip_is_double_quantized(group):
    """W = 1: output = the input quantized twice, and output + residual
    is the input to two quantization steps."""
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 515)
                         .astype(np.float32))
    qsr = QuantizedScatterReduce()
    (out,), (resid,), _ = qsr.sync([x], qsr.init_state([x]))
    step = float(x.abs().max()) / 127.0
    torch.testing.assert_close(out, x, rtol=0, atol=2 * step + 1e-6)
    torch.testing.assert_close(out + resid, x, rtol=0, atol=2 * step + 1e-6)


@pytest.mark.parametrize("how", ["quantized_scatterreduce",
                                 "arch:scatterreduce_q8",
                                 "arch:async_spirt_q8"])
def test_reduced_mobilenet_trains_under_int8_sync(group, how):
    """The criterion of the reference's compression convergence tests:
    5 steps on a fixed batch lower the loss."""
    strategy = get_arch(how[5:]).make_strategy() \
        if how.startswith("arch:") else get_strategy(how)
    assert isinstance(strategy, QuantizedScatterReduce)
    torch.manual_seed(0)
    model = build_cnn(get_config("mobilenet-cifar").reduced(), device="cpu")
    ts = build_train_step(model, optim.sgd(0.05, momentum=0.9), strategy)
    images, labels = cifar_like(32, seed=0)
    batch = {"images": torch.from_numpy(images),
             "labels": torch.from_numpy(labels)}
    state = ts.init_state()
    losses = []
    for _ in range(5):
        state, m = ts.step_fn(state, batch)
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
