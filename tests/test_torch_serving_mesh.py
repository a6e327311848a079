"""Serving over a data mesh on 4 gloo ranks against the reference's
``build_serve_step`` on a 4-device ``("data",)`` mesh with Auto axes
(``model_axis=None``), each in its own process: reduced SmolLM (fp32),
cache 64, a prompt of 62 and 3 teacher-forced decode steps, the third
wrapping the ring to slot 0.

Batch 4 is batch-sharded (one row a rank); batch 1 is sequence-sharded
(16 ring slots a rank, decode attention through flash-decode), also with
the int8 KV cache.  Reduced Gemma-3 (a block of its 2-layer pattern and
1 ``tail`` layer) adds sliding-window rings, one kept as a tail leaf
whose batch the port shards at dim 0; reduced RecurrentGemma (a block of
(RG-LRU, RG-LRU, local) and 1 tail RG-LRU) adds RG-LRU states sharded
along their width (gathered for each step), and conv states that divide
nowhere but a tail one's width.
Prefill and every decode step's logits agree to 1e-5 and the ranks'
caches, laid end to end along their sharded dim, equal the reference's
cache (bit for bit for the int8 payloads, to 1e-5 otherwise)."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models.transformer import build_model as jbuild_model  # noqa: E402
from repro_torch.models.transformer import params_from_reference  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
W, CACHE, PROMPT, STEPS = 4, 64, 62, 3
# (arch, batch, kv_quant)
CASES = [("smollm-135m", 4, False), ("smollm-135m", 1, False),
         ("smollm-135m", 1, True), ("gemma3-4b", 4, False),
         ("gemma3-4b", 1, False), ("recurrentgemma-2b", 1, False)]
IDS = ["batch4", "batch1", "batch1-int8", "gemma3-batch4", "gemma3-batch1",
       "rglru-batch1"]
ARCHS = sorted({a for a, _, _ in CASES})
# (reduced depth, depth): one pattern block and one tail layer
DEPTH = {"gemma3-4b": (2, 3), "recurrentgemma-2b": (3, 4)}
_CFG = """
import dataclasses


def cfg_of(arch):
    if arch not in {depth}:
        return get_config(arch).reduced()
    n, total = {depth}[arch]
    return dataclasses.replace(get_config(arch).reduced(n_layers=n),
                               n_layers=total)
"""

_PORT = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs.base import get_config
from repro_torch.core import build_serve_step
from repro_torch.core.sharding import tree_leaves
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import Model
{cfg}
rank, inp, out, init = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size={W})
d = np.load(inp)
mesh = make_mesh(({W},), ("data",))
res = {{}}
for c, (arch, batch, kv_quant) in enumerate({cases}):
    model = Model(cfg_of(arch), kv_quant=kv_quant)
    pre = f"p/{{arch}}/"
    model.load_state_dict({{k[len(pre):]: torch.from_numpy(d[k])
                           for k in d.files if k.startswith(pre)}})
    ss = build_serve_step(model, mesh, batch_size=batch, cache_len={cache})
    prompt = torch.from_numpy(d[f"prompt{{batch}}"])
    logits, cache = ss.prefill_fn({{"tokens": ss.local_rows(prompt)}})
    res[f"{{c}}/logits0"] = logits.numpy()
    for s in range({steps}):
        tok = ss.local_rows(torch.from_numpy(d[f"tokens{{batch}}"][:, s:s + 1]))
        logits, cache = ss.decode_fn(tok, cache, {prompt} + s)
        res[f"{{c}}/logits{{s + 1}}"] = logits.numpy()
    for i, t in enumerate(tree_leaves(cache, lambda x: isinstance(
            x, torch.Tensor))):
        res[f"{{c}}/cache{{i}}"] = t.numpy()
np.savez(out, **res)
dist.barrier()
dist.destroy_process_group()
"""

_REFERENCE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.base import get_config
from repro.core import build_serve_step
from repro.models.transformer import build_model
{cfg}
inp, out = sys.argv[1], sys.argv[2]
d = np.load(inp, allow_pickle=True)
mesh = jax.make_mesh(({W},), ("data",), axis_types=(AxisType.Auto,))
res = {{}}
for c, (arch, batch, kv_quant) in enumerate({cases}):
    tree = d["tree/" + arch].item()
    model = build_model(cfg_of(arch), kv_quant=kv_quant)
    ss = build_serve_step(model, mesh, data_axes=("data",), model_axis=None,
                          batch_size=batch, cache_len={cache})
    params = jax.tree.map(lambda a, sh: jax.device_put(jnp.asarray(a), sh),
                          tree, ss.param_shardings)
    logits, cache = ss.prefill_fn(params, {{"tokens": jnp.asarray(
        d[f"prompt{{batch}}"])}})
    res[f"{{c}}/logits0"] = np.asarray(logits)
    for s in range({steps}):
        tok = jnp.asarray(d[f"tokens{{batch}}"][:, s:s + 1])
        logits, cache = ss.decode_fn(params, tok, cache,
                                     jnp.asarray({prompt} + s, jnp.int32))
        res[f"{{c}}/logits{{s + 1}}"] = np.asarray(logits)
    for i, t in enumerate(jax.tree.leaves(cache)):
        res[f"{{c}}/cache{{i}}"] = np.asarray(t)
np.savez(out, **res)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving_mesh")
    inp = str(tmp / "inputs.npz")
    saved = {}
    for arch in ARCHS:
        cfg = jget_config(arch).reduced()
        if arch in DEPTH:
            n, total = DEPTH[arch]
            cfg = dataclasses.replace(jget_config(arch).reduced(n_layers=n),
                                      n_layers=total)
        tree = jax.tree.map(np.asarray,
                            jbuild_model(cfg).init(jax.random.PRNGKey(0)))
        saved["tree/" + arch] = np.asarray(tree, dtype=object)
        saved.update({f"p/{arch}/{k}": v.numpy()
                      for k, v in params_from_reference(tree).items()})
    vocab = min(jget_config(a).reduced().vocab_size for a in ARCHS)
    rs = np.random.RandomState(0)
    for batch in (1, 4):
        saved[f"prompt{batch}"] = rs.randint(
            0, vocab, (batch, PROMPT)).astype(np.int32)
        saved[f"tokens{batch}"] = rs.randint(
            0, vocab, (batch, STEPS)).astype(np.int32)
    np.savez(inp, **saved)
    fmt = dict(W=W, cache=CACHE, prompt=PROMPT, steps=STEPS,
               cases=repr(CASES))
    fmt["cfg"] = _CFG.format(depth=repr(DEPTH))
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
            env=_env(OMP_NUM_THREADS="1")))
    for p in procs:
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-3000:]
    return (np.load(tmp / "reference.npz"),
            [np.load(tmp / f"port{r}.npz") for r in range(W)])


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_prefill_and_decode_logits_match_the_reference(results, case):
    ref, ports = results
    _, batch, _ = CASES[case]
    for s in range(STEPS + 1):
        want = ref[f"{case}/logits{s}"]
        if batch == W:      # batch-sharded: each rank its row
            got = np.concatenate([p[f"{case}/logits{s}"] for p in ports])
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:               # sequence-sharded: every rank the whole batch
            for p in ports:
                np.testing.assert_allclose(p[f"{case}/logits{s}"], want,
                                           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_gathered_cache_equals_the_reference(results, case):
    """Each rank holds exactly a quarter of every leaf (of SmolLM's stacked
    leaves: the batch at dim 1 batch-sharded, the ring at dim 2
    sequence-sharded); the quarters laid end to end are the reference's
    cache."""
    ref, ports = results
    arch, batch, kv_quant = CASES[case]
    n = sum(k.startswith(f"{case}/cache") for k in ref.files)
    if arch == "smollm-135m":
        assert n == (4 if kv_quant else 2)
    for i in range(n):
        want = ref[f"{case}/cache{i}"]
        parts = [p[f"{case}/cache{i}"] for p in ports]
        dims = [d for d, (a, b) in enumerate(zip(parts[0].shape,
                                                 want.shape)) if a != b]
        if arch == "smollm-135m":
            assert dims == [1 if batch == W else 2]
        if not dims:        # no dim divides: every rank holds it whole
            assert all(np.array_equal(q, parts[0]) for q in parts)
            got = parts[0]
        else:
            (dim,) = dims
            assert parts[0].shape[dim] * W == want.shape[dim]
            got = np.concatenate(parts, axis=dim)
        if got.dtype == np.int8:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got.astype(np.float32),
                                       want.astype(np.float32), rtol=1e-5,
                                       atol=1e-5)


def test_model_axis_is_refused():
    """A model axis of 2 (on a fake process group of 2 ranks, meta
    tensors): the dense LM serves with its leaves and its ring halved
    (one kv head: head_dim 64 -> 32); so do the other families, MoE's
    ring and RWKV's state S on its first N dim (32 -> 16), refusing
    nothing."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import build_serve_step
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    mesh = make_mesh((1, 2), ("data", "model"))
    with fake_group(2):
        model = Model(get_config("smollm-135m").reduced(), device="meta")
        ss = build_serve_step(model, mesh, model_axis="model", batch_size=1,
                              cache_len=8)
        assert model.embed.table.shape == (256, 256)
        token, cache, _ = ss.make_inputs("decode", 8)
        assert cache["blocks"][0]["k"].shape == (2, 1, 8, 1, 32)
        for arch, leaf, shape in (("mixtral-8x7b", "k", (2, 1, 8, 1, 32)),
                                  ("rwkv6-7b", "S", (2, 1, 8, 16, 32))):
            model = Model(get_config(arch).reduced(), device="meta")
            ss = build_serve_step(model, mesh, model_axis="model",
                                  batch_size=1, cache_len=8)
            _, cache, _ = ss.make_inputs("decode", 8)
            assert cache["blocks"][0][leaf].shape == shape
