"""Tensor-parallel serving on 4 gloo ranks, a (2, 2) ("data", "model")
mesh, against the reference's ``build_serve_step(..., model_axis=
"model")`` on a 4-device mesh with Auto axes, each in its own process:
cache 64, a prompt of 62 and 3 teacher-forced decode steps, the third
wrapping the ring to slot 0.

Reduced SmolLM (4 heads over 1 kv head, hd 64): prefill runs attention
on 2 heads a rank beside whole k and v; the cache's kv head does not
divide the model axis, so each rank holds half of head_dim and decode
sums the partial scores over the model group.  Batch 4 is batch-sharded
over the data axis (2 rows a rank); batch 1 is sequence-sharded over it
(flash-decode), beside the model axis.  Reduced Gemma-3 at 6 layers (5
sliding-window layers and a global one): 4 heads over 2 kv heads, so
prefill and the cache go head-local.  With the int8 cache (SmolLM) the
payload is sliced on head_dim and its per-(slot, kv head) scale on the
slots.

Prefill and every decode step's logits agree to 1e-5 in fp32 (int8:
within the step that a flipped rounding of a payload entry makes), and
the ranks' caches laid end to end along their sharded dims equal the
reference's cache (``cache_to_reference``).  The ``baseline`` dry-run's
argument bytes of the decode step equal the reference's
``memory_analysis()``."""
import json
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
from repro_torch.core.sharding import PSpec, Sharding  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.transformer import params_from_reference  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
D, M, CACHE, PROMPT, STEPS = 2, 2, 64, 62, 3
# (arch, batch, kv_quant)
CASES = [("smollm-135m", 4, False), ("gemma3-4b", 4, False),
         ("smollm-135m", 4, True), ("smollm-135m", 1, False)]
IDS = ["smollm-batch4", "gemma3-batch4", "smollm-batch4-int8",
       "smollm-batch1"]
ARCHS = sorted({a for a, _, _ in CASES})
LAYERS = {"gemma3-4b": 6}
REF_PARTS = 2
MESH = make_mesh((D, M), ("data", "model"))

_CFG = """
def cfg_of(arch):
    return get_config(arch).reduced(n_layers={layers}.get(arch, 2))
"""

_PORT = """
import json
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs.base import get_config
from repro_torch.core import build_serve_step
from repro_torch.core.sharding import Sharding, tree_leaves
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import Model, cache_to_reference
{cfg}
rank, inp, out, init = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size={D} * {M})
d = np.load(inp)
mesh = make_mesh(({D}, {M}), ("data", "model"))
res = {{}}
for c, (arch, batch, kv_quant) in enumerate({cases}):
    model = Model(cfg_of(arch), kv_quant=kv_quant)
    pre = f"p/{{arch}}/"
    model.load_state_dict({{k[len(pre):]: torch.from_numpy(d[k])
                           for k in d.files if k.startswith(pre)}})
    ss = build_serve_step(model, mesh, data_axes=("data",),
                          model_axis="model", batch_size=batch,
                          cache_len={cache})
    prompt = torch.from_numpy(d[f"prompt{{batch}}"])
    logits, cache = ss.prefill_fn({{"tokens": ss.local_rows(prompt)}})
    res[f"{{c}}/logits0"] = logits.numpy()
    for s in range({steps}):
        tok = ss.local_rows(torch.from_numpy(d[f"tokens{{batch}}"][:, s:s + 1]))
        logits, cache = ss.decode_fn(tok, cache, {prompt} + s)
        res[f"{{c}}/logits{{s + 1}}"] = logits.numpy()
    for i, (t, sh) in enumerate(zip(
            tree_leaves(cache_to_reference(cache),
                        lambda x: isinstance(x, np.ndarray)),
            tree_leaves(ss.cache_shardings,
                        lambda x: isinstance(x, Sharding)))):
        res[f"{{c}}/cache{{i}}"] = t
        res[f"{{c}}/spec{{i}}"] = np.asarray(json.dumps(list(sh.spec)))
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
inp, out, part = sys.argv[1], sys.argv[2], int(sys.argv[3])
d = np.load(inp, allow_pickle=True)
mesh = jax.make_mesh(({D}, {M}), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
res = {{}}
for c, (arch, batch, kv_quant) in enumerate({cases}):
    if c % {parts} != part:
        continue
    tree = d["tree/" + arch].item()
    model = build_model(cfg_of(arch), kv_quant=kv_quant)
    ss = build_serve_step(model, mesh, data_axes=("data",),
                          model_axis="model", batch_size=batch,
                          cache_len={cache})
    params = jax.tree.map(lambda a, sh: jax.device_put(jnp.asarray(a), sh),
                          tree, ss.param_shardings)
    if c == 0:
        token, cache, pos = ss.make_inputs("decode", {cache})
        res["argument_bytes"] = np.asarray(ss.decode_fn.lower(
            params, token, cache, pos).compile().memory_analysis()
            .argument_size_in_bytes)
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


def _jcfg(arch):
    return jget_config(arch).reduced(n_layers=LAYERS.get(arch, 2))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serve")
    inp = str(tmp / "inputs.npz")
    saved = {}
    for arch in ARCHS:
        tree = jax.tree.map(np.asarray,
                            jbuild_model(_jcfg(arch)).init(
                                jax.random.PRNGKey(0)))
        saved["tree/" + arch] = np.asarray(tree, dtype=object)
        saved.update({f"p/{arch}/{k}": v.numpy()
                      for k, v in params_from_reference(tree).items()})
    vocab = min(_jcfg(a).vocab_size for a in ARCHS)
    rs = np.random.RandomState(0)
    for batch in (1, 4):
        saved[f"prompt{batch}"] = rs.randint(
            0, vocab, (batch, PROMPT)).astype(np.int32)
        saved[f"tokens{batch}"] = rs.randint(
            0, vocab, (batch, STEPS)).astype(np.int32)
    np.savez(inp, **saved)
    fmt = dict(D=D, M=M, cache=CACHE, prompt=PROMPT, steps=STEPS,
               cases=repr(CASES), parts=REF_PARTS)
    fmt["cfg"] = _CFG.format(layers=repr(LAYERS))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE.format(**fmt)),
         inp, str(tmp / f"reference{i}.npz"), str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={D * M}",
                 JAX_PLATFORMS="cpu")) for i in range(REF_PARTS)]
    for r in range(D * M):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_PORT.format(**fmt)),
             str(r), inp, str(tmp / f"port{r}.npz"), f"file://{tmp}/pg"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(OMP_NUM_THREADS="1")))
    for p in procs:
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-3000:]
    ref = {}
    for i in range(REF_PARTS):
        ref.update(np.load(tmp / f"reference{i}.npz"))
    return ref, [np.load(tmp / f"port{r}.npz") for r in range(D * M)]


def _rows(ports, key, batch):
    """The global rows: each data rank's (ranks 0 and 2 hold data
    coordinates 0 and 1), or every rank the whole batch."""
    if batch % D:
        return ports[0][key]
    return np.concatenate([ports[0][key], ports[M][key]])


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_tp_prefill_and_decode_logits_match_the_reference(results, case):
    ref, ports = results
    _, batch, kv_quant = CASES[case]
    for s in range(STEPS + 1):
        want = ref[f"{case}/logits{s}"]
        # the ranks of a model group return the same, whole logits
        for r in range(0, D * M, M):
            np.testing.assert_array_equal(ports[r][f"{case}/logits{s}"],
                                          ports[r + 1][f"{case}/logits{s}"])
        got = _rows(ports, f"{case}/logits{s}", batch)
        tol = 1e-5 if not kv_quant or s == 0 else 1e-3
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_tp_gathered_cache_equals_the_reference(results, case):
    """Each rank's slice (its rows or ring slots over the data axis, its
    kv heads or head_dim half over the model axis), laid end to end, is
    the reference's cache; int8 payloads bit for bit but for entries at a
    rounding tie, which may move one step."""
    ref, ports = results
    arch, batch, kv_quant = CASES[case]
    n = sum(k.startswith(f"{case}/cache") for k in ref)
    assert n == (4 if kv_quant else 2) * (1 if arch == "smollm-135m" else 6)
    for i in range(n):
        want = ref[f"{case}/cache{i}"]
        spec = PSpec(*(tuple(e) if isinstance(e, list) else e for e in
                       json.loads(str(ports[0][f"{case}/spec{i}"]))))
        got = np.zeros_like(want)
        for r, p in enumerate(ports):
            part = p[f"{case}/cache{i}"]
            where = tuple(slice(k * n, (k + 1) * n) for (k, _), n in zip(
                Sharding(MESH, spec).index(r), part.shape))
            got[where] = part
        assert got.shape == want.shape
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want)
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        else:
            np.testing.assert_allclose(got.astype(np.float32),
                                       want.astype(np.float32), rtol=1e-5,
                                       atol=1e-5)


def test_tp_cache_layout(results):
    """SmolLM's ring (L, B, S, 1, 64) is halved on head_dim, Gemma-3's
    (1, B, S, 2, 64) on its kv heads; the int8 scales (.., 1, 1) of SmolLM
    on the slots."""
    _, ports = results
    p = ports[0]
    assert p["0/cache0"].shape == (2, 2, CACHE, 1, 32)
    assert p["1/cache0"].shape == (1, 2, CACHE, 1, 64)
    shapes = sorted(p[f"2/cache{i}"].shape for i in range(4))
    assert shapes == [(2, 2, CACHE // 2, 1, 1)] * 2 + \
        [(2, 2, CACHE, 1, 32)] * 2
    assert p["3/cache0"].shape == (2, 1, CACHE // 2, 1, 32)


def test_baseline_dryrun_decode_bytes_equal_the_reference(results):
    """The ``baseline`` dry-run of SmolLM's decode step on the (2, 2) mesh
    (batch 4, cache 64): the parameter, token, cache and position slices
    a rank holds, byte for byte the reference's ``memory_analysis()``."""
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    ref, _ = results
    res = dryrun.dryrun_one(
        "smollm-135m", "small", profile="baseline", save=False,
        mesh=make_mesh((D, M), ("data", "model")),
        config=get_config("smollm-135m").reduced(),
        input_shape=InputShape("small", CACHE, 4, "decode"))
    assert res["memory"]["argument_bytes"] == int(ref["argument_bytes"])


def test_serve_entry_point_runs_tp_on_four_ranks():
    """``launch.serve --mesh 2x2`` decodes reduced SmolLM on 4 CPU ranks,
    the same tokens as one rank."""
    def run(*extra):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "smollm-135m", "--reduced", "--device", "cpu", "--batch", "4",
             "--prompt-len", "16", "--decode-tokens", "4", *extra],
            capture_output=True, text=True, timeout=300,
            env=_env(OMP_NUM_THREADS="1"))
        assert out.returncode == 0, out.stderr[-3000:]
        return [line for line in out.stdout.splitlines()
                if line.startswith("sample")]
    assert run("--world-size", "4", "--mesh", "2x2") == run()
