"""Tensor-parallel serving of the other families on 4 gloo ranks, a (2, 2)
("data", "model") mesh, against the reference's ``build_serve_step(...,
model_axis="model")`` on a 4-device mesh with Auto axes, each in its own
process: cache 64, a prompt of 62 (8 stub patches for Pixtral, 32 stub
frames for Whisper) and 3 teacher-forced decode steps, the third wrapping
the ring to slot 0; fp32, reduced configs.

* Mixtral 8x7B (batch 4, and batch 4 with the int8 cache): the experts on
  each rank's d_ff slice, the router whole; the ring's single kv head
  split on head_dim.
* RWKV6 (batch 4, and batch 1, sequence-sharded over the data axis):
  prefill's WKV on 4 of 8 heads a rank; the decode state S (L, B, H, N,
  N) sharded on its first N dim, which decode advances slice by slice.
* RecurrentGemma at 5 layers: one (RG-LRU, RG-LRU, local) block and a
  tail of two RG-LRU layers, whose ``h`` the reference puts on the data
  axis (channels) and the port holds on its rows, whole over the model
  group.
* Whisper-small: ``enc_kv`` on its kv heads.
* Pixtral: the dense route with its patch inputs.

Prefill and every decode step's logits agree to 1e-5 (int8: within the
step a flipped rounding of a payload entry makes, as
``test_torch_tp_serve.py`` holds it), the ranks return the same logits
within a model group, and the ranks' caches laid end to end along their
sharded dims (RWKV's S and the RG-LRU's h and conv included) equal the
reference's."""
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
CASES = [("mixtral-8x7b", 4, False), ("mixtral-8x7b", 4, True),
         ("rwkv6-7b", 4, False), ("rwkv6-7b", 1, False),
         ("recurrentgemma-2b", 4, False), ("whisper-small", 4, False),
         ("pixtral-12b", 4, False)]
IDS = ["mixtral", "mixtral-int8", "rwkv", "rwkv-batch1", "rglru5",
       "whisper", "pixtral"]
ARCHS = sorted({a for a, _, _ in CASES})
LAYERS = {"recurrentgemma-2b": 5}
REF_PARTS = 3
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
    pre = f"in/{{arch}}/{{batch}}/"
    logits, cache = ss.prefill_fn({{
        k[len(pre):]: ss.local_rows(torch.from_numpy(d[k]))
        for k in d.files if k.startswith(pre)}})
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
    pre = f"in/{{arch}}/{{batch}}/"
    logits, cache = ss.prefill_fn(params, {{
        k[len(pre):]: jnp.asarray(d[k]) for k in d.files
        if k.startswith(pre)}})
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
    from repro_torch.launch.train import stub_inputs
    tmp = tmp_path_factory.mktemp("tp_families_serve")
    inp = str(tmp / "inputs.npz")
    saved = {}
    vocab = min(_jcfg(a).vocab_size for a in ARCHS)
    rs = np.random.RandomState(0)
    for batch in (1, 4):
        saved[f"prompt{batch}"] = rs.randint(
            0, vocab, (batch, PROMPT)).astype(np.int32)
        saved[f"tokens{batch}"] = rs.randint(
            0, vocab, (batch, STEPS)).astype(np.int32)
    for arch in ARCHS:
        tree = jax.tree.map(np.asarray,
                            jbuild_model(_jcfg(arch)).init(
                                jax.random.PRNGKey(0)))
        saved["tree/" + arch] = np.asarray(tree, dtype=object)
        saved.update({f"p/{arch}/{k}": v.numpy()
                      for k, v in params_from_reference(tree).items()})
        for batch in {b for a, b, _ in CASES if a == arch}:
            extra = stub_inputs(_jcfg(arch), batch, np.random.RandomState(1))
            saved.update({f"in/{arch}/{batch}/{k}": v
                          for k, v in extra.items()})
            saved[f"in/{arch}/{batch}/tokens"] = saved[f"prompt{batch}"]
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
def test_tp_family_prefill_and_decode_logits_match_the_reference(results,
                                                                 case):
    ref, ports = results
    _, batch, kv_quant = CASES[case]
    for s in range(STEPS + 1):
        want = ref[f"{case}/logits{s}"]
        for r in range(0, D * M, M):
            np.testing.assert_array_equal(ports[r][f"{case}/logits{s}"],
                                          ports[r + 1][f"{case}/logits{s}"])
        got = _rows(ports, f"{case}/logits{s}", batch)
        tol = 1e-5 if not kv_quant or s == 0 else 1e-3
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_tp_family_gathered_cache_equals_the_reference(results, case):
    """Each rank's slice of every cache leaf (rings, S and x_last, h and
    conv, enc_kv), laid end to end, is the reference's, to 1e-5 of the
    leaf's largest; int8 payloads bit for bit but for entries at a
    rounding tie, which may move one step, and their fp16 scales to one
    step."""
    ref, ports = results
    n = sum(k.startswith(f"{case}/cache") for k in ref)
    assert n == sum(k.startswith(f"{case}/cache") for k in ports[0]) > 0
    for i in range(n):
        want = ref[f"{case}/cache{i}"]
        spec = PSpec(*(tuple(e) if isinstance(e, list) else e for e in
                       json.loads(str(ports[0][f"{case}/spec{i}"]))))
        got = np.zeros_like(want)
        for r, p in enumerate(ports):
            part = p[f"{case}/cache{i}"]
            where = tuple(slice(k * m, (k + 1) * m) for (k, _), m in zip(
                Sharding(MESH, spec).index(r), part.shape))
            got[where] = part
        assert got.shape == want.shape
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want)
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        elif got.dtype == np.float16:
            # an int8 entry's scale: one fp16 step where the amax it
            # comes from moved by rounding
            diff = np.abs(got.astype(np.float32) - want)
            assert (diff <= np.spacing(np.abs(want))).all() and \
                (diff > 0).mean() < 1e-2
        else:
            # to 1e-5 of the leaf's largest, the bar of
            # ``test_torch_serving.py`` (S sums 65 tokens' outer products)
            want = want.astype(np.float32)
            np.testing.assert_allclose(
                got.astype(np.float32), want, rtol=0,
                atol=1e-5 * max(np.abs(want).max(), 1e-30))


def test_tp_family_cache_layouts(results):
    """RWKV's S (L, B, 8, 32, 32) is halved on its first N dim and x_last
    on d; the RG-LRU block's h and conv on their channels, its tail's conv
    on its channels and h whole over the model group, on the rank's rows;
    Whisper's enc_kv (L, B, 32, 4, 64) on its kv heads."""
    _, ports = results
    p = ports[0]

    def shapes(c):
        return [p[f"{c}/cache{i}"].shape for i in range(20)
                if f"{c}/cache{i}" in p]
    assert shapes(IDS.index("rwkv")) == [(2, 2, 8, 16, 32), (2, 2, 128)]
    assert shapes(IDS.index("rglru5")) == [
        (1, 2, 3, 128), (1, 2, 128), (1, 2, 3, 128), (1, 2, 128),
        (1, 2, CACHE, 1, 32), (1, 2, CACHE, 1, 32),
        (2, 3, 128), (2, 256), (2, 3, 128), (2, 256)]
    assert shapes(IDS.index("whisper"))[2:] == [(2, 2, 32, 2, 64)] * 2


def test_serve_entry_point_runs_rwkv_tp_on_four_ranks():
    """``launch.serve --mesh 2x2`` decodes reduced RWKV6 on 4 CPU ranks,
    the same tokens as one rank."""
    def run(*extra):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "rwkv6-7b", "--reduced", "--device", "cpu", "--batch", "4",
             "--prompt-len", "16", "--decode-tokens", "4", *extra],
            capture_output=True, text=True, timeout=300,
            env=_env(OMP_NUM_THREADS="1"))
        assert out.returncode == 0, out.stderr[-3000:]
        return [line for line in out.stdout.splitlines()
                if line.startswith("sample")]
    assert run("--world-size", "4", "--mesh", "2x2") == run()
