"""Tensor-parallel serving where the model axis lands on a ring's slots, on
3 gloo ranks, a (1, 3) ("data", "model") mesh, against the reference's
``build_serve_step(..., model_axis="model")`` on a 3-device mesh with Auto
axes, each in its own process: batch 2, cache 96, a prompt of 94 and 3
teacher-forced decode steps, the third wrapping the ring to slot 0.

Reduced configs at ``vocab=384`` (the reference's logits need the vocab
to divide over the model axis; the port's do not): 1 or 2 kv heads and
head_dim 64 do not divide over 3, so ``cache_pspecs`` puts the model axis
on a ring's slots where they divide (32 a rank of 96).  Prefill runs
attention on every head and keeps the rank's slots; decode attends them
with every query head and combines the partial softmaxes over the model
group (flash-decode).

* SmolLM, fp32; and with the int8 cache, payload and scale both on the
  slots.
* Gemma-3 at 6 layers: the 64-slot local rings held whole over the model
  axis beside the 96-slot global ring on its slots.
* RecurrentGemma at 3 layers: the conv state (1, 2, 3, 256) on its 3
  taps, the 64-slot local ring whole.
* Whisper at 30 encoder positions (stub frames): ``enc_kv`` on its
  positions (10 a rank), which decode's cross-attention attends through
  flash-decode over the model group, beside the decoder's ring on its
  slots.

Prefill and every decode step's logits agree to 1e-5 (int8: within the
step that a flipped rounding of a payload entry makes), the ranks return
the same logits, each rank's cache laid end to end along its sharded dims
equals the reference's and its spec the reference's, and the ``baseline``
dry-run's argument bytes of the decode step equal the reference's
``memory_analysis()``."""
import dataclasses
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
D, M, BATCH, CACHE, PROMPT, STEPS, VOCAB = 1, 3, 2, 96, 94, 3, 384
# (arch, kv_quant)
CASES = [("smollm-135m", False), ("smollm-135m", True), ("gemma3-4b", False),
         ("recurrentgemma-2b", False), ("whisper-small", False)]
IDS = ["smollm", "smollm-int8", "gemma3", "rglru3", "whisper"]
ARCHS = sorted({a for a, _ in CASES})
LAYERS = {"smollm-135m": 2, "gemma3-4b": 6, "recurrentgemma-2b": 3,
          "whisper-small": 2}
REF_PARTS = 2
MESH = make_mesh((D, M), ("data", "model"))

_CFG = """
import dataclasses


def cfg_of(arch):
    cfg = get_config(arch).reduced(n_layers={layers}[arch], vocab={vocab})
    if cfg.is_encoder_decoder:
        # 4 kv heads and head_dim 64 do not divide over 3, 30 positions do
        cfg = dataclasses.replace(cfg, encoder_seq=30)
    return cfg
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
for c, (arch, kv_quant) in enumerate({cases}):
    model = Model(cfg_of(arch), kv_quant=kv_quant)
    pre = f"p/{{arch}}/"
    model.load_state_dict({{k[len(pre):]: torch.from_numpy(d[k])
                           for k in d.files if k.startswith(pre)}})
    ss = build_serve_step(model, mesh, data_axes=("data",),
                          model_axis="model", batch_size={batch},
                          cache_len={cache})
    pre = f"in/{{arch}}/"
    logits, cache = ss.prefill_fn({{k[len(pre):]: torch.from_numpy(d[k])
                                   for k in d.files if k.startswith(pre)}})
    res[f"{{c}}/logits0"] = logits.numpy()
    for s in range({steps}):
        tok = torch.from_numpy(d["tokens"][:, s:s + 1])
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
import json
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
for c, (arch, kv_quant) in enumerate({cases}):
    if c % {parts} != part:
        continue
    tree = d["tree/" + arch].item()
    model = build_model(cfg_of(arch), kv_quant=kv_quant)
    ss = build_serve_step(model, mesh, data_axes=("data",),
                          model_axis="model", batch_size={batch},
                          cache_len={cache})
    params = jax.tree.map(lambda a, sh: jax.device_put(jnp.asarray(a), sh),
                          tree, ss.param_shardings)
    token, cache, pos = ss.make_inputs("decode", {cache})
    res[f"{{c}}/argument_bytes"] = np.asarray(ss.decode_fn.lower(
        params, token, cache, pos).compile().memory_analysis()
        .argument_size_in_bytes)
    pre = f"in/{{arch}}/"
    logits, cache = ss.prefill_fn(params, {{
        k[len(pre):]: jnp.asarray(d[k]) for k in d.files
        if k.startswith(pre)}})
    res[f"{{c}}/logits0"] = np.asarray(logits)
    for s in range({steps}):
        tok = jnp.asarray(d["tokens"][:, s:s + 1])
        logits, cache = ss.decode_fn(params, tok, cache,
                                     jnp.asarray({prompt} + s, jnp.int32))
        res[f"{{c}}/logits{{s + 1}}"] = np.asarray(logits)
    for i, t in enumerate(jax.tree.leaves(cache)):
        res[f"{{c}}/cache{{i}}"] = np.asarray(t)
        res[f"{{c}}/spec{{i}}"] = np.asarray(json.dumps(
            list(t.sharding.spec)))
np.savez(out, **res)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _jcfg(arch):
    cfg = jget_config(arch).reduced(n_layers=LAYERS[arch], vocab=VOCAB)
    if cfg.is_encoder_decoder:
        cfg = dataclasses.replace(cfg, encoder_seq=30)
    return cfg


def _tcfg(arch):
    from repro_torch.configs.base import get_config
    cfg = get_config(arch).reduced(n_layers=LAYERS[arch], vocab=VOCAB)
    if cfg.is_encoder_decoder:
        cfg = dataclasses.replace(cfg, encoder_seq=30)
    return cfg


def _spec(s):
    """A spec's entries from its JSON (a tuple entry comes back a
    list)."""
    return [tuple(e) if isinstance(e, list) else e for e in json.loads(s)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch.train import stub_inputs
    tmp = tmp_path_factory.mktemp("tp_serve_slots")
    inp = str(tmp / "inputs.npz")
    saved = {}
    for arch in ARCHS:
        tree = jax.tree.map(np.asarray,
                            jbuild_model(_jcfg(arch)).init(
                                jax.random.PRNGKey(0)))
        saved["tree/" + arch] = np.asarray(tree, dtype=object)
        saved.update({f"p/{arch}/{k}": v.numpy()
                      for k, v in params_from_reference(tree).items()})
    rs = np.random.RandomState(0)
    prompt = rs.randint(0, VOCAB, (BATCH, PROMPT)).astype(np.int32)
    saved["tokens"] = rs.randint(0, VOCAB, (BATCH, STEPS)).astype(np.int32)
    for arch in ARCHS:
        saved[f"in/{arch}/tokens"] = prompt
        saved.update({f"in/{arch}/{k}": v for k, v in stub_inputs(
            _jcfg(arch), BATCH, np.random.RandomState(1)).items()})
    np.savez(inp, **saved)
    fmt = dict(D=D, M=M, batch=BATCH, cache=CACHE, prompt=PROMPT,
               steps=STEPS, cases=repr(CASES), parts=REF_PARTS)
    fmt["cfg"] = _CFG.format(layers=repr(LAYERS), vocab=VOCAB)
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


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_slots_prefill_and_decode_logits_match_the_reference(results, case):
    ref, ports = results
    _, kv_quant = CASES[case]
    for s in range(STEPS + 1):
        want = ref[f"{case}/logits{s}"]
        # every rank of the model group returns the same, whole logits
        for p in ports[1:]:
            np.testing.assert_array_equal(p[f"{case}/logits{s}"],
                                          ports[0][f"{case}/logits{s}"])
        tol = 1e-5 if not kv_quant or s == 0 else 1e-3
        np.testing.assert_allclose(ports[0][f"{case}/logits{s}"], want,
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_slots_cache_equals_the_reference_leaf_for_leaf(results, case):
    """Each rank's slice (its range of a ring's slots, its taps of the
    conv state, or the leaf whole), laid end to end, is the reference's
    leaf, and its spec is the reference's; int8 payloads bit for bit but
    for entries at a rounding tie, which may move one step, and their fp16
    scales to one step."""
    ref, ports = results
    n = sum(k.startswith(f"{case}/cache") for k in ref)
    assert n == sum(k.startswith(f"{case}/cache") for k in ports[0]) > 0
    for i in range(n):
        want = ref[f"{case}/cache{i}"]
        spec = _spec(str(ports[0][f"{case}/spec{i}"]))
        want_spec = _spec(str(ref[f"{case}/spec{i}"]))
        # the reference's spec may drop trailing Nones
        assert spec == want_spec + [None] * (len(spec) - len(want_spec))
        got = np.zeros_like(want)
        for r, p in enumerate(ports):
            part = p[f"{case}/cache{i}"]
            where = tuple(slice(k * m, (k + 1) * m) for (k, _), m in zip(
                Sharding(MESH, PSpec(*spec)).index(r), part.shape))
            got[where] = part
        assert got.shape == want.shape
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want)
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        elif got.dtype == np.float16:
            diff = np.abs(got.astype(np.float32) - want)
            assert (diff <= np.spacing(np.abs(want))).all() and \
                (diff > 0).mean() < 1e-2
        else:
            want = want.astype(np.float32)
            np.testing.assert_allclose(
                got.astype(np.float32), want, rtol=0,
                atol=1e-5 * max(np.abs(want).max(), 1e-30))


def test_slots_cache_layouts(results):
    """SmolLM's rings (L, B, 96, 1, 64) hold 32 slots a rank, the int8
    scales too; Gemma-3's five 64-slot local rings are whole and its
    global ring is on the slots; RecurrentGemma's conv state holds one of
    its 3 taps a rank, its h and its local ring whole; Whisper's encoder
    k/v hold 10 of 30 positions a rank, its ring 32 of 96 slots."""
    _, ports = results
    p = ports[0]

    def shapes(c):
        return [p[f"{c}/cache{i}"].shape for i in range(40)
                if f"{c}/cache{i}" in p]
    assert shapes(0) == [(2, BATCH, 32, 1, 64)] * 2
    assert sorted(shapes(1)) == [(2, BATCH, 32, 1, 1)] * 2 + \
        [(2, BATCH, 32, 1, 64)] * 2
    assert sorted(shapes(2)) == [(1, BATCH, 32, 2, 64)] * 2 + \
        [(1, BATCH, 64, 2, 64)] * 10
    assert sorted(shapes(3)) == [(1, BATCH, 1, 256)] * 2 + \
        [(1, BATCH, 64, 1, 64)] * 2 + [(1, BATCH, 256)] * 2
    assert sorted(shapes(4)) == [(2, BATCH, 10, 4, 64)] * 2 + \
        [(2, BATCH, 32, 4, 64)] * 2


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_slots_baseline_dryrun_decode_bytes_equal_the_reference(results,
                                                               case):
    """The ``baseline`` dry-run of each case's decode step on the (1, 3)
    mesh: the slices a rank holds of the parameters the step reads, the
    token, the cache and the position, byte for byte the reference's
    ``memory_analysis()``, whose compiled decode drops the arguments it
    never reads (Whisper's encoder and its cross-attention's k and v
    weights)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    ref, _ = results
    arch, kv_quant = CASES[case]
    res = dryrun.dryrun_one(
        arch, "small", profile="baseline", save=False, kv_quant=kv_quant,
        mesh=make_mesh((D, M), ("data", "model")), config=_tcfg(arch),
        input_shape=InputShape("small", CACHE, BATCH, "decode"))
    assert res["memory"]["argument_bytes"] == \
        int(ref[f"{case}/argument_bytes"])


def test_whisper_decode_reads_no_encoder_or_cross_kv_weights(monkeypatch):
    """Whisper's ``decode_step`` on the plain path reads no leaf of the
    encoder (nor its final norm) and none of the cross-attention's wk, wv,
    bk and bv: it projects q alone (``attention.project_q``), and the
    cache's ``enc_kv`` holds k and v.  Its fp32 logits are bit for bit
    those of a step that projects q, k and v together and keeps q."""
    from repro_torch.launch.dryrun import ReadStorages
    from repro_torch.launch.train import stub_inputs
    from repro_torch.models import attention
    from repro_torch.models.transformer import Model
    cfg = _tcfg("whisper-small")
    assert cfg.dtype == "float32" and cfg.qkv_bias
    model = Model(cfg)
    rs = np.random.RandomState(2)
    with torch.no_grad():    # biases too, so that bq's add is seen
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                0.1 * rs.randn(*p.shape).astype(np.float32)))
    batch = {k: torch.from_numpy(v)
             for k, v in stub_inputs(cfg, BATCH, rs).items()}
    batch["tokens"] = torch.from_numpy(
        rs.randint(0, VOCAB, (BATCH, 16)).astype(np.int32))
    token = torch.from_numpy(rs.randint(0, VOCAB, (BATCH, 1))
                             .astype(np.int32))
    names = {p.untyped_storage()._cdata: n
             for n, p in model.named_parameters()}

    def decode():
        _, cache = model.prefill(batch, cache_len=24)
        reads = ReadStorages()
        with reads:
            logits, _ = model.decode_step(token, cache, 16)
        return logits, {names[k] for k in reads.keys if k in names}

    logits, read = decode()
    cross_kv = {n for n in names.values()
                if n.split(".")[-2:-1] == ["xattn"] and
                n.split(".")[-1] in ("wk", "wv", "bk", "bv")}
    assert len(cross_kv) == 4
    unread = set(names.values()) - read
    assert unread == cross_kv | {n for n in names.values()
                                 if n.startswith("encoder.") or
                                 n == "enc_norm"}
    monkeypatch.setattr(
        attention, "project_q", lambda p, x, cfg, tp=None:
        attention.project_qkv(p, x, cfg, tp, head_local=False)[0])
    before, read_before = decode()
    assert read_before == read | cross_kv
    assert torch.equal(logits, before)


@pytest.mark.parametrize("world,mesh,batch", [(3, "1x3", 2), (6, "2x3", 1)],
                         ids=["1x3", "2x3-batch1"])
def test_serve_entry_point_runs_slots_tp(world, mesh, batch):
    """``launch.serve`` decodes reduced SmolLM with its ring on the slots
    (cache 16 + 5 = 21, 7 slots a rank), the same tokens as one rank: on
    (1, 3) batch-sharded, and on (2, 3) at batch 1, where the cache is
    sequence-sharded but 21 slots do not divide over the 2 data ranks, so
    the model axis takes them."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-135m", "--reduced", "--device", "cpu", "--batch",
         str(batch), "--prompt-len", "16", "--decode-tokens", "5", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(OMP_NUM_THREADS="1"))
        for extra in (("--world-size", str(world), "--mesh", mesh), ())]
    samples = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        samples.append([line for line in out.splitlines()
                        if line.startswith("sample")])
    assert samples[0] == samples[1] != []
