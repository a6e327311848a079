"""The port's sharding rules (``repro_torch.core.sharding``) spec for spec
against the reference's ``repro.core.sharding``: every registered LM at
full width (the reference's shapes from ``jax.eval_shape``, the port's
from a model on the ``meta`` device; nothing is allocated) on the
production meshes 16x16 and 2x16x16 and on a 4-rank ``("data",)`` mesh;
the reference's property tests re-run on the port; ``survivor_mesh``."""
import pytest

pytest.importorskip("hypothesis")
torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import hypothesis.strategies as st  # noqa: E402
import jax  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import sharding as jshard  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import sharding as shard  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_debug_mesh, make_mesh, make_production_mesh,
)
from repro_torch.launch.train import LM_ARCHS  # noqa: E402
from repro_torch.models import param_tree  # noqa: E402
from repro_torch.models.transformer import Model, build_model  # noqa: E402

MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "4": make_mesh((4,), ("data",))}
# (data axes, model axis) of each mesh: the reference's baseline (TP on
# "model") and the dp/zero3 profiles (every axis data, no model axis)
PROFILES = {"16x16": [(("data",), "model"), (("data", "model"), None)],
            "2x16x16": [(("pod", "data"), "model"),
                        (("pod", "data", "model"), None)],
            "4": [(("data",), None)]}


def _paths(tree, is_leaf):
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]


def _specs(tree, is_leaf):
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=is_leaf)]


_CACHE = {}


def _trees(arch, kv_quant=False):
    """(reference shape tree, port meta module) for ``arch``."""
    key = (arch, kv_quant)
    if key not in _CACHE:
        jm = jbuild_model(jget_config(arch), kv_quant=kv_quant)
        pm = Model(get_config(arch), kv_quant=kv_quant, device="meta")
        _CACHE[key] = (jm, pm)
    return _CACHE[key]


def _jparams(arch):
    jm, _ = _trees(arch)
    key = (arch, "params")
    if key not in _CACHE:
        _CACHE[key] = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return _CACHE[key]


def _jspec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_pspecs_match_the_reference(arch, mesh_name):
    """Every leaf's spec, in the reference's leaf order, at fsdp on and
    off under each profile of the mesh."""
    mesh = MESHES[mesh_name]
    jtree = _jparams(arch)
    ptree = param_tree(_trees(arch)[1])
    assert [p for p in _paths(ptree, None)] == _paths(jtree, None)
    for data_axes, model_axis in PROFILES[mesh_name]:
        for fsdp in (False, True):
            kw = dict(fsdp=fsdp, data_axes=data_axes, model_axis=model_axis)
            want = _specs(jshard.param_pspecs(jtree, mesh, **kw), _jspec)
            got = shard.param_pspecs(ptree, mesh, **kw)
            assert _specs(got, lambda x: isinstance(x, shard.PSpec)) \
                == want, (data_axes, model_axis, fsdp)
            assert all(isinstance(s, shard.PSpec) for s in
                       shard.tree_leaves(got))


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_pspecs_match_the_reference(arch, mesh_name, kv_quant):
    """The decode cache at batch 1 and batch 128 x 4,096 slots (the SWA
    variant too where the arch has one), shard_seq on and off."""
    mesh = MESHES[mesh_name]
    jm, pm = _trees(arch, kv_quant)
    cfg = pm.cfg
    for batch, swa in ((1, False), (128, False), (1, True)):
        if swa and cfg.long_context != "swa":
            continue
        jcache = jax.eval_shape(
            lambda: jm.init_cache(batch, 4096, swa_variant=swa))
        pcache = pm.init_cache(batch, 4096, swa_variant=swa, device="meta")
        assert _paths(pcache, None) == _paths(jcache, None)
        for data_axes, model_axis in PROFILES[mesh_name]:
            dp = data_axes if len(data_axes) > 1 else data_axes[0]
            for shard_seq in (False, True):
                kw = dict(batch_axes=dp, model_axis=model_axis,
                          shard_seq=shard_seq)
                want = _specs(jshard.cache_pspecs(jcache, mesh, **kw),
                              _jspec)
                got = _specs(shard.cache_pspecs(pcache, mesh, **kw),
                             lambda x: isinstance(x, shard.PSpec))
                assert got == want, (batch, swa, data_axes, shard_seq)


def test_pspec_equals_partition_spec_entries():
    spec = shard.PSpec(None, ("data", "model"), "model")
    assert tuple(spec) == tuple(jax.sharding.PartitionSpec(
        None, ("data", "model"), "model"))
    assert spec == (None, ("data", "model"), "model")


def test_meta_model_allocates_nothing():
    model = build_model(get_config("mixtral-8x22b"), device="meta")
    assert {p.device.type for p in model.parameters()} == {"meta"}


# --- the reference's property tests (tests/test_sharding.py) on the port --
class _FakeMesh:
    """Shape-only stand-in (leaf_pspec reads only mesh.shape)."""
    def __init__(self, **shape):
        self.shape = shape


@given(dims=st.lists(st.integers(1, 4096), min_size=1, max_size=4),
       msize=st.sampled_from([2, 4, 16]),
       dsize=st.sampled_from([2, 16, 32]))
@settings(max_examples=100, deadline=None)
def test_leaf_pspec_always_legal(dims, msize, dsize):
    """Every assigned axis divides its dim; no axis appears twice; the
    reference assigns the same."""
    mesh = _FakeMesh(model=msize, data=dsize)
    kw = dict(model_axis="model", data_axes=("data",), fsdp=True)
    spec = shard.leaf_pspec(tuple(dims), mesh, **kw)
    assert tuple(spec) == tuple(jshard.leaf_pspec(tuple(dims), mesh, **kw))
    seen = []
    for dim, entry in zip(dims, spec):
        if entry is None:
            continue
        entries = entry if isinstance(entry, tuple) else (entry,)
        for e in entries:
            assert e not in seen
            seen.append(e)
        size = np.prod([mesh.shape[e] for e in entries])
        assert dim % size == 0


@given(dims=st.lists(st.integers(1, 512), min_size=2, max_size=4))
@settings(max_examples=50, deadline=None)
def test_leaf_pspec_no_model_axis_profile(dims):
    mesh = _FakeMesh(model=16, data=16)
    spec = shard.leaf_pspec(tuple(dims), mesh, model_axis=None)
    assert all(e is None for e in spec)


def test_skip_leading_never_shards_stack_dim():
    mesh = _FakeMesh(model=4, data=4)
    spec = shard.leaf_pspec((4, 64, 64), mesh, skip_leading=True,
                            data_axes=("data",), fsdp=True)
    assert spec[0] is None


def test_quant_cache_payload_and_scale_align():
    """The int8 payload and its (.., KV, 1) scales take the model axis on
    the same dim (KV)."""
    mesh = _FakeMesh(model=16, data=16)
    cache = {"blocks": [{"k": {
        "q": torch.empty((32, 2, 512, 32, 96), dtype=torch.int8,
                         device="meta"),
        "scale": torch.empty((32, 2, 512, 32, 1), dtype=torch.float16,
                             device="meta"),
    }}]}
    specs = shard.cache_pspecs(cache, mesh, batch_axes=("data",))
    k = specs["blocks"][0]["k"]
    assert k["q"][3] == "model" and k["scale"][3] == "model"


# --- survivor_mesh ---------------------------------------------------------
def test_survivor_mesh_drops_the_dead_slice_in_order():
    mesh = make_debug_mesh((4, 1))
    surv = shard.survivor_mesh(mesh, 1)
    assert surv.axis_names == ("data", "model")
    assert surv.devices.tolist() == [[0], [2], [3]]
    assert surv.shape == {"data": 3, "model": 1}
    two = shard.survivor_mesh(make_mesh((2, 3, 2), ("pod", "data",
                                                    "model")), 0)
    assert two.devices[:, :, 0].tolist() == [[2, 4], [8, 10]]


@pytest.mark.parametrize("dead, axis, err", [
    (4, "data", "out of range"), (0, "pod", "has no axis")])
def test_survivor_mesh_rejects_what_the_reference_rejects(dead, axis, err):
    with pytest.raises(ValueError, match=err):
        shard.survivor_mesh(make_debug_mesh((4, 1)), dead, data_axis=axis)
    with pytest.raises(ValueError, match="last"):
        shard.survivor_mesh(make_debug_mesh((1, 1)), 0)


def test_pspecs_on_the_survivor_mesh_degrade_to_replication():
    """Reduced SmolLM at fsdp on 4 ranks shards every block leaf (d 256);
    on the 3 survivors a dim of 256 no longer divides and its leaf goes
    back to replication, as the reference's docstring says."""
    cfg = get_config("smollm-135m").reduced()
    ptree = param_tree(Model(cfg, device="meta"))
    jtree = jax.eval_shape(jbuild_model(jget_config("smollm-135m")
                                        .reduced()).init,
                           jax.random.PRNGKey(0))
    mesh = make_debug_mesh((4, 1))
    surv = shard.survivor_mesh(mesh, 2)
    for m in (mesh, surv):
        got = _specs(shard.param_pspecs(ptree, m, fsdp=True),
                     lambda x: isinstance(x, shard.PSpec))
        assert got == _specs(jshard.param_pspecs(jtree, m, fsdp=True),
                             _jspec)
    full = shard.tree_leaves(shard.param_pspecs(ptree, mesh, fsdp=True))
    specs = shard.tree_leaves(shard.param_pspecs(ptree, surv, fsdp=True))
    assert sum("data" in s for s in full) == 7
    assert not any("data" in s for s in specs)     # 64, 256, 512 vs 3


def test_sharding_shards_and_shapes():
    mesh = make_mesh((2, 2), ("data", "model"))
    sh = shard.Sharding(mesh, shard.PSpec(None, ("data", "model")))
    full = torch.arange(24.).reshape(2, 12)
    assert sh.shard_shape(full.shape) == (2, 3)
    pieces = [sh.shard(full, r) for r in range(4)]
    assert torch.equal(torch.cat(pieces, dim=1), full)
    with pytest.raises(ValueError, match="divide"):
        sh.shard_shape((2, 10))


def test_tp_is_refused():
    """A model axis above 1 is refused for the CNNs alone (the reference
    runs them on a model axis of 1) and run for every transformer family;
    of size 1, or None, it refuses nothing."""
    for arch in ("mobilenet-cifar", "resnet18-cifar"):
        with pytest.raises(NotImplementedError, match="a CNN"):
            shard.require_tp_family(get_config(arch),
                                    make_production_mesh(), "model")
        shard.require_tp_family(get_config(arch), make_debug_mesh((4, 1)),
                                "model")
        shard.require_tp_family(get_config(arch), make_production_mesh(),
                                None)
    for arch in ("smollm-135m", "gemma3-4b", "qwen1.5-4b",
                 "phi3-mini-3.8b", "mixtral-8x7b", "mixtral-8x22b",
                 "rwkv6-7b", "recurrentgemma-2b", "whisper-small",
                 "pixtral-12b"):
        shard.require_tp_family(get_config(arch), make_production_mesh(),
                                "model")


def test_mesh_slices_and_data_index():
    """The ranks of each slice along some axes, in order; a rank's place
    along the data axes (row-major over them)."""
    from repro_torch.launch.mesh import data_axes_of, slices
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    assert slices(mesh, ("data",)) == ((0, 2), (1, 3), (4, 6), (5, 7))
    assert slices(mesh, ("pod", "data")) == ((0, 2, 4, 6), (1, 3, 5, 7))
    assert data_axes_of(mesh) == ("pod", "data")
    assert [shard.data_index(mesh, ("pod", "data"), r)
            for r in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert mesh.coords(5) == {"pod": 1, "data": 0, "model": 1}
    with pytest.raises(ValueError, match="not in the mesh"):
        mesh.coords(8)
