"""The port's checkpoint format against the reference's: the MessagePack
subset against ``msgpack`` in every size class, the treedef string
against ``str(jax.tree.structure(...))``, and blobs and files both ways
(fp32, int32 0-d and bf16 leaves, the latter through ``ml_dtypes`` on the
reference's side), including ``launch.train --checkpoint``'s file."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import build_cnn as jbuild_cnn  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint import codec  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402

# each size class's edges: fix forms, 8-, 16- and 32-bit lengths
STR_LENGTHS = [0, 1, 31, 32, 255, 256, 65535, 65536]
BIN_LENGTHS = [0, 1, 255, 256, 65535, 65536]
SEQ_LENGTHS = [0, 1, 15, 16, 65535, 65536]
INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
        2 ** 64 - 1, -1, -32, -33, -128, -129, -2 ** 15, -2 ** 15 - 1,
        -2 ** 31, -2 ** 31 - 1, -2 ** 63]
OBJECTS = (
    [("str", "é" * (n // 2) + "x" * (n % 2)) for n in STR_LENGTHS]
    + [("bin", bytes(range(256)) * (n // 256) + bytes(n % 256))
       for n in BIN_LENGTHS]
    + [("array", list(range(n))) for n in SEQ_LENGTHS]
    + [("map", {f"k{i}": i for i in range(n)}) for n in SEQ_LENGTHS]
    + [("int", v) for v in INTS]
    + [("other", v) for v in (None, True, False)]
    + [("nested", {"treedef": "x" * 702, "leaves": [
        {"dtype": "float32", "shape": [3, 1, 0], "data": b"\0" * 12},
        {"dtype": "int32", "shape": [], "data": b"\1\0\0\0"}]})])


def _plain(obj):
    """``codec.unpackb``'s memoryviews as bytes, for comparison."""
    if isinstance(obj, memoryview):
        return bytes(obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    return obj


@pytest.mark.parametrize("kind,obj", OBJECTS,
                         ids=lambda v: v if isinstance(v, str) and len(v) < 8
                         else None)
def test_codec_matches_msgpack(kind, obj):
    """The same bytes as ``msgpack.packb(use_bin_type=True)``, and each
    side reads the other's."""
    want = msgpack.packb(obj, use_bin_type=True)
    assert codec.packb(obj) == want
    assert _plain(codec.unpackb(want)) == msgpack.unpackb(want, raw=False)


def test_codec_rejects_what_a_checkpoint_does_not_hold():
    with pytest.raises(TypeError, match="cannot pack float"):
        codec.packb(1.5)
    with pytest.raises(ValueError, match="not part of a checkpoint"):
        codec.unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError, match="truncated"):
        codec.unpackb(msgpack.packb("abc")[:-1])
    with pytest.raises(ValueError, match="after the MessagePack object"):
        codec.unpackb(msgpack.packb(1) + b"\0")


TREES = [
    np.float32(1.0),
    (np.float32(1.0),),
    [],
    (),
    {},
    None,
    {"b": [np.zeros(2), (np.zeros(1),)], "a": {}},
    [None, np.zeros(3)],
    {"opt": {"m": [np.zeros(1)], "step": np.int32(0)}, "params": {
        "a": np.zeros(1)}, "step": np.int32(0), "strat": ()},
]


@pytest.mark.parametrize("tree", TREES, ids=range(len(TREES)))
def test_treedef_matches_jax(tree):
    assert ckpt.treedef(tree) == str(jax.tree.structure(tree))
    leaves = ckpt.flatten(tree)
    assert len(leaves) == len(jax.tree.leaves(tree))
    assert ckpt.treedef(ckpt.unflatten(tree, leaves)) == ckpt.treedef(tree)


def test_treedef_of_the_reduced_smollm_parameter_tree():
    """The port's parameter tree (with ``'tail': []``) has the
    reference's structure, leaf for leaf in the same order."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model, param_tree, reference_leaves
    model = build_model(get_config("smollm-135m").reduced(), device="cpu")
    ref = jbuild_model(jget_config("smollm-135m").reduced()).init(
        jax.random.PRNGKey(0))
    tree = param_tree(model)
    assert ckpt.treedef(tree) == str(jax.tree.structure(ref))
    assert [tuple(t.shape) for t in ckpt.flatten(tree)] == \
        [tuple(l.shape) for l in jax.tree.leaves(ref)]
    assert all(a is b for a, b in zip(ckpt.flatten(tree),
                                      reference_leaves(model)))


def _state(rs, bf16=False):
    """A numpy state tree of the harness's kinds of leaf."""
    f = np.float32
    w = rs.randn(4, 6).astype(f)
    return {"opt": {"m": {"w": rs.randn(4, 6).astype(f), "tail": []},
                    "step": np.asarray(3, np.int32)},
            "params": {"w": w.astype(ml_dtypes.bfloat16) if bf16 else w,
                       "tail": []},
            "step": np.asarray(3, np.int32), "strat": ()}


def _torch_tree(tree):
    def leaf(x):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return jax.tree.map(leaf, tree)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_dumps_is_the_reference_blob(bf16):
    """fp32, int32 0-d and bf16 leaves: the port's blob of the tensors is
    the reference's blob of the numpy arrays, byte for byte."""
    tree = _state(np.random.RandomState(0), bf16)
    blob = jckpt.dumps(tree)
    assert ckpt.dumps(_torch_tree(tree)) == blob
    if not bf16:
        assert ckpt.dumps(tree) == blob


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_blobs_load_both_ways(bf16):
    rs = np.random.RandomState(1)
    tree = _state(rs, bf16)
    ttree = _torch_tree(tree)
    # the reference reads the port's blob
    back = jckpt.loads(ckpt.dumps(ttree),
                       like=jax.tree.map(np.zeros_like, tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # the port reads the reference's blob onto tensors like its own
    like = jax.tree.map(torch.zeros_like, ttree)
    got = ckpt.loads(jckpt.dumps(tree), like=like)
    for a, b in zip(ckpt.flatten(got), ckpt.flatten(ttree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))
        a.add_(1)               # writable, and not a view of the blob


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_loads_places_like_its_template():
    """A meta template allocates nothing and gives host tensors; the
    dtype follows the template; numpy templates give numpy arrays."""
    t = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "n": torch.tensor(7, dtype=torch.int32)}
    blob = ckpt.dumps(t)
    meta = {"a": torch.empty(2, 3, device="meta"),
            "n": torch.empty((), dtype=torch.int32, device="meta")}
    got = ckpt.loads(blob, like=meta)
    assert got["a"].device.type == "cpu" and torch.equal(got["a"], t["a"])
    as64 = ckpt.loads(blob, like={"a": torch.zeros(2, 3, dtype=torch.float64),
                                  "n": torch.zeros((), dtype=torch.int64)})
    assert as64["a"].dtype == torch.float64 and int(as64["n"]) == 7
    arr = ckpt.loads(blob, like={"a": np.zeros((2, 3), np.float32),
                                 "n": np.zeros((), np.int32)})
    assert isinstance(arr["a"], np.ndarray) and arr["a"].flags.writeable
    assert arr["a"].tolist() == t["a"].tolist()


def test_loads_refuses_another_structure_or_shape():
    blob = ckpt.dumps({"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="treedef does not match"):
        ckpt.loads(blob, like={"b": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.loads(blob, like={"a": torch.zeros(3)})


def test_save_and_restore_files_both_ways(tmp_path):
    tree = _state(np.random.RandomState(2))
    ttree = _torch_tree(tree)
    ckpt.save(str(tmp_path / "port.msgpack"), ttree)
    jckpt.save(str(tmp_path / "ref.msgpack"), tree)
    assert (tmp_path / "port.msgpack").read_bytes() == \
        (tmp_path / "ref.msgpack").read_bytes()
    got = ckpt.restore(str(tmp_path / "ref.msgpack"),
                       like=jax.tree.map(torch.zeros_like, ttree))
    assert torch.equal(got["params"]["w"], ttree["params"]["w"])
    assert not (tmp_path / "port.msgpack.tmp").exists()


@pytest.mark.parametrize("arch,kw", [
    ("smollm-135m", dict(seq=16, fused_optimizer=True)),
    ("mobilenet-cifar", {})], ids=["smollm", "mobilenet"])
def test_train_checkpoint_is_read_by_the_reference(tmp_path, arch, kw):
    """``launch.train --checkpoint``'s file restores through the
    reference's ``checkpoint.restore(path, like=params)``, leaf for leaf
    the port's trained parameters."""
    from repro_torch.models import reference_leaves
    path = str(tmp_path / "params.msgpack")
    train(arch=arch, reduced=True, device="cpu", steps=1, batch=4,
          log=None, checkpoint=path, **kw)
    jcfg = jget_config(arch).reduced()
    jmodel = jbuild_cnn(jcfg) if jcfg.family == "cnn" else \
        jbuild_model(jcfg)
    like = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    got = jckpt.restore(path, like=like)
    mine = ckpt.restore(path, like=jax.tree.map(
        lambda x: torch.empty(x.shape, device="meta"), like))
    assert len(jax.tree.leaves(got)) == len(ckpt.flatten(mine)) > 0
    for a, b in zip(jax.tree.leaves(got), ckpt.flatten(mine)):
        assert a.dtype == np.float32 and np.array_equal(a, b.numpy())
