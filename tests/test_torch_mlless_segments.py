"""MLLess's segmented filter on the CPU: the twins of ``segment_norms``
and ``segment_filter`` (every leaf at once) against the per-leaf twins
of ``block_norms``, ``block_significance`` and ``masked_filter``, bit
for bit, on the MobileNet and ResNet-18 leaf layouts and a ragged one;
``MLLess.sync`` on one rank against the reference's ``MLLess`` on the
pure-DP mesh.  The Hopper kernels are held against these twins on a GPU
in ``test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.compat import shard_map  # noqa: E402
from repro.core import get_strategy as jget_strategy  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import get_strategy  # noqa: E402
from repro_torch.kernels import block_significance as tbs  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import build_cnn, reference_leaves  # noqa: E402

RAGGED = [(1,), (255,), (257,), (100_003,), (3, 3, 3, 32), (7, 300)]


def _shapes(layout):
    if layout == "ragged":
        return RAGGED
    arch, _, width = layout.partition(" ")
    cfg = get_config(arch)
    if width == "reduced":
        cfg = cfg.reduced()
    return [tuple(p.shape) for p in reference_leaves(
        build_cnn(cfg, device="cpu"))]


def _case(shapes, seed, dtype=torch.float32):
    """Gradients of mixed-scale 256-wide rows (so masks vary) and a
    residual, from numpy."""
    rs = np.random.RandomState(seed)
    grads, resid = [], []
    for shape in shapes:
        n = int(np.prod(shape))
        rows = -(-n // 256)
        scale = np.repeat(rs.lognormal(sigma=1.5, size=rows), 256)[:n]
        grads.append(torch.from_numpy(
            (rs.randn(n) * scale).astype(np.float32).reshape(shape))
            .to(dtype))
        resid.append(torch.from_numpy(
            (0.3 * rs.randn(n)).astype(np.float32).reshape(shape)))
    return grads, resid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["mobilenet-cifar", "resnet18-cifar",
                                    "ragged"])
def test_segment_twins_match_per_leaf_twins(layout, dtype):
    """The segmented pair, through its wrappers (the twins on the CPU) and
    through ``ref`` directly, equals the per-leaf twins leaf by leaf: the
    same fp32 adds and sums on the same rows."""
    shapes = _shapes(layout)
    grads, leaves = _case(shapes, seed=len(shapes), dtype=dtype)
    lay = tbs.SegmentLayout(grads)
    resid = lay.pack(leaves, "cpu")
    sq, mask, counts = tbs.segment_norms(grads, resid, lay, 0.5)
    kept, new = tbs.segment_filter(grads, resid, lay, mask)
    for a, b in zip((sq, mask, counts, kept, new),
                    (*tref.segment_norms(grads, resid, lay, 0.5),
                     *tref.segment_filter(grads, resid, lay, mask))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert sq.shape == mask.shape == (lay.n_rows,)
    assert kept.shape == (lay.numel,) and new.shape == resid.shape
    assert 0 < int(counts.sum()) < lay.n_rows
    for i, (g, r) in enumerate(zip(grads, leaves)):
        n, b0, nb, off = (lay.numels[i], lay.block0[i], lay.blocks[i],
                          lay.offsets[i])
        acc = g.float() + r
        blocks = F.pad(acc.reshape(-1), (0, nb * 256 - n)).view(-1, 256)
        rows = slice(b0, b0 + nb)
        assert torch.equal(sq[rows], tref.block_norms(blocks))
        leaf_mask = tref.block_significance(blocks, 0.5)
        assert torch.equal(mask[rows], leaf_mask)
        assert int(counts[i]) == int(leaf_mask.sum())
        k, res = tref.masked_filter(blocks, leaf_mask)
        assert torch.equal(kept[off:off + n], k.reshape(-1)[:n])
        assert torch.equal(new[b0 * 256:(b0 + nb) * 256], res.reshape(-1))
    # every leaf's rows past its numel stay zero in the new residual
    for b0, nb, n in zip(lay.block0, lay.blocks, lay.numels):
        assert not bool(new[b0 * 256 + n:(b0 + nb) * 256].any())


def test_segment_layout_places_every_leaf():
    grads = [torch.zeros(s) for s in RAGGED]
    lay = tbs.SegmentLayout(grads)
    assert lay.numels == [int(np.prod(s)) for s in RAGGED]
    assert lay.blocks == [1, 1, 2, 391, 4, 9]
    assert lay.block0 == [0, 1, 2, 4, 395, 399]
    assert lay.offsets == [0, 1, 256, 513, 100_516, 101_380]
    assert (lay.n_rows, lay.numel) == (408, 103_480)
    assert lay.matches(grads) and not lay.matches(grads[:-1])
    assert not lay.matches(grads[:-1] + [torch.zeros(7, 300).bfloat16()])
    leaves = [torch.full(s, float(i + 1)) for i, s in enumerate(RAGGED)]
    flat = lay.pack(leaves, "cpu")
    assert flat.shape == (408 * 256,)
    for view, leaf in zip(lay.residual_views(flat), leaves):
        assert view.shape == leaf.shape and torch.equal(view, leaf)
        assert view.data_ptr() % 1024 == flat.data_ptr() % 1024
    assert float(flat.sum()) == sum(float(x.sum()) for x in leaves)
    out = torch.arange(lay.numel, dtype=torch.float32)
    assert [v.shape for v in lay.leaf_views(out)] == \
        [torch.Size(s) for s in RAGGED]
    assert float(lay.leaf_views(out)[3].reshape(-1)[0]) == 513.0


def test_segment_wrappers_refuse_devices_without_a_kernel():
    meta = [torch.empty(s, device="meta") for s in RAGGED[:2]]
    lay = tbs.SegmentLayout(meta)
    resid = torch.empty(lay.n_rows * 256, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tbs.segment_norms(meta, resid, lay, 0.5)
    with pytest.raises(ValueError, match="unsupported device"):
        tbs.segment_filter(meta, resid, lay,
                           torch.empty(lay.n_rows, dtype=torch.bool,
                                       device="meta"))


# ---------------------------------------------------------------------------
# MLLess.sync against the reference
# ---------------------------------------------------------------------------
@pytest.fixture
def group(tmp_path):
    """A one-rank gloo process group (file rendezvous: pytest runs
    several workers at once)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    yield None
    dist.destroy_process_group()


def _jax_sync(strategy, grads, state):
    """The reference's MLLess on the one-device pure-DP mesh
    (``model_axis=None``: no ``model`` axis)."""
    mesh = jax.make_mesh((1,), ("data",))
    fn = shard_map(lambda g, s: strategy.sync(g, s, "data"), mesh=mesh,
                   in_specs=(P(), P()),
                   out_specs=(P(), P(), {"significant_fraction": P()}),
                   axis_names={"data"})
    return jax.jit(fn)([jnp.asarray(g.float().numpy()).astype(
        jnp.bfloat16 if g.dtype == torch.bfloat16 else jnp.float32)
        for g in grads], state)


def _far_from_cut(grads, state, threshold=0.5):
    """Every row's norm is more than 1e-4 from its leaf's cut, so fp32
    sums taken in another order (XLA's) give the same mask."""
    for g, r in zip(grads, state):
        acc = (g.double() + r.double()).reshape(-1)
        blocks = F.pad(acc, (0, (-acc.numel()) % 256)).view(-1, 256)
        sq = (blocks ** 2).sum(1)
        cut = threshold * torch.sqrt(sq.mean())
        if float((sq.sqrt() / cut - 1).abs().min()) <= 1e-4:
            return False
    return True


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "plain"])
@pytest.mark.parametrize("layout,dtype", [
    ("mobilenet-cifar reduced", torch.float32),
    ("resnet18-cifar reduced", torch.float32),
    ("ragged", torch.float32), ("ragged", torch.bfloat16)],
    ids=["mobilenet", "resnet18", "ragged-f32", "ragged-bf16"])
def test_mlless_sync_matches_reference_on_one_rank(group, layout, dtype,
                                                   use_kernel):
    """Three syncs carrying the residual: outputs and residuals equal the
    reference's bit for bit (the rows are checked to lie away from the
    cut first), and so do the counts of significant rows.  The fraction,
    count / rows, is correctly rounded in the port; the reference's XLA
    division can land one fp32 step above it (23 / 68 gives 0.33823532,
    not 0.33823529), so the fractions agree to one step."""
    shapes = _shapes(layout)
    jstrat = jget_strategy("mlless")
    strat = get_strategy("mlless", use_kernel=use_kernel)
    grads, _ = _case(shapes, seed=0, dtype=dtype)
    state = strat.init_state(grads)
    jstate = jstrat.init_state([jnp.zeros(s) for s in shapes])
    for step in range(3):
        grads, _ = _case(shapes, seed=step + 1, dtype=dtype)
        assert _far_from_cut(grads, state)
        jout, jstate, jinfo = _jax_sync(jstrat, grads, jstate)
        out, state, info = strat.sync(grads, state)
        assert len(out) == len(state) == len(shapes)
        for a, b in zip(out, jout):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(state, jstate):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        frac = info["significant_fraction"]
        jfrac = float(jinfo["significant_fraction"])
        rows = sum(-(-int(np.prod(s)) // 256) for s in shapes)
        assert frac.dtype == torch.float32
        assert round(float(frac) * rows) == round(jfrac * rows)
        assert float(frac) == float(np.float32(round(jfrac * rows) / rows))
        assert abs(float(frac) - jfrac) <= float(np.spacing(np.float32(jfrac)))
        assert 0 < float(frac) < 1


def test_mlless_state_is_views_of_one_buffer_and_takes_a_plain_list(group):
    """``init_state`` gives each leaf's fp32 zeros as views of one padded
    buffer; a plain list of residuals (a state built elsewhere) gives the
    same sync as the same values in that buffer."""
    grads, leaves = _case(RAGGED, seed=5)
    strat = get_strategy("mlless")
    state = strat.init_state(grads)
    assert [tuple(r.shape) for r in state] == RAGGED
    assert all(r.dtype == torch.float32 and not bool(r.any())
               for r in state)
    assert len({r.untyped_storage().data_ptr() for r in state}) == 1
    for r, leaf in zip(state, leaves):
        r.copy_(leaf)
    a = strat.sync(grads, state)
    b = strat.sync(grads, [leaf.clone() for leaf in leaves])
    for x, y in zip(list(a[0]) + list(a[1]), list(b[0]) + list(b[1])):
        assert torch.equal(x, y)
    assert float(a[2]["significant_fraction"]) == \
        float(b[2]["significant_fraction"])
