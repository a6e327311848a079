"""The port's Hopper kernels against their plain twins on an NVIDIA GPU.

Marked ``cuda``: without a GPU every test skips (the CUDA kernels have no
CPU mode).  Imports torch and numpy only, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import numpy as np  # noqa: E402

from repro_torch.kernels import block_significance as tbs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# (1, 256): one row; (257, 256): a ragged last block of rows; (300, 128)
# and (5, 7): rows narrower than 256, the second not a whole 16-byte pack;
# (12582, 256): every block of full-width MobileNet
SHAPES = [(1, 256), (257, 256), (300, 128), (5, 7), (12582, 256)]
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _blocks(n, b, dtype, dev, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, b).astype(np.float32) * rs.lognormal(size=(n, 1))
    return torch.from_numpy(x.astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_norms_kernel_matches_twin(cuda, n, b, dtype):
    """fp32 fma accumulation in another order: 1e-5 relative."""
    x = _blocks(n, b, dtype, cuda)
    before = tbs.LAUNCHES["block_norms"]
    got = tbs.block_norms(x)
    torch.cuda.synchronize()
    assert tbs.LAUNCHES["block_norms"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.cpu().numpy(),
                               tref.block_norms(x).cpu().numpy(), rtol=1e-5)


@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_filter_kernel_matches_twin(cuda, n, b, dtype):
    """Exact: the kernel rounds the same fp32 values once."""
    x = _blocks(n, b, dtype, cuda, seed=1)
    mask = torch.from_numpy(np.random.RandomState(2).rand(n) > 0.4).to(cuda)
    before = tbs.LAUNCHES["masked_filter"]
    kept, resid = tbs.masked_filter(x, mask)
    torch.cuda.synchronize()
    assert tbs.LAUNCHES["masked_filter"] == before + 1
    k2, r2 = tref.masked_filter(x, mask)
    assert kept.dtype == resid.dtype == dtype
    assert torch.equal(kept, k2) and torch.equal(resid, r2)


def test_ops_match_twins_on_cuda(cuda):
    """The mask compares norms that agree to 1e-5; these blocks stay 1e-4
    away from the threshold, so masks and filters agree exactly."""
    x = _blocks(300, 256, torch.float32, cuda, seed=3)
    sq = tref.block_norms(x).double()
    assert float((sq.sqrt() / (0.5 * sq.mean().sqrt()) - 1).abs().min()) \
        > 1e-4
    mask = tops.block_significance(x, 0.5)
    assert torch.equal(mask, tref.block_significance(x, 0.5))
    for a, b in zip(tops.significance_filter(x, 0.5),
                    tref.significance_filter(x, 0.5)):
        assert torch.equal(a, b)


def test_kernel_wrappers_validate_inputs(cuda):
    x = torch.randn(8, 256, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tbs.block_norms(x.t())
    with pytest.raises(TypeError, match="unsupported dtype"):
        tbs.block_norms(x.half())
    with pytest.raises(ValueError, match="mask"):
        tbs.masked_filter(x, torch.ones(7, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="mask"):
        tbs.masked_filter(x, torch.ones(8, dtype=torch.bool))


# ---------------------------------------------------------------------------
# the segmented MLLess filter (every leaf at once)
# ---------------------------------------------------------------------------
# the ragged layout: a one-value leaf, leaves of one row less and one value
# more than a row, a 391-row leaf
RAGGED = [(1,), (255,), (257,), (100_003,), (3, 3, 3, 32)]


def _segment_case(shapes, dtype, dev, seed, misalign=False):
    """Mixed-scale 256-wide rows and a residual from numpy, and their
    layout; ``misalign`` puts every leaf one value off 16-byte alignment
    (the kernels' one-value path)."""
    rs = np.random.RandomState(seed)
    grads, leaves = [], []
    for shape in shapes:
        n = int(np.prod(shape))
        scale = np.repeat(rs.lognormal(sigma=1.5, size=-(-n // 256)), 256)
        g = torch.from_numpy((rs.randn(n) * scale[:n]).astype(np.float32))
        g = g.to(dev, dtype)
        if misalign:
            g = torch.cat([g.new_zeros(1), g])[1:]
        grads.append(g.view(shape))
        leaves.append(torch.from_numpy(
            (0.3 * rs.randn(*shape)).astype(np.float32)).to(dev))
    layout = tbs.SegmentLayout(grads)
    return grads, layout.pack(leaves, dev), layout


def _far_rows(sq, layout, threshold=0.5):
    """Rows whose norm is more than 1e-4 from their leaf's cut, from the
    twin's sums: there the fp32 sums' order cannot flip the mask."""
    cut = torch.cat([threshold * torch.sqrt(sq[b0:b0 + nb].double().mean())
                     .expand(nb) for b0, nb in zip(layout.block0,
                                                   layout.blocks)])
    return (sq.double().sqrt() / cut - 1).abs() > 1e-4


def _mobilenet_shapes():
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_cnn, reference_leaves
    return [tuple(p.shape) for p in reference_leaves(
        build_cnn(get_config("mobilenet-cifar"), device="cpu"))]


@pytest.mark.parametrize("layout", ["mobilenet", "ragged",
                                    "ragged-misaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_segment_kernels_match_twins(cuda, layout, dtype):
    """One launch each: sums of squares within 1e-5 relative (fp32 fma in
    another order), masks equal away from the cut, counts the kernel
    mask's per leaf, and kept and residual bit-exact given the mask."""
    shapes = _mobilenet_shapes() if layout == "mobilenet" else RAGGED
    grads, resid, lay = _segment_case(shapes, dtype, cuda, seed=3,
                                      misalign=layout.endswith("misaligned"))
    before = dict(tbs.LAUNCHES)
    sq, mask, counts = tbs.segment_norms(grads, resid, lay, 0.5)
    kept, new = tbs.segment_filter(grads, resid, lay, mask)
    torch.cuda.synchronize()
    assert tbs.LAUNCHES == {**before,
                            "segment_norms": before["segment_norms"] + 1,
                            "segment_filter": before["segment_filter"] + 1}
    sq2, mask2, _ = tref.segment_norms(grads, resid, lay, 0.5)
    np.testing.assert_allclose(sq.cpu().numpy(), sq2.cpu().numpy(),
                               rtol=1e-5)
    far = _far_rows(sq2, lay)
    assert torch.equal(mask[far], mask2[far])
    assert counts.dtype == torch.int64 and counts.tolist() == [
        int(mask[b0:b0 + nb].sum()) for b0, nb in zip(lay.block0,
                                                      lay.blocks)]
    kept2, new2 = tref.segment_filter(grads, resid, lay, mask)
    assert torch.equal(kept, kept2) and torch.equal(new, new2)


def test_mlless_sync_runs_the_segmented_pair_on_cuda(cuda, tmp_path):
    """``MLLess.sync`` on CUDA gradients (one gloo rank): one launch of
    each segmented kernel, none of the per-leaf ones; outputs, residuals
    and fraction equal the plain twins' on the card where every row lies
    away from the cut."""
    import torch.distributed as dist
    from repro_torch.core import get_strategy
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        grads, resid, lay = _segment_case(RAGGED, torch.float32, cuda, 4)
        runs = []
        for use_kernel in (True, False):
            s = get_strategy("mlless", use_kernel=use_kernel)
            state = s.init_state(grads)
            for r, leaf in zip(state, lay.residual_views(resid)):
                r.copy_(leaf)
            before = dict(tbs.LAUNCHES)
            runs.append(s.sync(grads, state))
            torch.cuda.synchronize()
            moved = {k: tbs.LAUNCHES[k] - before[k] for k in before}
            assert moved == {"block_norms": 0, "masked_filter": 0,
                             "segment_norms": int(use_kernel),
                             "segment_filter": int(use_kernel)}
    finally:
        dist.destroy_process_group()
    sq, _, _ = tref.segment_norms(grads, resid, lay, 0.5)
    assert bool(_far_rows(sq, lay).all())
    (out, st, info), (out2, st2, info2) = runs
    for a, b in zip(list(out) + list(st), list(out2) + list(st2)):
        assert a.is_cuda and torch.equal(a, b)
    assert float(info["significant_fraction"]) == \
        float(info2["significant_fraction"])


def test_segment_wrappers_validate_inputs(cuda):
    grads, resid, lay = _segment_case(RAGGED[:3], torch.float32, cuda, 5)
    mask = torch.zeros(lay.n_rows, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="do not match"):
        tbs.segment_norms(grads[:2], resid, lay, 0.5)
    with pytest.raises(ValueError, match="resid must be"):
        tbs.segment_norms(grads, resid[:-1], lay, 0.5)
    with pytest.raises(ValueError, match="resid must be"):
        tbs.segment_filter(grads, resid.double(), lay, mask)
    with pytest.raises(ValueError, match="mask must be"):
        tbs.segment_filter(grads, resid, lay, mask[:-1])
    with pytest.raises(ValueError, match="is on"):
        tbs.segment_norms([g.cpu() for g in grads], resid, lay, 0.5)
    half = [g.half() for g in grads]
    with pytest.raises(TypeError, match="unsupported dtype"):
        tbs.segment_norms(half, resid, tbs.SegmentLayout(half), 0.5)


# ---------------------------------------------------------------------------
# robust aggregation
# ---------------------------------------------------------------------------
from repro_torch.kernels import robust_agg as tra  # noqa: E402

# W of every fleet the sweeps and the trainer use, up to the instantiated
# maximum; D ragged against the 256-thread blocks and 128-column tiles
ROBUST_W = [3, 4, 5, 7, 8, 12, 16, 32]
ROBUST_D = 4099


def _stack(W, D, dev, seed=0):
    """Rows of mixed scale, with tie columns, constant columns and one
    row scaled by 1e30 over a stretch."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(W, D) * rs.choice([1.0, 100.0], size=(W, 1))).astype(
        np.float32)
    x[:, :7] = 2.5                      # constant columns
    x[1, 7:40] = x[2, 7:40]             # ties
    x[:, 40:60] = np.round(x[:, 40:60])
    x[0, 60:90] *= 1e30                 # a huge byzantine stretch
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("W", ROBUST_W)
def test_trimmed_mean_and_median_kernels_are_exact(cuda, W):
    """Same compares, the same fp32 adds in the same row order and an
    IEEE division: bit-exact against the plain versions, for every legal
    trim."""
    x = _stack(W, ROBUST_D, cuda, seed=W)
    for trim in range(1, (W - 1) // 2 + 1):
        before = tra.LAUNCHES["trimmed_mean"]
        got = tra.trimmed_mean(x, trim)
        torch.cuda.synchronize()
        assert tra.LAUNCHES["trimmed_mean"] == before + 1
        assert got.shape == (ROBUST_D,) and bool(torch.isfinite(got).all())
        assert torch.equal(got, tref.trimmed_mean(x, trim)), (W, trim)
    got = tra.coordinate_median(x)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.coordinate_median(x)), W
    if W % 2 == 0:   # the mean of the two middle values, not the lower one
        assert not torch.equal(got, torch.median(x, dim=0).values)


@pytest.mark.parametrize("W", ROBUST_W)
def test_krum_pairwise_kernel_matches_plain(cuda, W):
    """Both sum fp32 products of the same rows in other orders (the plain
    version through an fp32 matrix product, TF32 off): each distance
    within 1e-5 of ||xi||^2 + ||xj||^2.  The diagonal is exactly 0, the
    matrix exactly symmetric, and a second call gives the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _stack(W, ROBUST_D, cuda, seed=W)[:, 100:]
    before = tra.LAUNCHES["krum_pairwise"]
    got = tra.krum_pairwise(x)
    again = tra.krum_pairwise(x)
    torch.cuda.synchronize()
    assert tra.LAUNCHES["krum_pairwise"] == before + 2
    want = tref.krum_pairwise(x)
    n = torch.sum(x.double() ** 2, dim=1)
    tol = 1e-5 * (n[:, None] + n[None, :])
    assert bool(((got.double() - want.double()).abs() <= tol).all())
    assert torch.equal(got, again) and torch.equal(got, got.T)
    assert bool((torch.diagonal(got) == 0).all())


@pytest.mark.parametrize("residue", range(4))
@pytest.mark.parametrize("W", range(1, 33))
def test_krum_pairwise_every_width_and_residue(cuda, W, residue):
    """Every W of the kernels (the streaming kernel at W <= 8, the tile
    form above) and D of each residue mod 4, where rows start 4, 8 or 12
    bytes off a 16-byte boundary, from an aligned base and from one 4
    bytes off: within 1e-5 of ||xi||^2 + ||xj||^2 of the plain version, one
    launch a call, the diagonal 0, symmetric, a second launch the same
    bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    D = 20_000 + residue
    rs = np.random.RandomState(W + residue)
    scale = np.append(np.repeat(rs.choice([1.0, 100.0], size=W), D), 1.0)
    flat = torch.from_numpy((rs.randn(W * D + 1) * scale).astype(
        np.float32)).to(cuda)           # rows of mixed scale
    for x in (flat[:W * D].view(W, D), flat[1:W * D + 1].view(W, D)):
        before = tra.LAUNCHES["krum_pairwise"]
        got = tra.krum_pairwise(x)
        again = tra.krum_pairwise(x)
        torch.cuda.synchronize()
        assert tra.LAUNCHES["krum_pairwise"] == before + 2
        want = tref.krum_pairwise(x)
        n = torch.sum(x.double() ** 2, dim=1)
        tol = 1e-5 * (n[:, None] + n[None, :])
        assert bool(((got.double() - want.double()).abs() <= tol).all())
        assert torch.equal(got, again) and torch.equal(got, got.T)
        assert bool((torch.diagonal(got) == 0).all())


def test_krum_pairwise_is_deterministic_at_mobilenet_width(cuda):
    """At W = 4 on a stack of the full-width MobileNet gradient's length
    (D = 3,217,226, 2 mod 4), ten launches give the same bits: the block
    partials are summed in a fixed order, with no float atomics."""
    x = _stack(4, 3_217_226 + 100, cuda, seed=5)[:, 100:]
    first = tra.krum_pairwise(x)
    for _ in range(9):
        assert torch.equal(tra.krum_pairwise(x), first)
    assert bool(torch.isfinite(first).all())


@pytest.mark.parametrize("W", ROBUST_W)
def test_weiszfeld_step_kernel_matches_plain(cuda, W):
    """Pass 1 sums the squared distances in another order than the plain
    version, so the weights differ in the last bits: the step agrees to
    1e-5 of the largest value.  Two calls give the same bits."""
    x = _stack(W, ROBUST_D, cuda, seed=W)[:, 100:].contiguous()
    z = tref.coordinate_median(x)
    floor = 1e-12 * float(torch.linalg.vector_norm(x, dim=1).max())
    before = tra.LAUNCHES["weiszfeld_step"]
    got = tra.weiszfeld_step(x, z, floor)
    again = tra.weiszfeld_step(x, z, floor)
    torch.cuda.synchronize()
    assert tra.LAUNCHES["weiszfeld_step"] == before + 4   # two passes each
    want = tref.weiszfeld_step(x, z, floor)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert torch.equal(got, again)


def test_robust_kernels_validate_inputs(cuda):
    """Above the instantiated W the wrappers raise; they never give way
    to the plain version."""
    x = torch.randn(tra.MAX_W + 1, 300, device=cuda)
    for fn in (tra.coordinate_median, tra.krum_pairwise,
               lambda s: tra.trimmed_mean(s, 1),
               lambda s: tra.weiszfeld_step(s, s[0], 1e-12)):
        with pytest.raises(ValueError, match="W <= 32"):
            fn(x)
    with pytest.raises(ValueError, match="W > 2"):
        tra.trimmed_mean(x[:4], 2)
    with pytest.raises(ValueError, match="z of length"):
        tra.weiszfeld_step(x[:4], x[0, :10], 1e-12)


_GLOO_PROBE = """
import sys
import torch
import torch.distributed as dist
rank, init = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
x = torch.arange(8, dtype=torch.float32, device="cuda") + 10 * rank
s = x.clone()
dist.all_reduce(s)
assert s.is_cuda and torch.equal(s.cpu(), torch.arange(8.) * 2 + 10)
g = torch.empty(16, device="cuda")
dist.all_gather_into_tensor(g, x)
assert torch.equal(g.cpu(), torch.cat([torch.arange(8.),
                                       torch.arange(8.) + 10]))
c = torch.empty(4, device="cuda")
dist.reduce_scatter_tensor(c, x)
assert torch.equal(c.cpu(), (torch.arange(8.) * 2 + 10)[4 * rank:4 * rank + 4])
# QuantizedScatterReduce: int8 rows and fp32 scales through all_to_all_single,
# then a list all_gather of each
for dtype in (torch.int8, torch.float32):
    q = (torch.arange(8, device="cuda") - 5 * rank).to(dtype)
    y = torch.empty_like(q)
    dist.all_to_all_single(y, q)
    want = torch.cat([(torch.arange(8) - 5 * p)[4 * rank:4 * rank + 4]
                      for p in range(2)]).to(dtype)
    assert y.is_cuda and y.dtype == dtype and torch.equal(y.cpu(), want)
    parts = [torch.empty_like(q) for _ in range(2)]
    dist.all_gather(parts, q)
    want = torch.stack([torch.arange(8) - 5 * p for p in range(2)]).to(dtype)
    assert all(t.is_cuda for t in parts)
    assert torch.equal(torch.stack(parts).cpu(), want)
dist.destroy_process_group()
"""


def test_gloo_collectives_take_cuda_tensors(cuda, tmp_path):
    """Two gloo ranks on one card: NCCL refuses two ranks on the same GPU,
    so the byzantine trainer's ranks share a card over gloo.  Gloo runs
    every collective the port uses on CUDA tensors (QuantizedScatterReduce's
    ``all_to_all_single`` and list ``all_gather`` on int8 too), so the port
    stages none through host memory itself."""
    import os
    import subprocess
    import sys
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_PROBE, str(r), f"file://{tmp_path}/pg"],
        stderr=subprocess.PIPE, text=True, env=env) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]


def test_quantized_sync_on_cuda_equals_cpu(cuda, tmp_path):
    """``QuantizedScatterReduce.sync`` on CUDA gradients (one gloo rank)
    equals the same sync on the CPU bit for bit, output and residual:
    the quantizer's division, the reciprocal products and the float64
    fused multiply-adds round alike on both devices."""
    import torch.distributed as dist
    from repro_torch.core import get_strategy
    rs = np.random.RandomState(3)
    shapes = [(3, 3, 1, 40), (1500,), (7,), (512,), (2, 515)]
    grads = [torch.from_numpy((rs.randn(*s) * rs.lognormal(0, 3, s))
                              .astype(np.float32)) for s in shapes]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        q = get_strategy("quantized_scatterreduce")
        runs = []
        for g in (grads, [x.to(cuda) for x in grads]):
            out, resid, _ = q.sync(g, q.init_state(g))
            out2, resid2, _ = q.sync(g, resid)
            runs.append(list(out) + list(resid) + list(out2) + list(resid2))
    finally:
        dist.destroy_process_group()
    for a, b in zip(runs[1], runs[0]):
        assert a.is_cuda and torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# the LM kernels: fused AdamW and sliding-window attention
# ---------------------------------------------------------------------------
from repro_torch.kernels import fused_adamw as tfa  # noqa: E402
from repro_torch.kernels import swa_attention as tswa  # noqa: E402
from repro_torch.optim import bias_corrections  # noqa: E402

# every leaf of full-width SmolLM-135M (reference order), then ragged n
SMOLLM_LEAVES = [(30, 576, 192), (30, 576, 576), (30, 576, 576),
                 (30, 576, 192), (30, 1536, 576), (30, 576, 1536),
                 (30, 576, 1536), (30, 576), (30, 576), (49152, 576),
                 (576,), (576, 49152)]
ADAMW_KW = dict(lr=3e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.1)


def _adamw_operands(n, gdtype, pdtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(n, generator=gen, device=dev).to(gdtype)
    m = torch.randn(n, generator=gen, device=dev) * 0.1
    v = torch.rand(n, generator=gen, device=dev) * 0.01
    p = torch.randn(n, generator=gen, device=dev).to(pdtype)
    return g, m, v, p


@pytest.mark.parametrize("shape", SMOLLM_LEAVES + [(1,), (7,), (255,),
                                                   (257,), (100_003,)],
                         ids=str)
@pytest.mark.parametrize("gdtype,pdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32)], ids=["bf16", "f32g-bf16p", "f32"])
def test_fused_adamw_kernel_is_bit_exact(cuda, shape, gdtype, pdtype):
    """Explicitly rounded fp32 operations in the plain version's order
    (and a correctly rounded root in both): u, m' and v' bit for bit."""
    n = int(np.prod(shape))
    g, m, v, p = _adamw_operands(n, gdtype, pdtype, cuda, seed=n % 1000)
    c1, c2 = bias_corrections(0.9, 0.95, 3, cuda)
    want = tref.fused_adamw_flat(g, m, v, p, c1, c2, **ADAMW_KW)
    before = tfa.LAUNCHES["fused_adamw_flat"]
    u, m2, v2 = tfa.fused_adamw_flat(g, m, v, p, c1, c2, **ADAMW_KW)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["fused_adamw_flat"] == before + 1
    assert m2 is m and v2 is v and u.dtype == pdtype
    assert torch.equal(m, want[1]) and torch.equal(v, want[2])
    assert torch.equal(u, want[0].to(pdtype))


def test_optimizer_fused_and_plain_paths_agree_on_cuda(cuda):
    """``adamw(use_fused=True)`` (one launch per leaf) and the plain path
    give the same parameters and moments over three steps."""
    from repro_torch import optim
    shapes = [(64, 48), (1000,), (3, 5, 7)]
    runs = []
    for fused in (True, False):
        gen = torch.Generator(device=cuda).manual_seed(0)
        params = [torch.randn(s, generator=gen, device=cuda).bfloat16()
                  for s in shapes]
        opt = optim.adamw(3e-3, weight_decay=0.1, use_fused=fused)
        state = opt.init(params)
        for _ in range(3):
            grads = [torch.randn(s, generator=gen, device=cuda).bfloat16()
                     for s in shapes]
            ups, state = opt.update(grads, state, params)
            optim.apply_updates(params, ups)
        runs.append(params + state["m"] + state["v"])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# (B, S, H, KV, hd, window, causal): SmolLM's train and long shapes,
# windows 64 and 1024 (Gemma-3), a ragged S, hd 96 (Phi-3) and 128
# (Qwen1.5), 16 heads on one kv head, and a full (non-causal) call
SWA_GPU_CASES = [
    (16, 128, 9, 3, 64, None, True),
    (8, 2048, 9, 3, 64, None, True),
    (2, 2048, 9, 3, 64, 64, True),
    (2, 2048, 8, 4, 64, 1024, True),
    (2, 1000, 9, 3, 64, None, True),
    (2, 1000, 9, 3, 64, 100, True),
    (1, 512, 32, 32, 96, None, True),
    (1, 512, 20, 20, 128, 128, True),
    (1, 256, 16, 1, 64, None, True),
    (2, 300, 4, 2, 32, None, False),
]


# the model families' attention: Mixtral 8x7B's 32 heads on 8 at hd 128
# with its window of 4096 past S, Mixtral 8x22B's 48 on 8 (6 q heads a kv
# head), Whisper's decoder (12 on 12, hd 64) at its train length of 448
SWA_FAMILY_CASES = [
    (1, 2048, 32, 8, 128, 4096, True),
    (4, 512, 32, 8, 128, 4096, True),
    (2, 512, 48, 8, 128, 4096, True),
    (4, 448, 12, 12, 64, None, True),
]
SWA_GPU_CASES += SWA_FAMILY_CASES


# the heads a rank sees under tensor parallelism: Mixtral 8x7B's 32 / 8
# over 2, Whisper's decoder's 12 / 12 over 2, SmolLM-135M's 9 / 3 on
# (1, 6), where neither divides and every rank runs every head
SWA_GPU_CASES += [
    (2, 512, 16, 4, 128, 4096, True),
    (2, 448, 6, 6, 64, None, True),
    (2, 2048, 9, 3, 64, None, True),
]


# the wide head_dims, on the wgmma route in bf16 and the 3xTF32 route in
# fp32 (at 320 a warp pair a row): Gemma-3's 320 (its local and global
# layers at its train shape, a ragged S), pixtral-12b's 160 (32 heads on
# 8), recurrentgemma-2b's 256 (10 heads on 1) and a full (non-causal) call
# at 256
SWA_WIDE_CASES = [
    (1, 2048, 8, 4, 320, 1024, True),
    (1, 2048, 8, 4, 320, None, True),
    (2, 1000, 8, 4, 320, 100, True),
    (1, 512, 32, 8, 160, None, True),
    (1, 512, 10, 1, 256, 128, True),
    (2, 300, 4, 2, 256, None, False),
    # under tensor parallelism over 2: RecurrentGemma's 10 / 1 heads,
    # Pixtral's 32 / 8 at its prompt of 1,280
    (2, 512, 5, 1, 256, 2048, True),
    (1, 1280, 16, 4, 160, None, True),
]


@pytest.mark.parametrize("case", SWA_WIDE_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_swa_attention_wide_head_dims_match_plain(cuda, case, dtype):
    """One launch, on the wgmma kernel in bf16 and on the 3xTF32 kernel
    in fp32 (at hd 320 too), at the gates of the narrower head_dims: 2e-5
    in fp32, one bf16 step in bf16."""
    B, S, H, KV, hd, window, causal = case
    gen = torch.Generator(device=cuda).manual_seed(S + H + hd)
    q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=cuda)
               .to(dtype) for n in (H, KV, KV))
    before = dict(tswa.LAUNCHES)
    got = tswa.swa_attention_fwd(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert tswa.LAUNCHES == {
        "swa_attention_fwd": before["swa_attention_fwd"] + 1,
        "swa_attention_fwd_wgmma": before["swa_attention_fwd_wgmma"]
        + (dtype == torch.bfloat16),
        "swa_attention_fwd_tf32": before["swa_attention_fwd_tf32"]
        + (dtype == torch.float32)}
    want = tref.swa_attention(q, k, v, window=window, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-5)


@pytest.mark.parametrize("case", SWA_GPU_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_swa_attention_kernel_matches_plain(cuda, case, dtype):
    """Both compute in fp32 from the same inputs, in other orders: 2e-5
    in fp32 (the 3xTF32 kernel, products to about 21 bits); in bf16 (the
    wgmma kernel, P.V as two bf16 products) each rounds its result once,
    so they may sit one bf16 step (2^-7 relative) apart."""
    B, S, H, KV, hd, window, causal = case
    gen = torch.Generator(device=cuda).manual_seed(S + H + hd)
    q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=cuda)
               .to(dtype) for n in (H, KV, KV))
    before = dict(tswa.LAUNCHES)
    got = tswa.swa_attention_fwd(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert tswa.LAUNCHES["swa_attention_fwd"] == \
        before["swa_attention_fwd"] + 1
    assert tswa.LAUNCHES["swa_attention_fwd_wgmma"] == \
        before["swa_attention_fwd_wgmma"] + (dtype == torch.bfloat16)
    assert tswa.LAUNCHES["swa_attention_fwd_tf32"] == \
        before["swa_attention_fwd_tf32"] + (dtype == torch.float32)
    want = tref.swa_attention(q, k, v, window=window, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_swa_attention_gradient_on_cuda(cuda, dtype):
    """The gradient through ``ops.swa_attention`` (kernel forward, chunked
    flash backward) against plain fp32 autograd through the naive version
    on the same values, TF32 off.  fp32: 1e-4.  bf16 (the forward on the
    tensor-core route): the gradient is fp32 arithmetic on bf16 operands
    (the loss's gradient, taken from the bf16 output, among them) rounded
    to bf16, so it is held within one bf16 step (2^-7) of the largest
    fp32 gradient; plain bf16 autograd through the naive version lands
    about 2^-8 of it away at this shape (NVIDIA H100)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = [torch.randn(1, 256, n, 64, generator=gen, device=cuda).to(dtype)
           for n in (4, 2, 2)]
    a = [t.clone().requires_grad_() for t in qkv]
    b = [t.float().requires_grad_() for t in qkv]
    before = dict(tswa.LAUNCHES)
    torch.sum(torch.tanh(tops.swa_attention(*a, window=64).float())) \
        .backward()
    torch.sum(torch.tanh(tref.swa_attention(*b, window=64))).backward()
    assert tswa.LAUNCHES["swa_attention_fwd"] == \
        before["swa_attention_fwd"] + 1
    assert tswa.LAUNCHES["swa_attention_fwd_wgmma"] == \
        before["swa_attention_fwd_wgmma"] + (dtype == torch.bfloat16)
    assert tswa.LAUNCHES["swa_attention_fwd_tf32"] == \
        before["swa_attention_fwd_tf32"] + (dtype == torch.float32)
    for x, y in zip(a, b):
        assert x.grad.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(x.grad, y.grad, rtol=0, atol=1e-4)
        else:
            err = float((x.grad.float() - y.grad).abs().max())
            assert err <= 2 ** -7 * float(y.grad.abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_swa_attention_gradient_at_head_dim_320(cuda, dtype):
    """Gemma-3's head_dim (8 heads on 4, its local window) through
    ``ops.swa_attention``, at the gates of ``test_swa_attention_gradient_on
    _cuda``: fp32 1e-4 (the forward on the 3xTF32 route, a warp pair a
    row); bf16 (the forward on the wgmma route) within one bf16 step of the
    largest fp32 gradient."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(320)
    qkv = [torch.randn(1, 256, n, 320, generator=gen, device=cuda).to(dtype)
           for n in (8, 4, 4)]
    a = [t.clone().requires_grad_() for t in qkv]
    b = [t.float().requires_grad_() for t in qkv]
    before = dict(tswa.LAUNCHES)
    torch.sum(torch.tanh(tops.swa_attention(*a, window=64).float())) \
        .backward()
    torch.sum(torch.tanh(tref.swa_attention(*b, window=64))).backward()
    assert tswa.LAUNCHES["swa_attention_fwd"] == \
        before["swa_attention_fwd"] + 1
    assert tswa.LAUNCHES["swa_attention_fwd_wgmma"] == \
        before["swa_attention_fwd_wgmma"] + (dtype == torch.bfloat16)
    assert tswa.LAUNCHES["swa_attention_fwd_tf32"] == \
        before["swa_attention_fwd_tf32"] + (dtype == torch.float32)
    for x, y in zip(a, b):
        assert x.grad.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(x.grad, y.grad, rtol=0, atol=1e-4)
        else:
            err = float((x.grad.float() - y.grad).abs().max())
            assert err <= 2 ** -7 * float(y.grad.abs().max()), err


def _sass_functions(stem, kernel):
    """The SASS (``cuobjdump -sass``) of each instantiation of ``kernel``
    in the library built from ``csrc/<stem>.cu``."""
    import shutil
    import subprocess
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or f"{CUDA_HOME}/bin/cuobjdump"
    lib = _build._build_all()[stem]
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return [f for f in sass.split("Function : ")[1:]
            if kernel in f.split("\n", 1)[0]]


def test_swa_wgmma_kernel_is_built_on_tensor_cores_and_tma(cuda):
    """The tensor-core kernel's SASS holds wgmma (HGMMA) and TMA loads
    (UTMALDG), as compiled for sm_90a from ``csrc/swa_attention_tc.cu``, in
    each of its five instantiations (hd padded to 64, 128, 192, 256 and
    320)."""
    kernels = _sass_functions("swa_attention_tc", "swa_wgmma_kernel")
    widths = sorted(w for w in (64, 128, 192, 256, 320) for body in kernels
                    if f"ILi{w}E" in body.split("\n", 1)[0])
    assert widths == [64, 128, 192, 256, 320], widths
    for body in kernels:
        assert "HGMMA" in body and "UTMALDG" in body


def test_swa_tf32_kernel_is_built_on_tensor_cores_without_spills(cuda):
    """The fp32 kernel's SASS holds TF32 ``mma.sync`` (HMMA) in each of its
    seven instantiations (every head_dim of ``TF32_HEAD_DIMS``), as compiled
    for sm_90a from ``csrc/swa_attention_tf32.cu``, and no local-memory
    store (STL): no instantiation spills its registers."""
    kernels = _sass_functions("swa_attention_tf32", "swa_tf32_kernel")
    widths = sorted(w for w in tswa.HEAD_DIMS for body in kernels
                    if f"ILi{w}E" in body.split("\n", 1)[0])
    assert widths == list(tswa.TF32_HEAD_DIMS), widths
    for body in kernels:
        assert "HMMA" in body and "TF32" in body
        assert "STL" not in body, body.split("\n", 1)[0]


@pytest.mark.parametrize("hd", [64, 256, 320])
def test_swa_attention_f32_row_does_not_change_with_its_batch(cuda, hd):
    """On the 3xTF32 route an output row depends on its own q row and the
    keys it attends to alone: the rows of batch entry 1 equal bit for bit
    those of entry 1 called alone, and those of kv head 1's query heads
    called alone (the heads a tensor-parallel rank holds: another group
    size G, so other q tiles), as the fp32 engine's and the ranks' token
    equalities need.  At hd 320 a warp pair shares each row's scores
    through shared memory, which must keep that."""
    H, KV = {64: (9, 3), 256: (8, 2), 320: (8, 4)}[hd]
    G = H // KV
    gen = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v = (torch.randn(3, 700, n, hd, generator=gen, device=cuda)
               for n in (H, KV, KV))
    for window in (None, 100):
        whole = tswa.swa_attention_fwd(q, k, v, window=window)
        alone = tswa.swa_attention_fwd(q[1:2], k[1:2], v[1:2],
                                       window=window)
        heads = tswa.swa_attention_fwd(
            q[:, :, G:G + 1].contiguous(), k[:, :, 1:2].contiguous(),
            v[:, :, 1:2].contiguous(), window=window)
        torch.cuda.synchronize()
        assert torch.equal(whole[1:2], alone)
        assert torch.equal(whole[:, :, G:G + 1], heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(0, 128, 9, 64), (2, 0, 9, 64)],
                         ids=["B0", "S0"])
def test_swa_attention_empty_input_launches_nothing(cuda, dtype, shape):
    """An empty q returns an empty output without a launch, so neither
    counter moves on either route."""
    B, S, H, hd = shape
    q = torch.zeros(B, S, H, hd, device=cuda, dtype=dtype)
    kv = torch.zeros(B, S, 3, hd, device=cuda, dtype=dtype)
    before = dict(tswa.LAUNCHES)
    got = tswa.swa_attention_fwd(q, kv, kv)
    assert got.shape == q.shape and got.dtype == dtype
    assert tswa.LAUNCHES == before


def test_lm_kernel_wrappers_validate_inputs(cuda):
    """They raise on what the kernels do not take; they never give way to
    the plain version."""
    q = torch.randn(1, 64, 8, 384, device=cuda)
    with pytest.raises(ValueError, match="head_dim 384"):
        tswa.swa_attention_fwd(q, q[:, :, :4], q[:, :, :4])
    q = torch.randn(1, 64, 4, 64, device=cuda)
    with pytest.raises(TypeError, match="share"):
        tswa.swa_attention_fwd(q, q.bfloat16(), q)
    with pytest.raises(TypeError, match="share"):
        tswa.swa_attention_fwd(q.half(), q.half(), q.half())
    g, m, v, p = _adamw_operands(100, torch.float32, torch.float32, cuda, 0)
    c1, c2 = bias_corrections(0.9, 0.95, 1, cuda)
    with pytest.raises(TypeError, match="unsupported p dtype"):
        tfa.fused_adamw_flat(g, m, v, p.half(), c1, c2, **ADAMW_KW)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.fused_adamw_flat(g, m, v, torch.randn(200, device=cuda)[::2],
                             c1, c2, **ADAMW_KW)
    with pytest.raises(ValueError, match="c1 is on"):
        tfa.fused_adamw_flat(g, m, v, p, c1.cpu(), c2, **ADAMW_KW)


# ---------------------------------------------------------------------------
# the RWKV6 WKV recurrence
# ---------------------------------------------------------------------------
from repro_torch.kernels import wkv6 as twkv  # noqa: E402

# (B, T, H, N, chunk, mu), logw = -exp(N(mu, 0.5)): the reference's cases,
# a ragged T for the halved chunk, chunk 1, rwkv6-7b's train shape, and
# decays from mild to strong (mu 3: the Pallas body's unmasked exp
# overflows)
WKV_GPU_CASES = [
    (2, 64, 2, 32, 16, -2.0),
    (1, 128, 4, 64, 64, -2.0),
    (2, 96, 3, 16, 32, -2.0),
    (3, 64, 5, 16, 1, -2.0),
    (4, 512, 64, 64, 64, -2.0),
    (1, 256, 4, 64, 32, 0.0),
    (1, 64, 2, 32, 64, 1.5),
    (2, 128, 8, 64, 64, 3.0),
    # RWKV6's 64 heads over the model axis of 2, at the TP train shape
    (2, 512, 32, 64, 64, -2.0),
]


def _wkv_operands(B, T, H, N, mu, dtype, dev, seed=0):
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(B, T, H, N) * 0.5 for _ in range(3)]
    arrs.append(-np.exp(rs.randn(B, T, H, N) * 0.5 + mu))
    arrs.append(rs.randn(H, N) * 0.5)
    return [torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
            for a in arrs]


def _tc_route(N, chunk):
    return N in twkv.TC_HEAD_DIMS and chunk in twkv.TC_CHUNKS


@pytest.mark.parametrize("case", WKV_GPU_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wkv6_kernel_matches_plain(cuda, case, dtype):
    """The kernel the wrapper takes for the shape (the tensor cores at N
    32/64 with chunk 16/32/64, the CUDA cores at N 16 or chunk 1) against
    its plain chunked twin on the card (and the exact recurrence for
    T <= 128), same inputs: 1e-4 in fp32 (the reference test's
    tolerance); in bf16 5e-2 plus one bf16 step (2^-7 relative), since
    each side rounds its fp32 result once."""
    B, T, H, N, chunk, mu = case
    r, k, v, lw, u = _wkv_operands(B, T, H, N, mu, dtype, cuda, seed=T + N)
    before = dict(twkv.LAUNCHES)
    got = twkv.wkv6_chunked(r, k, v, lw, u, chunk=chunk)
    torch.cuda.synchronize()
    assert twkv.LAUNCHES["wkv6_chunked"] == before["wkv6_chunked"] + 1
    assert (twkv.LAUNCHES["wkv6_chunked_tc"]
            == before["wkv6_chunked_tc"] + _tc_route(N, chunk))
    assert got.dtype == dtype and got.shape == r.shape
    assert bool(torch.isfinite(got).all())
    wants = [tref.wkv6_chunked(r, k, v, lw, u, chunk=chunk)]
    if T <= 128:
        wants.append(tref.wkv6(r, k, v, lw, u))
    for want in wants:
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2 ** -7, atol=5e-2)


@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mu", [-2.0, 3.0], ids=["mild", "strong"])
def test_wkv6_tc_route_matches_plain(cuda, N, chunk, dtype, mu):
    """The tensor-core route at every N and chunk it takes, mild and
    strong decay (mu 3: per-step decays down to exp(-e^4.5)), against the
    chunked twin, the exact recurrence and, in fp32, its own two-level
    twin ``ref.wkv6_subchunked``: finite, 1e-4 in fp32; in bf16 5e-2
    plus one bf16 step."""
    r, k, v, lw, u = _wkv_operands(2, 128, 3, N, mu, dtype, cuda,
                                   seed=N + chunk)
    before = twkv.LAUNCHES["wkv6_chunked_tc"]
    got = twkv.wkv6_chunked(r, k, v, lw, u, chunk=chunk)
    torch.cuda.synchronize()
    assert twkv.LAUNCHES["wkv6_chunked_tc"] == before + 1
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    wants = [tref.wkv6_chunked(r, k, v, lw, u, chunk=chunk),
             tref.wkv6(r, k, v, lw, u)]
    if dtype == torch.float32:
        wants.append(tref.wkv6_subchunked(r, k, v, lw, u, chunk=chunk))
    for want in wants:
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2 ** -7, atol=5e-2)


@pytest.mark.parametrize("N,T,chunk,tc", [
    (64, 128, 64, True), (64, 128, 32, True), (32, 64, 16, True),
    (16, 64, 16, False), (16, 128, 64, False), (32, 64, 8, False),
    (64, 37, 1, False), (64, 64, 4, False)], ids=str)
def test_wkv6_route_follows_the_shape(cuda, N, T, chunk, tc):
    """N 32/64 with chunk 16/32/64 raises the tensor-core counter; N 16,
    and chunks under 16 (what ``ops.wkv6`` gives a ragged T), stay on
    ``csrc/wkv6.cu``.  Both count under ``wkv6_chunked``; the result is
    the function on either route."""
    r, k, v, lw, u = _wkv_operands(1, T, 2, N, -2.0, torch.float32, cuda)
    before = dict(twkv.LAUNCHES)
    got = twkv.wkv6_chunked(r, k, v, lw, u, chunk=chunk)
    torch.cuda.synchronize()
    assert twkv.LAUNCHES["wkv6_chunked"] == before["wkv6_chunked"] + 1
    assert (twkv.LAUNCHES["wkv6_chunked_tc"]
            == before["wkv6_chunked_tc"] + tc)
    torch.testing.assert_close(got, tref.wkv6(r, k, v, lw, u), rtol=0,
                               atol=1e-4)


def _wkv_cuda_core(ins, chunk):
    """The CUDA-core kernel through its C entry point, at a shape the
    wrapper sends to the tensor cores."""
    r = ins[0]
    B, T, H, N = r.shape
    y = torch.empty_like(r)
    lib = twkv._build._library("wkv6", twkv._SIGNATURES)
    assert lib.rt_wkv6_chunked(*(t.data_ptr() for t in ins), y.data_ptr(),
                               twkv._DTYPES[r.dtype], B, T, H, N, chunk,
                               torch.cuda.current_stream().cuda_stream) == 0
    return y


@pytest.mark.parametrize("N,chunk", [(64, 64), (32, 32)], ids=str)
@pytest.mark.parametrize("case", ["large", "top_r", "top_k", "top_v",
                                  "steep_decay"])
def test_wkv6_routes_agree_at_extreme_inputs(cuda, N, chunk, case):
    """The two routes on one set of extreme fp32 inputs, each against the
    exact recurrence: r, k and v all scaled by 2^36; one of r, k, v with
    entries at fp32's largest value in the first and last rows of
    sub-chunks of 16, where the tensor-core kernel's operands are r and k
    themselves (the others, and u, scaled by 2^-8, so the exact output
    stays finite); per-step decays of about exp(-1e30).
    Both routes are finite and within the fp32 gate of 1e-4 scaled as the
    output scales (y is linear in each of r, k and v)."""
    fmax = torch.finfo(torch.float32).max
    r, k, v, lw, u = _wkv_operands(1, 128, 2, N, -2.0, torch.float32, cuda,
                                   seed=N + len(case))
    scale = 1.0
    if case == "large":
        r, k, v = (t * 2.0 ** 36 for t in (r, k, v))
        scale = 2.0 ** 108
    elif case == "steep_decay":
        lw = _wkv_operands(1, 128, 2, N, 69.0, torch.float32, cuda,
                           seed=1)[3]
        assert float(lw.max()) < -1e28
    else:
        big = case[-1]
        ins = {"r": r, "k": k, "v": v}
        for name in ins:
            if name != big:
                ins[name] = ins[name] * 2.0 ** -8
        for t0 in (15, 16):     # the last and first rows of sub-chunks
            ins[big][0, t0::16, :, ::7] = fmax * torch.sign(
                ins[big][0, t0::16, :, ::7])
        r, k, v = ins["r"], ins["k"], ins["v"]
        u = u * 2.0 ** -8
        scale = 2.0 ** 112
    ins = [r, k, v, lw, u]
    before = twkv.LAUNCHES["wkv6_chunked_tc"]
    tc = twkv.wkv6_chunked(*ins, chunk=chunk)
    core = _wkv_cuda_core(ins, chunk)
    torch.cuda.synchronize()
    assert twkv.LAUNCHES["wkv6_chunked_tc"] == before + 1
    exact = tref.wkv6(*ins)
    assert bool(torch.isfinite(exact).all())
    for got in (tc, core):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, exact, rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(tc, core, rtol=0, atol=1e-4 * scale)


def test_wkv6_tc_kernel_is_built_on_tensor_cores(cuda):
    """Every instantiation of the tensor-core kernel's SASS holds TF32
    mma (HMMA), as compiled for sm_90a from ``csrc/wkv6_tc.cu``."""
    kernels = _sass_functions("wkv6_tc", "wkv6_tc_kernel")
    assert len(kernels) == 12       # fp32 / bf16 x N 32, 64 x c 16, 32, 64
    for body in kernels:
        assert "HMMA" in body


def test_wkv6_gradient_on_cuda(cuda):
    """The gradient through ``ops.wkv6`` (the kernel forward, on the
    tensor cores at N 64 and chunk 64, in the model's autograd Function,
    the chunk-128 recompute backward) on the card against the same on the
    CPU, fp32 with TF32 off: 1e-4."""
    from repro_torch.models import rwkv6
    torch.backends.cuda.matmul.allow_tf32 = False
    ins = _wkv_operands(2, 256, 4, 64, -1.0, torch.float32, "cpu", seed=9)
    gy = torch.from_numpy(np.random.RandomState(10).randn(2, 256, 4, 64)
                          .astype(np.float32))
    a = [t.to(cuda).requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    before = dict(twkv.LAUNCHES)
    ya = rwkv6._WkvKernel.apply(*a)
    ya.backward(gy.to(cuda))
    rwkv6._WkvKernel.apply(*b).backward(gy)
    for key in ("wkv6_chunked", "wkv6_chunked_tc"):
        assert twkv.LAUNCHES[key] == before[key] + 1
    torch.testing.assert_close(ya.detach().cpu(), tops.wkv6(*ins), rtol=0,
                               atol=1e-4)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad.cpu(), y.grad, rtol=0, atol=1e-4)


def test_wkv6_launches_follow_the_reference_gate(cuda):
    """Reduced rwkv6-7b on the card: a forward at T 64 launches the
    kernel once a layer, a remat train step twice (forward and
    recompute), a T that is not a multiple of 64 never (the plain chunked
    path, the reference's gate).  Per route: its N 32 at chunk 64 takes
    the tensor cores every time, the CUDA-core kernel never."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("rwkv6-7b").reduced()
    model = build_model(cfg, use_kernel=True, device=cuda, seed=0)
    n = cfg.n_layers
    for T, grad, want in ((64, False, n), (64, True, 2 * n), (96, True, 0)):
        tokens = torch.randint(0, cfg.vocab_size, (2, T), device=cuda)
        before = dict(twkv.LAUNCHES)
        with torch.set_grad_enabled(grad):
            logits, _ = model({"tokens": tokens})
            if grad:
                logits.float().square().mean().backward()
        torch.cuda.synchronize()
        for key in ("wkv6_chunked", "wkv6_chunked_tc"):
            assert twkv.LAUNCHES[key] - before[key] == want, (T, grad, key)
        assert bool(torch.isfinite(logits).all())


def test_wkv6_wrapper_validates_inputs(cuda):
    """It raises on what the kernel does not take; it never gives way to
    the plain version."""
    r = torch.randn(1, 64, 2, 48, device=cuda)
    u = torch.randn(2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim N 48"):
        twkv.wkv6_chunked(r, r, r, -r.abs(), u)
    r = torch.randn(1, 128, 2, 32, device=cuda)
    u = torch.randn(2, 32, device=cuda)
    with pytest.raises(ValueError, match="chunk 128"):
        twkv.wkv6_chunked(r, r, r, -r.abs(), u, chunk=128)
    with pytest.raises(ValueError, match="power of two"):
        twkv.wkv6_chunked(r, r, r, -r.abs(), u, chunk=48)
    with pytest.raises(TypeError, match="share"):
        twkv.wkv6_chunked(r, r.bfloat16(), r, -r.abs(), u)
    with pytest.raises(TypeError, match="share"):
        twkv.wkv6_chunked(*(t.half() for t in (r, r, r, -r.abs(), u)))
    with pytest.raises(ValueError, match="one device"):
        twkv.wkv6_chunked(r, r, r, -r.abs(), u.cpu())


# ---------------------------------------------------------------------------
# serving: prefill through kernel 8, decode over the ring cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_swa_attention_at_prompt_lengths_one_and_five(cuda, S, dtype):
    """A prefill calls kernel 8 at the prompt's own length, down to one
    token: the gates of ``test_swa_attention_kernel_matches_plain``
    (SmolLM's heads, 9 on 3, hd 64, and Gemma-3's hd 320, window 1024)."""
    for H, KV, hd, window in ((9, 3, 64, None), (8, 4, 320, 1024)):
        gen = torch.Generator(device=cuda).manual_seed(S + hd)
        q, k, v = (torch.randn(2, S, n, hd, generator=gen, device=cuda)
                   .to(dtype) for n in (H, KV, KV))
        before = dict(tswa.LAUNCHES)
        got = tswa.swa_attention_fwd(q, k, v, window=window)
        torch.cuda.synchronize()
        assert tswa.LAUNCHES["swa_attention_fwd"] == \
            before["swa_attention_fwd"] + 1
        assert tswa.LAUNCHES["swa_attention_fwd_wgmma"] == \
            before["swa_attention_fwd_wgmma"] + (dtype == torch.bfloat16)
        assert tswa.LAUNCHES["swa_attention_fwd_tf32"] == \
            before["swa_attention_fwd_tf32"] + (dtype == torch.float32)
        want = tref.swa_attention(q, k, v, window=window)
        assert bool(torch.isfinite(got).all())
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_swa_attention_at_prefill_32k(cuda, dtype):
    """prefill_32k's length at SmolLM's heads, batch 1, against the plain
    chunked attention of ``models.attention`` on the same values in fp32
    (the naive version's S x S scores would not fit): 2e-5 in fp32, one
    bf16 step in bf16."""
    from repro_torch.models import attention as tattention
    torch.backends.cuda.matmul.allow_tf32 = False
    S = 32768
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(1, S, n, 64, generator=gen, device=cuda)
               .to(dtype) for n in (9, 3, 3))
    before = dict(tswa.LAUNCHES)
    got = tswa.swa_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert tswa.LAUNCHES["swa_attention_fwd_wgmma"] == \
        before["swa_attention_fwd_wgmma"] + (dtype == torch.bfloat16)
    assert tswa.LAUNCHES["swa_attention_fwd_tf32"] == \
        before["swa_attention_fwd_tf32"] + (dtype == torch.float32)
    with torch.no_grad():
        want = tattention.chunked_attention(q.float(), k.float(), v.float())
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want, rtol=2 ** -7,
                                   atol=1e-5)


def _serve_pair(arch, cuda, **kw):
    """A reduced fp32 model drawn on the CPU, and its copy on the card
    through the kernels."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config(arch).reduced(**kw)
    cpu = transformer.Model(cfg, use_kernel=True)
    card = copy.deepcopy(cpu).to(cuda)
    return cpu, card


def _flat_cache(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat_cache(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _flat_cache(v)]
    return [tree]


@pytest.mark.parametrize("arch,kw", [("smollm-135m", {}),
                                     ("gemma3-4b", {"n_layers": 6}),
                                     ("rwkv6-7b", {})],
                         ids=["smollm", "gemma6", "rwkv"])
def test_reduced_prefill_and_decode_on_cuda_match_cpu(cuda, arch, kw):
    """fp32, TF32 off: prefill of 80 tokens (past gemma's window of 64)
    through kernel 8 on the card, then four decode steps with (B,)
    positions, against the same model on the CPU: logits and the cache
    to 1e-4 of the largest entry."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, card = _serve_pair(arch, cuda, **kw)
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(rs.randint(0, cpu.cfg.vocab_size, (2, 84))
                            .astype(np.int32))
    attn_layers = sum(k != "rwkv" for k in cpu.cfg.layer_pattern) * \
        cpu.n_blocks
    before = dict(tswa.LAUNCHES)
    outs = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        logits, cache = model.prefill({"tokens": toks[:, :80].to(dev)},
                                      cache_len=96)
        seq = [logits]
        for i in range(4):
            pos = torch.tensor([80 + i, 90 + i], device=dev)
            logits, cache = model.decode_step(toks[:, 80 + i:81 + i].to(dev),
                                              cache, pos)
            seq.append(logits)
        outs.append((seq, _flat_cache(cache)))
    torch.cuda.synchronize()
    assert tswa.LAUNCHES["swa_attention_fwd"] == \
        before["swa_attention_fwd"] + attn_layers
    assert tswa.LAUNCHES["swa_attention_fwd_tf32"] == \
        before["swa_attention_fwd_tf32"] + attn_layers
    for a, b in zip(outs[0][0] + outs[0][1], outs[1][0] + outs[1][1]):
        b = b.cpu()
        assert bool(torch.isfinite(b).all())
        tol = 1e-4 * max(float(a.abs().max()), 1e-30)
        torch.testing.assert_close(b, a, rtol=0, atol=tol)


def test_decode_writes_the_cache_in_place_on_cuda(cuda):
    """decode_step writes into the cache tensors it was given (same
    pointers) and allocates nothing near a second cache: the step's peak
    stays under a tenth of the cache's bytes above what was allocated."""
    _, card = _serve_pair("smollm-135m", cuda)
    cache = card.init_cache(8, 8192)
    leaves = _flat_cache(cache)
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves)
    ptrs = [t.data_ptr() for t in leaves]
    tok = torch.zeros((8, 1), dtype=torch.int32, device=cuda)
    card.decode_step(tok, cache, 0)                  # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for pos in (1, 2):
        _, out = card.decode_step(tok, cache, torch.full((8,), pos,
                                                         device=cuda))
    torch.cuda.synchronize()
    assert out is cache
    assert [t.data_ptr() for t in _flat_cache(out)] == ptrs
    assert torch.cuda.max_memory_allocated() - base < cache_bytes / 10
    assert bool(leaves[0][:, :, 2].any()) and not leaves[0][:, :, 3].any()


def test_decode_attention_bf16_on_cuda_matches_fp32_products(cuda):
    """bf16 caches on the card accumulate scores and p.v in fp32
    (``bmm`` with ``out_dtype``); the CPU path upcasts the same bf16
    values; the two agree within one bf16 step of the output."""
    from repro_torch.models import attention as tattention
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, L, KV, G, hd = 4, 4096, 3, 3, 64
    q = torch.randn(B, 1, KV * G, hd, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(B, L, KV, hd, generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    pos = torch.tensor([10, 4095, 5000, 9000], device=cuda)
    for window in (None, 1024):
        got = tattention.decode_attention(q, k, v, pos, window=window)
        want = tattention.decode_attention(q.cpu(), k.cpu(), v.cpu(),
                                           pos.cpu(), window=window)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   rtol=2 ** -7, atol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints and the resilience harness on the card
# ---------------------------------------------------------------------------
def _bf16_state():
    """A harness-shaped state on the host: bf16 parameters beside fp32
    ones, fp32 moments, int32 0-d steps."""
    gen = torch.Generator().manual_seed(0)
    step = torch.tensor(3, dtype=torch.int32)
    return {"opt": {"m": [torch.randn(64, 48, generator=gen)],
                    "step": step.clone()},
            "params": {"w": torch.randn(64, 48, generator=gen).bfloat16(),
                       "norm": torch.randn(48, generator=gen), "tail": []},
            "step": step.clone(), "strat": ()}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_checkpoint_of_a_bf16_state_on_cuda_round_trips(cuda):
    """The blob of the state on the card is the blob of the same state on
    the host, byte for byte, and loads back onto the card bit for bit."""
    from repro_torch import checkpoint
    host = _bf16_state()
    leaves = checkpoint.flatten(host)
    card = checkpoint.unflatten(host, [t.to(cuda) for t in leaves])
    blob = checkpoint.dumps(card)
    assert blob == checkpoint.dumps(host)
    back = checkpoint.loads(blob, like=card)
    for a, b in zip(checkpoint.flatten(back), leaves):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(_bits(a).cpu(), _bits(b))


def test_checkpoint_loads_places_each_leaf_like_its_template(cuda):
    """A leaf goes to its template's device and dtype: the card, the host
    for a meta template, fp32 for an fp32 template of a bf16 leaf."""
    from repro_torch import checkpoint
    host = _bf16_state()
    blob = checkpoint.dumps(host)
    leaves = checkpoint.flatten(host)
    like = checkpoint.unflatten(host, [
        torch.empty(t.shape, dtype=torch.float32 if t.dtype ==
                    torch.bfloat16 else t.dtype, device=dev)
        for t, dev in zip(leaves, [cuda, "meta", cuda, cuda, "meta"])])
    got = checkpoint.flatten(checkpoint.loads(blob, like=like))
    assert [t.device.type for t in got] == ["cuda", "cpu", "cuda", "cuda",
                                            "cpu"]
    assert got[3].dtype == torch.float32 and leaves[3].dtype == torch.bfloat16
    assert torch.equal(got[3].cpu(), leaves[3].float())


def test_two_rank_kill_and_takeover_of_reduced_smollm_on_cuda(cuda):
    """Reduced SmolLM on 2 ranks sharing the card: restore replays the
    baseline bit for bit, takeover leaves one rank, moves the dead
    rank's half of the blob and replays nothing."""
    from repro_torch.launch.resilient_train import run_in_subprocess
    out = run_in_subprocess(n_workers=2, global_batch=4, steps=5,
                            kill_step=3, kill_worker=0, checkpoint_every=2,
                            seq=16, device="cuda", timeout=900)
    runs = out["runs"]
    base, restore, take = runs["baseline"], runs["restore"], runs["takeover"]
    assert restore["bitexact_vs_baseline"] and restore["replay_exact"]
    assert restore["recoveries"][0]["replayed_steps"] == 1
    rec = take["recoveries"][0]
    assert (rec["replayed_steps"], rec["n_workers_after"]) == (0, 1)
    assert rec["bytes_moved"] == base["state_bytes"] // 2
    assert all(np.isfinite(take["losses"])) and len(take["losses"]) == 5
    assert take["losses"][:3] == base["losses"][:3]


# ---------------------------------------------------------------------------
# the expert-parallel MoE on two ranks sharing the card
# ---------------------------------------------------------------------------
_MOE_EP_RANK = """
import dataclasses, sys
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.models import moe
rank, init = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=1)
gen = torch.Generator(device="cuda").manual_seed(0)
with torch.device("cuda"):
    p = moe.moe_init(gen, cfg, torch.bfloat16)
gen = torch.Generator(device="cuda").manual_seed(1 + rank)
x = torch.randn(1, 512, cfg.d_model, generator=gen, device="cuda")
x = x.bfloat16()
y, aux = moe.moe_apply_ep(p, x, cfg)
want, want_aux = moe.moe_apply(p, x, cfg)
torch.cuda.synchronize()
assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
err = float((y.float() - want.float()).abs().max())
step = 2 ** -7 * float(want.float().abs().max())
assert err <= step, (err, step)
assert torch.equal(aux, want_aux)
print("OK", err, step)
dist.destroy_process_group()
"""


def test_moe_apply_ep_on_two_ranks_sharing_the_card(cuda, tmp_path):
    """Mixtral 8x7B's full width (d 4096, f 14336, 8 experts, 4 a rank),
    512 tokens a rank, gloo over the card's tensors: each rank's output
    against ``moe_apply`` on its own tokens within one bf16 step of the
    largest value (the expert products run as (4, 2C, d) batches instead
    of (8, C, d), so a rounding may differ), the aux loss equal."""
    import os
    import subprocess
    import sys
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MOE_EP_RANK, str(r), f"file://{tmp_path}/pg"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        assert out.startswith("OK")


# ---------------------------------------------------------------------------
# sharding: FSDP's collectives over gloo on the card, one FSDP step
# ---------------------------------------------------------------------------
_FSDP_PROBE = """
import sys
import torch
import torch.distributed as dist
from repro_torch import optim
from repro_torch.configs.base import get_config
from repro_torch.core import build_train_step, get_strategy
from repro_torch.core.sharding import gather_dim, scatter_dim
from repro_torch.data import lm_batches, token_stream
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model

rank, init = int(sys.argv[1]), sys.argv[2]
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
x = torch.arange(12., device=dev).reshape(3, 4) + 100 * rank
full = gather_dim(x, 1)
assert full.is_cuda and torch.equal(full.cpu(), torch.cat(
    [torch.arange(12.).reshape(3, 4) + 100 * q for q in range(2)], dim=1))
part = scatter_dim(full.to(torch.bfloat16), 1)
assert part.is_cuda and part.dtype == torch.bfloat16
assert torch.equal(part.float().cpu(), 2 * full[:, 4 * rank:4 * rank + 4]
                   .cpu().to(torch.bfloat16).float())
cfg = get_config("smollm-135m").reduced()
it = lm_batches(token_stream(4 * 64 * 8, cfg.vocab_size), 4, 64)
b = {k: torch.from_numpy(v[2 * rank:2 * rank + 2]).to(dev)
     for k, v in next(it).items()}
losses = []
for fsdp in (False, True):
    model = build_model(cfg, use_kernel=True, device="cpu").to(dev)
    ts = build_train_step(model, optim.adamw(1e-3, use_fused=True),
                          get_strategy("allreduce"),
                          make_mesh((2,), ("data",)), fsdp=fsdp)
    state = ts.init_state()
    state, m = ts.step_fn(state, b)
    state, m = ts.step_fn(state, b)
    losses.append(float(m["loss"]))
    if fsdp:
        assert sum(ts.layout.mask) == 9
assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0]), losses
dist.destroy_process_group()
"""


def test_fsdp_collectives_and_step_on_cuda(cuda, tmp_path):
    """Two gloo ranks on one card: FSDP's all-gather
    (``all_gather_into_tensor``) and reduce-scatter
    (``reduce_scatter_tensor``, bf16) on CUDA tensors, and two steps of
    reduced SmolLM (fp32, kernels 8 and 3) under FSDP against the same
    steps replicated, losses to 1e-5."""
    import os
    import subprocess
    import sys
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FSDP_PROBE, str(r), f"file://{tmp_path}/pg"],
        stderr=subprocess.PIPE, text=True, env=env) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
