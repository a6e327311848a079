"""The port's Hopper kernels against their plain twins on an NVIDIA GPU.

Marked ``cuda``: without a GPU every test skips (the CUDA kernels have no
CPU mode).  Imports torch and numpy only, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

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
dist.destroy_process_group()
"""


def test_gloo_collectives_take_cuda_tensors(cuda, tmp_path):
    """Two gloo ranks on one card: NCCL refuses two ranks on the same GPU,
    so the byzantine trainer's ranks share a card over gloo.  Gloo runs
    every collective the port uses on CUDA tensors, so the port stages
    none through host memory itself."""
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
