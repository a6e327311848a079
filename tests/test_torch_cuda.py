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
