"""The port's MLLess kernels on the CPU: plain twins against the JAX
oracles and the Pallas kernels (interpret mode), and the wrappers'
dispatch.  The Hopper kernels themselves are held against these twins on
a GPU in ``test_torch_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import block_significance as jbs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import block_significance as tbs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]
SHAPES = [(1, 256), (257, 256), (300, 128), (5, 7)]


def _blocks(n, b, tdtype, seed=0):
    """Same values in both packages (bf16 rounded once, by torch)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, b).astype(np.float32) * rs.lognormal(size=(n, 1))
    t = torch.from_numpy(x.astype(np.float32)).to(tdtype)
    return t, jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if tdtype == torch.bfloat16 else jnp.float32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_norms_twin_matches_oracle_and_pallas(n, b, dtype):
    """fp32 sums of the same squares in other orders: 1e-5 relative."""
    t, j = _blocks(n, b, dtype)
    got = tref.block_norms(t)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(_np(got), _np(jref.block_norms(j)),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(got), _np(jbs.block_norms(
        j, interpret=True)), rtol=1e-5)
    np.testing.assert_array_equal(_np(tbs.block_norms(t)), _np(got))


@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_filter_twin_is_exact(n, b, dtype):
    """A 0/1 multiply and a subtraction in fp32, rounded once to the
    input dtype: bit-exact against the oracle and the Pallas kernel."""
    t, j = _blocks(n, b, dtype, seed=1)
    mask = np.random.RandomState(2).rand(n) > 0.4
    kept, resid = tref.masked_filter(t, torch.from_numpy(mask))
    assert kept.dtype == resid.dtype == dtype
    for want in (jref.masked_filter(j, jnp.asarray(mask)),
                 jbs.masked_filter(j, jnp.asarray(mask), interpret=True)):
        np.testing.assert_array_equal(_np(kept), _np(want[0]))
        np.testing.assert_array_equal(_np(resid), _np(want[1]))
    k2, r2 = tbs.masked_filter(t, torch.from_numpy(mask))
    np.testing.assert_array_equal(_np(k2), _np(kept))
    np.testing.assert_array_equal(_np(r2), _np(resid))


@pytest.mark.parametrize("threshold", [0.5, 1.0])
def test_significance_twins_match_oracle(threshold):
    """The mask is a comparison of fp32 norms that agree to 1e-5; the data
    keeps every block 1e-4 away from the threshold, so the masks agree
    exactly, and then the filter does too."""
    t, j = _blocks(300, 256, torch.float32, seed=3)
    sq = tref.block_norms(t).double()
    margin = (sq.sqrt() / (threshold * (sq.mean() + 1e-20).sqrt()) - 1).abs()
    assert float(margin.min()) > 1e-4
    mask = tref.block_significance(t, threshold)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jref.block_significance(j, threshold)))
    kept, resid, m2 = tref.significance_filter(t, threshold)
    jk, jr, jm = jref.significance_filter(j, threshold)
    np.testing.assert_array_equal(m2.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(resid.numpy(), np.asarray(jr))
    assert 0 < int(mask.sum()) < mask.numel()


def test_ops_take_the_twins_on_cpu_without_launching():
    t, _ = _blocks(64, 256, torch.float32, seed=4)
    before = dict(tbs.LAUNCHES)
    np.testing.assert_array_equal(tops.block_significance(t, 0.5).numpy(),
                                  tref.block_significance(t, 0.5).numpy())
    for a, b in zip(tops.significance_filter(t, 0.5),
                    tref.significance_filter(t, 0.5)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tbs.LAUNCHES == before


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((4, 256), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tbs.block_norms(x)
    with pytest.raises(ValueError, match="unsupported device"):
        tbs.masked_filter(x, torch.empty(4, dtype=torch.bool, device="meta"))
