"""The arithmetic of the tensor-core WKV kernel (``csrc/wkv6_tc.cu``) on
the CPU: its plain twin ``ref.wkv6_subchunked`` (the two-level
intra-chunk form, with the 3xTF32 rounding of every product's operands)
against the chunked twin ``ref.wkv6_chunked``, the exact recurrence
``ref.wkv6`` and, at mild decay, the reference's Pallas kernel in
interpret mode and its oracle.  The kernel itself is held against these
on a GPU in ``test_torch_cuda.py``; here the wrapper ``wkv6.wkv6_chunked``
takes its CPU path, the chunked twin."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import wkv6  # noqa: E402

# (B, T, H, N, chunk, dtype, mu), logw = -exp(N(mu, 0.5)): the reference
# test's cases and the strong decays of tests/test_torch_rwkv.py (mu 3:
# per-step decays down to exp(-e^4.5), where the Pallas body overflows)
WKV_CASES = [
    (2, 64, 2, 32, 16, "float32", -2.0),
    (1, 128, 4, 64, 64, "float32", -2.0),
    (2, 96, 3, 16, 32, "float32", -2.0),
    (1, 64, 2, 32, 16, "bfloat16", -2.0),
]
STRONG_CASES = [(1, 64, 2, 32, 64, "float32", 1.5),
                (2, 128, 2, 16, 64, "float32", 3.0)]
# the main path's N 64 and chunk 64, from mild to strong decay
MAIN_CASES = [(2, 256, 2, 64, 64, "float32", mu)
              for mu in (-2.0, 0.0, 1.5, 3.0)]


def _inputs(B, T, H, N, dtype, mu, seed=0):
    """The same numpy draws for both packages, rounded once by torch."""
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(B, T, H, N) * 0.5 for _ in range(3)]
    arrs.append(-np.exp(rs.randn(B, T, H, N) * 0.5 + mu))
    arrs.append(rs.randn(H, N) * 0.5)
    ts = [torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
          for a in arrs]
    js = [jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype))
          for t in ts]
    return ts, js


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _tol(dtype):
    # fp32: the reference test's 1e-4; bf16: its 5e-2 (each side rounds
    # its fp32 result to bf16 once)
    return 5e-2 if dtype == "bfloat16" else 1e-4


@pytest.mark.parametrize("tf32x3", [True, False], ids=["3xtf32", "fp32"])
@pytest.mark.parametrize("B,T,H,N,chunk,dtype,mu",
                         WKV_CASES + STRONG_CASES + MAIN_CASES)
def test_subchunked_matches_chunked_and_exact(B, T, H, N, chunk, dtype, mu,
                                              tf32x3):
    """The two-level form, with and without the 3xTF32 operand rounding,
    against the chunked twin and the exact recurrence: finite at every
    decay (every exponent it takes is <= 0) and within 1e-4 in fp32."""
    (r, k, v, lw, u), _ = _inputs(B, T, H, N, dtype, mu, seed=T + N)
    got = tref.wkv6_subchunked(r, k, v, lw, u, chunk=chunk, tf32x3=tf32x3)
    assert got.dtype == r.dtype and got.shape == r.shape
    assert bool(torch.isfinite(got).all())
    for want in (tref.wkv6_chunked(r, k, v, lw, u, chunk=chunk),
                 tref.wkv6(r, k, v, lw, u)):
        np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype))


@pytest.mark.parametrize("B,T,H,N,chunk,dtype,mu",
                         WKV_CASES + [(1, 256, 4, 64, 64, "float32", -2.0)])
def test_subchunked_matches_pallas_and_oracle(B, T, H, N, chunk, dtype, mu):
    """The 3xTF32 two-level twin against the reference's Pallas kernel in
    interpret mode and its oracle, at the reference test's mild decay
    (mu -2) only: the Pallas body exponentiates before it masks, and a
    chunk of 64 overflows already at mu 0 (NaN), as it does at mu 3
    (``test_torch_rwkv.py`` records that)."""
    (r, k, v, lw, u), js = _inputs(B, T, H, N, dtype, mu)
    got = tref.wkv6_subchunked(r, k, v, lw, u, chunk=chunk)
    for theirs in (jops.wkv6(*js, chunk=chunk), jref.wkv6(*js)):
        np.testing.assert_allclose(_np(got), _np(theirs), atol=_tol(dtype))


@pytest.mark.parametrize("sub", [4, 8, 32])
def test_subchunked_is_one_function_at_any_cut(sub):
    """The form does not depend on where the chunk is cut: sub-chunks of
    4, 8 and 32 (the kernel takes 16) give the exact recurrence under
    strong decay too, so no term is counted twice or left out."""
    (r, k, v, lw, u), _ = _inputs(2, 128, 2, 32, "float32", 1.5, seed=5)
    got = tref.wkv6_subchunked(r, k, v, lw, u, chunk=64, sub=sub)
    np.testing.assert_allclose(_np(got), _np(tref.wkv6(r, k, v, lw, u)),
                               atol=1e-4)


def test_one_tf32_rounding_breaks_the_fp32_gate():
    """Why the kernel splits its operands: with each product's operands
    taken to TF32 once (about 11 bits, as an mma reads an fp32 register),
    most outputs of the main path's shape miss the exact recurrence by
    more than 1e-4; the 3xTF32 split (hi.hi + hi.lo + lo.hi) stays within
    it."""
    (r, k, v, lw, u), _ = _inputs(1, 256, 4, 64, "float32", -2.0, seed=1)
    exact = tref.wkv6(r, k, v, lw, u)
    three = tref.wkv6_subchunked(r, k, v, lw, u)
    split = tref._mm_tf32x3
    try:
        tref._mm_tf32x3 = lambda a, b: tref.tf32_trunc(a) @ tref.tf32_trunc(b)
        once = tref.wkv6_subchunked(r, k, v, lw, u)
    finally:
        tref._mm_tf32x3 = split
    assert float((three - exact).abs().max()) <= 1e-4
    assert float(((once - exact).abs() > 1e-4).float().mean()) > 0.5


def test_tf32_trunc_keeps_the_top_19_bits():
    """``tf32_trunc`` (what an mma reads of an fp32 register) clears the
    13 low mantissa bits, keeps TF32 values as they are, and takes less
    than one TF32 step (2^-10 of x) off the magnitude."""
    y = torch.from_numpy(np.random.RandomState(1).randn(4096)
                         .astype(np.float32))
    t = tref.tf32_trunc(y)
    assert torch.equal(t.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(t, dtype=torch.int32))
    assert torch.equal(tref.tf32_trunc(t), t)
    assert bool(((y - t).abs() < y.abs() * 2.0 ** -10).all())
    assert bool((t.abs() <= y.abs()).all())
    x = torch.tensor([1 + 2.0 ** -11 + 2.0 ** -12, -(1 + 2.0 ** -11)])
    assert torch.equal(tref.tf32_trunc(x), torch.tensor([1.0, -1.0]))


def test_tf32_split_keeps_the_top_of_the_range_finite():
    """``tf32_split`` gives hi = x truncated to TF32 and lo = x - hi exact,
    so hi + lo is x and both are finite for every finite x, also within
    half a TF32 step of fp32's largest value, where a hi rounded to the
    nearest TF32 would be inf and lo = x - inf; lo stays under one TF32
    step of x, and what the mma reads of it, within 2^-20 of x.  An
    infinite or NaN x gives a non-finite sum."""
    fmax = torch.finfo(torch.float32).max
    y = torch.from_numpy(np.random.RandomState(2).randn(4096)
                         .astype(np.float32))
    top = torch.tensor([fmax, -fmax, 3.4025e38, -3.4026e38],
                       dtype=torch.float32)
    for x in (y, top):
        hi, lo = tref.tf32_split(x)
        assert torch.equal(hi, tref.tf32_trunc(x))
        assert bool(torch.isfinite(hi).all() & torch.isfinite(lo).all())
        assert torch.equal(hi + lo, x)
        assert bool((lo.abs() < x.abs() * 2.0 ** -10).all())
        rest = x.double() - hi.double() - tref.tf32_trunc(lo).double()
        assert bool((rest.abs() < x.double().abs() * 2.0 ** -20).all())
    for x in (float("inf"), -float("inf"), float("nan")):
        hi, lo = tref.tf32_split(torch.tensor([x]))
        assert not bool(torch.isfinite(hi + lo).any())


def _extreme_inputs(case, N, seed):
    """The card test's extreme inputs (``test_torch_cuda.py``): r, k, v
    scaled by 2^36; or one of them with entries at fp32's largest value
    in the first and last rows of sub-chunks of 16 (where the kernel's
    operands are r and k themselves), the others and u scaled by 2^-8; or
    per-step decays near exp(-1e30).
    Returns the inputs and the scale of the output against unit inputs."""
    (r, k, v, lw, u), _ = _inputs(1, 128, 2, N, "float32", -2.0, seed=seed)
    if case == "large":
        return [t * 2.0 ** 36 for t in (r, k, v)] + [lw, u], 2.0 ** 108
    if case == "steep_decay":
        lw = _inputs(1, 128, 2, N, "float32", 69.0, seed=1)[0][3]
        return [r, k, v, lw, u], 1.0
    ins = {"r": r, "k": k, "v": v}
    for name in ins:
        if name != case[-1]:
            ins[name] = ins[name] * 2.0 ** -8
    big = ins[case[-1]]
    for t0 in (15, 16):         # the last and first rows of sub-chunks
        big[0, t0::16, :, ::7] = torch.finfo(torch.float32).max * torch.sign(
            big[0, t0::16, :, ::7])
    return [ins["r"], ins["k"], ins["v"], lw, u * 2.0 ** -8], 2.0 ** 112


@pytest.mark.parametrize("case", ["large", "top_r", "top_k", "top_v",
                                  "steep_decay"])
def test_subchunked_at_extreme_inputs(case):
    """The 3xTF32 two-level twin at the card test's extreme inputs: finite
    and within the fp32 gate, scaled as the output scales, of the chunked
    twin and the exact recurrence.  With operands at fp32's largest value
    a round-to-nearest split would carry hi into inf and give NaN."""
    ins, scale = _extreme_inputs(case, 64, seed=3)
    got = tref.wkv6_subchunked(*ins, chunk=64)
    assert bool(torch.isfinite(got).all())
    for want in (tref.wkv6_chunked(*ins, chunk=64), tref.wkv6(*ins)):
        assert bool(torch.isfinite(want).all())
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=1e-4 * scale)


def test_wrapper_on_cpu_is_the_chunked_twin():
    """On a CPU tensor the wrapper returns the chunked twin and launches
    nothing, also at the shapes the card sends to the tensor cores; the
    two-level twin agrees with it there."""
    (r, k, v, lw, u), _ = _inputs(1, 128, 2, 64, "float32", 0.0, seed=2)
    assert 64 in wkv6.TC_HEAD_DIMS and 64 in wkv6.TC_CHUNKS
    before = dict(wkv6.LAUNCHES)
    got = wkv6.wkv6_chunked(r, k, v, lw, u, chunk=64)
    assert wkv6.LAUNCHES == before
    assert torch.equal(got, tref.wkv6_chunked(r, k, v, lw, u, chunk=64))
    np.testing.assert_allclose(
        _np(got), _np(tref.wkv6_subchunked(r, k, v, lw, u, chunk=64)),
        atol=1e-4)
