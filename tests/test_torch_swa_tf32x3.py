"""The arithmetic of the fp32 attention kernel
(``src/repro_torch/kernels/csrc/swa_attention_tf32.cu``), emulated in
PyTorch on the CPU and held to the gate the kernel meets on the card: 2e-5
absolute against the fp32 plain version and against the Pallas kernel (in
interpret mode) on the same fp32 inputs.

The kernel takes Q.K^T and P.V on the tensor cores as TF32 ``mma.sync``
products with fp32 accumulation.  A TF32 product reads an fp32 operand
with its 13 low mantissa bits dropped, so each operand x is split as hi =
x truncated to TF32 and lo = x - hi (exact in fp32, truncated again by the
mma), and each product is taken as lo.hi + hi.lo + hi.hi (lo.lo
dropped).  The softmax is fp32 and online over kv tiles of 64 keys at
hd <= 64, 32 at 96 and 128, 16 at 160 and 256 and 32 at 320
(``kv_tile``): masked scores at -1e30 after the scale, exp as
exp2((x - m) log2 e).  P goes from the score accumulators into P.V
unrounded (only the mma's own split and truncation touch it).  At hd 320
two warps share each row, each taking Q.K^T over half of hd (its own
hi.hi and small products added in fp32) before the two halves are added
in fp32 (``qk_parts``).

The mma also truncates each sum it forms (toward zero).  The kernel keeps
hi.hi and the small products in accumulators of their own, added in
fp32, and takes each kv tile's P.V from zero and adds it to O in fp32;
``test_truncated_sums_meet_the_gate`` models the truncation (each mma's
sum exact, then rounded toward zero) and holds that layout to the gate,
recording beside it the layout that carries everything through the mma.

One TF32 product instead (hi.hi alone, ``emulate(..., split=False)``)
misses the gate: at SmolLM's heads (B 2, S 512, 9/3 heads, hd 64, causal,
the inputs of ``test_tf32x3_meets_the_gate``) 522,185 of 589,824 outputs
fall outside it, the largest error 2.43e-3, where the three products land
1.55e-6 away at most (``test_one_tf32_product_misses_the_gate`` records
both, and asserts neither).  That is why the kernel takes three products.
"""
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import swa_attention as jswa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import swa_attention as tswa  # noqa: E402

LOG2E = 1.4426950408889634
F32_ATOL = 2e-5      # chip_smoke.SWA_F32_ATOL and the card tests' gate


def kv_tile(hd):
    """Keys of the kernel's kv tile at head_dim ``hd`` (``tile_keys``)."""
    return 64 if hd <= 64 else 32 if hd <= 128 else 16 if hd <= 256 else 32


def qk_parts(hd):
    """Warps that share a row at head_dim ``hd`` (``col_split``), each
    taking Q.K^T over its own equal range of hd."""
    return 1 if hd <= 256 else 2


def mm(a, b, split=True, parts=1):
    """a @ b as the kernel's ``mma3`` forms it: both fp32 operands split by
    ``ref.tf32_split``, lo truncated to TF32 by the mma, lo.hi + hi.lo +
    hi.hi in fp32; ``split=False``: hi.hi alone, one TF32 product.
    ``parts``: over that many equal ranges of the inner dim apart, the
    results added in fp32 (the warp pair's halves of hd)."""
    if parts > 1:
        w = a.shape[-1] // parts
        return sum(mm(a[..., i * w:(i + 1) * w], b[..., i * w:(i + 1) * w, :],
                      split) for i in range(parts))
    (ah, al), (bh, bl) = tref.tf32_split(a), tref.tf32_split(b)
    if not split:
        return ah @ bh
    al, bl = tref.tf32_trunc(al), tref.tf32_trunc(bl)
    return (al @ bh + ah @ bl) + ah @ bh


def emulate(q, k, v, *, window=None, causal=True, split=True):
    """The kernel's forward on the CPU: q (B, S, H, hd), k and v (B, S, KV,
    hd) fp32 -> (B, S, H, hd) fp32."""
    B, S, H, hd = q.shape
    tile = kv_tile(hd)
    G = H // k.shape[2]
    qf = q.transpose(1, 2)
    kf = k.transpose(1, 2).repeat_interleave(G, 1)
    vf = v.transpose(1, 2).repeat_interleave(G, 1)
    pad = -S % tile                    # cp.async writes zeros past S
    kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    masked = torch.tensor(-1e30)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros(B, H, S, 1)
    o = torch.zeros(B, H, S, hd)
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S + pad, tile):
        key = torch.arange(k0, k0 + tile)[None, :]
        ok = key < S
        if causal:
            ok = ok & (key <= qpos)
        if window is not None:
            ok = ok & (key > qpos - window)
        x = torch.where(ok, mm(qf, kf[:, :, k0:k0 + tile].transpose(-1, -2),
                               split, qk_parts(hd)) * scale, masked)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((x - m_new) * LOG2E)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + mm(p, vf[:, :, k0:k0 + tile], split)
        m = m_new
    out = o / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).contiguous()


def _qkv(B, S, H, KV, hd, seed=0):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(B, S, n, hd).astype(np.float32))
            for n in (H, KV, KV)]


def _pallas(q, k, v, window, **blocks):
    out = jswa.swa_attention_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                 window=window, interpret=True, **blocks)
    return torch.from_numpy(np.array(out, np.float32))


def _errors(got, want):
    diff = (got - want).abs()
    return int((diff > F32_ATOL).sum()), float(diff.max())


# (B, S, H, KV, hd, window, causal): SmolLM's heads, a window smaller than
# a tile, a ragged S, hd 32 in a full (non-causal) call, Phi-3's 96 and
# Qwen1.5's 128, 16 heads on one kv head; then the wide head_dims on
# reduced heads: pixtral-12b's 160 (8 on 2), recurrentgemma-2b's 256 (4 on
# 1, a window; and a full call), Gemma-3's 320 (8 on 4, causal, and its
# local window over a ragged S)
CASES = [
    (2, 512, 9, 3, 64, None, True),
    (2, 512, 9, 3, 64, 100, True),
    (2, 300, 9, 3, 64, None, True),
    (2, 200, 4, 2, 32, None, False),
    (1, 256, 8, 8, 96, None, True),
    (1, 256, 8, 4, 128, 64, True),
    (1, 256, 16, 1, 64, 100, True),
    (1, 256, 8, 2, 160, None, True),
    (1, 256, 4, 1, 256, 64, True),
    (2, 100, 4, 2, 256, None, False),
    (1, 256, 8, 4, 320, None, True),
    (1, 300, 8, 4, 320, 100, True),
]


@pytest.mark.parametrize("B,S,H,KV,hd,window,causal", CASES)
def test_tf32x3_meets_the_gate(B, S, H, KV, hd, window, causal):
    """Every output of the emulated kernel lies within 2e-5 of the fp32
    plain version, ``ref.swa_attention``."""
    q, k, v = _qkv(B, S, H, KV, hd)
    got = emulate(q, k, v, window=window, causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    bad, worst = _errors(got, tref.swa_attention(q, k, v, window=window,
                                                 causal=causal))
    assert bad == 0, f"{bad} outside {F32_ATOL}, largest error {worst:.3e}"


@pytest.mark.parametrize("hd,H,KV,window", [(64, 9, 3, None),
                                             (64, 9, 3, 100),
                                             (160, 8, 2, None),
                                             (256, 4, 1, 64),
                                             (320, 8, 4, None),
                                             (320, 8, 4, 64)])
def test_tf32x3_meets_the_gate_against_pallas(hd, H, KV, window):
    """The same against the JAX Pallas kernel itself (interpret mode, its
    own tiles of 64) on the same fp32 inputs, at SmolLM's heads and the
    wide head_dims."""
    q, k, v = _qkv(1, 192, H, KV, hd, seed=hd + H)
    got = emulate(q, k, v, window=window)
    bad, worst = _errors(got, _pallas(q, k, v, window, q_block=64,
                                      kv_block=64))
    assert bad == 0, f"{bad} outside {F32_ATOL}, largest error {worst:.3e}"


def test_one_tf32_product_misses_the_gate():
    """Records, without asserting, how far one TF32 product (hi.hi) and the
    three products land from the fp32 plain version at SmolLM's heads: the
    count and largest error the module docstring cites."""
    q, k, v = _qkv(2, 512, 9, 3, 64)
    want = tref.swa_attention(q, k, v)
    one = _errors(emulate(q, k, v, split=False), want)
    three = _errors(emulate(q, k, v), want)
    print(f"one TF32 product: {one[0]} of {want.numel()} outside "
          f"{F32_ATOL}, largest {one[1]:.3e}; three: {three[0]}, largest "
          f"{three[1]:.3e}")


def _mma_rz(c, a, b):
    """One mma's sum as modelled: exact (float64), then rounded toward
    zero to fp32."""
    exact = c.double() + a.double() @ b.double()
    r = exact.float()
    over = r.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _mm_rz(a, b, c=None, apart=True, parts=1):
    """a @ b in 3xTF32 over k steps of 8 with truncated sums: hi.hi and
    the small products in two accumulators added in fp32 (``apart``, the
    kernel), or all three into ``c``.  ``parts`` (apart only): each of that
    many equal ranges of the inner dim summed so, the results added in
    fp32."""
    if parts > 1:
        w = a.shape[-1] // parts
        return sum(_mm_rz(a[..., i * w:(i + 1) * w],
                          b[..., i * w:(i + 1) * w, :])
                   for i in range(parts))
    (ah, al), (bh, bl) = tref.tf32_split(a), tref.tf32_split(b)
    al, bl = tref.tf32_trunc(al), tref.tf32_trunc(bl)
    hi = torch.zeros(a.shape[:-1] + b.shape[-1:]) if c is None or apart \
        else c
    lo = torch.zeros_like(hi) if apart else hi
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        lo = _mma_rz(lo, al[..., ks], bh[..., ks, :])
        lo = _mma_rz(lo, ah[..., ks], bl[..., ks, :])
        if not apart:
            hi = lo
        hi = _mma_rz(hi, ah[..., ks], bh[..., ks, :])
        if not apart:
            lo = hi
    return hi + lo if apart else hi


def _emulate_rz(q, k, v, apart):
    """The kernel's forward with truncated mma sums (causal, one batch
    entry, KV = H): ``apart`` as the kernel, else S's three products in
    one accumulator and O carried through the mma from tile to tile."""
    H, S, hd = q.shape
    tile = kv_tile(hd)
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    m = torch.full((H, S, 1), -1e30)
    l = torch.zeros(H, S, 1)
    o = torch.zeros(H, S, hd)
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        kt, vt = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        key = torch.arange(k0, k0 + tile)[None, :]
        x = torch.where(key <= qpos, _mm_rz(
            q, kt.transpose(1, 2), apart=apart,
            parts=qk_parts(hd) if apart else 1) * scale, torch.tensor(-1e30))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((x - m_new) * LOG2E)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + _mm_rz(p, vt) if apart else \
            _mm_rz(p, vt, o * corr, apart=False)
        m = m_new
    return o / l


@pytest.mark.parametrize("hd,S", [(64, 512), (320, 256)])
def test_truncated_sums_meet_the_gate(hd, S):
    """With every mma sum rounded toward zero, the kernel's layout (hi.hi
    apart from the small products, each tile's P.V from zero) lies within
    the gate of the fp32 plain version; the layout that runs everything
    through the mma is recorded beside it, not asserted."""
    rs = np.random.RandomState(hd)
    q, k, v = (torch.from_numpy(rs.randn(2, S, hd).astype(np.float32))
               for _ in range(3))
    want = tref.swa_attention(*(t.transpose(0, 1)[None] for t in (q, k, v)))
    want = want[0].transpose(0, 1)
    bad, worst = _errors(_emulate_rz(q, k, v, apart=True), want)
    _, through = _errors(_emulate_rz(q, k, v, apart=False), want)
    print(f"hd {hd}: truncated sums, the kernel's layout {worst:.3e}, "
          f"all through the mma {through:.3e}")
    assert bad == 0, f"{bad} outside {F32_ATOL}, largest error {worst:.3e}"


def _kernel_table(fn):
    """{hd: value} at every head_dim of the wrapper of the kernel's
    ``constexpr`` function ``fn``, read from its source: a chain
    ``HD <= a ? x : HD <= b ? y : z``."""
    src = (Path(tswa.__file__).with_name("csrc")
           / "swa_attention_tf32.cu").read_text()
    body = re.search(fn + r"\(\) \{\s*return ([^;]*);", src).group(1)
    steps = [(int(a), int(x))
             for a, x in re.findall(r"HD <= (\d+) \? (\d+) :", body)]
    last = int(body.rsplit(":", 1)[1])
    return {hd: next((x for a, x in steps if hd <= a), last)
            for hd in tswa.HEAD_DIMS}


def test_tiles_follow_the_kernel():
    """The emulation's kv tiles and Q.K^T parts are the kernel's
    (``tile_keys``: 64 keys at hd <= 64, 32 at 96 and 128, 16 at 160 and
    256, 32 at 320; ``col_split``: two warps a row at 320) at every
    head_dim the wrapper takes, as its source states them, and the TF32
    split is exact: hi keeps 10 mantissa bits, hi + lo is x."""
    assert [kv_tile(hd) for hd in tswa.HEAD_DIMS] == \
        [64, 64, 32, 32, 16, 16, 32]
    assert _kernel_table("tile_keys") == {hd: kv_tile(hd)
                                          for hd in tswa.HEAD_DIMS}
    assert _kernel_table("col_split") == {hd: qk_parts(hd)
                                          for hd in tswa.HEAD_DIMS}
    rs = np.random.RandomState(3)
    x = torch.from_numpy(np.concatenate([
        rs.randn(100_000) * 10.0 ** rs.randint(-30, 30, 100_000),
        [0.0, 1.0, -2 ** -126]]).astype(np.float32))
    hi, lo = tref.tf32_split(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert torch.equal(hi + lo, x)
    assert bool((lo.abs() <= 2 ** -10 * x.abs()).all())
