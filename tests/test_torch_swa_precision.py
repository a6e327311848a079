"""The arithmetic of the tensor-core attention kernel
(``src/repro_torch/kernels/csrc/swa_attention_tc.cu``), emulated in PyTorch
on the CPU and held to the gate the kernel meets on the card: one bf16
step (2^-7 relative + 1e-5) against the fp32 plain version.

The kernel takes Q.K^T from bf16 operands with fp32 accumulation, runs an
fp32 online softmax over kv tiles of 128 keys at hd <= 64, 64 at hd 96 to
160 and 32 at hd 256 and 320 (``kv_tile``; log2 domain, masked scores at
-1e30 after the scale), splits P into hi = bf16(P) and lo = bf16(P - hi),
both rounded to nearest by an integer add on the fp32 bit pattern, and
takes P.V as P_hi.V + P_lo.V in fp32.  Above hd 128 it takes P.V in
products of 128 and 64 columns of O (``pv_columns``); each column still
sums the same keys in the same order, and the emulation takes the
products column block by column block as the kernel does.  Rounding P once
to bf16 instead, as FlashAttention does, breaks the gate: at SmolLM's
heads (B 2, S 512, 9/3 heads, hd 64, causal, the inputs of
``test_split_p_meets_the_gate``) 61,193 of 589,824 outputs fall outside
it, the largest error 1.56e-2 (``emulate(..., split=False)``).  That
count is why the kernel splits P; it is recorded here, not asserted.
"""
import math

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import swa_attention as jswa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

LOG2E = 1.4426950408889634
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-5


def _bf16_nearest(x):
    """The kernel's ``round_pair``: bf16(x) rounded to nearest, ties away
    from zero (add 0x8000 to the fp32 bits, keep the top 16)."""
    return ((x.view(torch.int32) + 0x8000) & -65536).view(torch.float32)


def kv_tile(hd):
    """Keys of the kernel's kv tile at head_dim ``hd`` (``Tile::kBK``)."""
    return 128 if hd <= 64 else 64 if hd <= 160 else 32


def pv_columns(hd):
    """The column blocks of O that the kernel's P.V products take: all of
    hd padded to 64 at hd <= 128, else 128-column blocks and a last one
    of 64 (``issue_pv``)."""
    padded = -(-hd // 64) * 64
    if padded <= 128:
        return [(0, padded)]
    return [(c, min(c + 128, padded)) for c in range(0, padded, 128)]


def emulate(q, k, v, *, window=None, causal=True, split=True):
    """The kernel's forward on the CPU: q (B, S, H, hd), k and v (B, S, KV,
    hd) bf16 -> (B, S, H, hd) bf16.  ``split=False`` rounds P once to bf16
    instead (the arithmetic the kernel does not use)."""
    B, S, H, hd = q.shape
    tile = kv_tile(hd)                 # keys of a kv tile, as the kernel
    G = H // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(G, 1)
    vf = v.float().transpose(1, 2).repeat_interleave(G, 1)
    pad = -S % tile                    # TMA reads zeros past S
    kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) * \
        torch.tensor(LOG2E, dtype=torch.float32)
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
        x = torch.where(ok, (qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2))
                        * scale, masked)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = _bf16_nearest(p)
        lo = _bf16_nearest(p - hi)
        pv = torch.cat([                  # O's column blocks, as issued
            hi @ vf[:, :, k0:k0 + tile, c0:c1]
            + (lo @ vf[:, :, k0:k0 + tile, c0:c1] if split else 0.0)
            for c0, c1 in pv_columns(hd)], dim=-1)[..., :hd]
        o = o * corr + pv
        m = m_new
    out = o * (1.0 / torch.clamp(l, min=1e-30))
    return out.transpose(1, 2).to(q.dtype)


def _qkv(B, S, H, KV, hd, seed=0):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(B, S, n, hd).astype(np.float32))
            .bfloat16() for n in (H, KV, KV)]


def _assert_within_one_bf16_step(got, want):
    got, want = got.float(), want.float()
    bad = (got - want).abs() > BF16_ATOL + BF16_RTOL * want.abs()
    assert bool(torch.isfinite(got).all())
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} outside one bf16 step, largest "
        f"error {float((got - want).abs().max()):.3e}")


# (B, S, H, KV, hd, window, causal): SmolLM's heads, a window smaller than
# a tile, a ragged S, hd 128, a full (non-causal) call, one kv head for 16;
# then the wide head_dims on reduced heads: Gemma-3's 320 (8 on 4, causal,
# and its local window over a ragged S), pixtral-12b's 160 (8 on 2),
# recurrentgemma-2b's 256 (4 on 1, a window; and a full call)
PRECISION_CASES = [
    (2, 512, 9, 3, 64, None, True),
    (2, 512, 9, 3, 64, 128, True),
    (2, 300, 9, 3, 64, None, True),
    (1, 512, 8, 4, 128, None, True),
    (2, 300, 4, 2, 64, None, False),
    (1, 256, 16, 1, 64, 100, True),
    (1, 256, 8, 4, 320, None, True),
    (1, 300, 8, 4, 320, 100, True),
    (1, 256, 8, 2, 160, None, True),
    (1, 256, 4, 1, 256, 64, True),
    (2, 100, 4, 2, 256, None, False),
]


@pytest.mark.parametrize("B,S,H,KV,hd,window,causal", PRECISION_CASES)
def test_split_p_meets_the_gate(B, S, H, KV, hd, window, causal):
    """Every output of the emulated kernel lies within one bf16 step of
    the fp32 plain version, ``ref.swa_attention``."""
    q, k, v = _qkv(B, S, H, KV, hd)
    got = emulate(q, k, v, window=window, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_within_one_bf16_step(
        got, tref.swa_attention(q, k, v, window=window, causal=causal))


@pytest.mark.parametrize("S,window", [(256, None), (512, None), (512, 128)])
def test_split_p_meets_the_gate_against_pallas(S, window):
    """The same against the JAX Pallas kernel itself (interpret mode) on
    the same bf16 inputs: it computes in fp32 and rounds its output to
    bf16 once."""
    q, k, v = _qkv(1, S, 9, 3, 64, seed=S)
    want = jswa.swa_attention_fwd(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)), window=window, interpret=True)
    got = emulate(q, k, v, window=window)
    _assert_within_one_bf16_step(
        got, torch.from_numpy(np.asarray(want, np.float32)))


@pytest.mark.parametrize("hd,H,KV,window", [(320, 8, 4, None),
                                             (320, 8, 4, 64),
                                             (256, 4, 1, None),
                                             (160, 8, 2, None)])
def test_wide_head_dims_meet_the_gate_against_pallas(hd, H, KV, window):
    """At the wide head_dims (reduced heads, S 192: six of the kernel's
    32-key tiles at hd 256 and 320) the emulated kernel lies within one
    bf16 step of the Pallas kernel in interpret mode on the same bf16
    inputs."""
    q, k, v = _qkv(1, 192, H, KV, hd, seed=hd + H)
    want = jswa.swa_attention_fwd(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)), window=window, q_block=64, kv_block=64,
        interpret=True)
    got = emulate(q, k, v, window=window)
    _assert_within_one_bf16_step(
        got, torch.from_numpy(np.asarray(want, np.float32)))


def test_tiles_and_column_blocks_follow_the_kernel():
    """The kv tiles and O's column blocks of the kernel's table (Tile in
    ``swa_attention_tc.cu``): every padded column of hd in one block, no
    block over 128 columns, and 32-key tiles where O takes 128 or 160
    registers a thread."""
    assert [kv_tile(hd) for hd in (32, 64, 96, 128, 160, 256, 320)] == \
        [128, 128, 64, 64, 64, 32, 32]
    assert pv_columns(64) == [(0, 64)] and pv_columns(96) == [(0, 128)]
    assert pv_columns(160) == [(0, 128), (128, 192)]
    assert pv_columns(256) == [(0, 128), (128, 256)]
    assert pv_columns(320) == [(0, 128), (128, 256), (256, 320)]


def test_integer_rounding_is_bf16_rounding_to_nearest():
    """``round_pair`` rounds as the bf16 cast does everywhere except on
    exact ties, which it sends away from zero where the cast goes to
    even; P - hi is exact in fp32 and lo is within 2^-8 of it."""
    rs = np.random.RandomState(1)
    x = torch.from_numpy(np.concatenate([
        rs.rand(100_000), rs.rand(100_000) * 1e-20, -rs.rand(1000),
        [0.0, 1.0, 2 ** -126]]).astype(np.float32))
    bits = x.view(torch.int32)
    tie = (bits & 0xFFFF) == 0x8000
    hi = _bf16_nearest(x)
    assert torch.equal(hi[~tie], x[~tie].bfloat16().float())
    assert torch.equal(hi.bfloat16().float(), hi)
    lo = _bf16_nearest(x - hi)
    assert bool(((x - hi - lo).abs() <= 2 ** -8 * (x - hi).abs()).all())
    assert bool(((x - hi - lo).abs() <= 2 ** -16 * x.abs()).all())
