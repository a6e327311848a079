"""What the plain references share: the seeded weights both sides are
given, the precisions a reference runs in, RMSNorm, RoPE, the loss, and
three training steps under plain AdamW with their readings.

Plain fp32 PyTorch, TF32 off.  Nothing here imports the program, JAX or
the JAX package.
"""
from __future__ import annotations

import math

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# the inputs: weights drawn from the seed on the device
# ---------------------------------------------------------------------------
def draw_state(specs: dict, seed: int, device) -> dict:
    """{leaf name: tensor} from ``specs`` ({name: (shape, dtype, init)}),
    drawn by one ``torch.Generator`` on ``device`` in one large call per
    dtype and kind, in the leaf's own dtype.  ``init`` is ``("normal",
    std)`` or ``("uniform", lo, hi)``.  The same seed on the same device
    gives the same bits."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    out = {}
    groups = {}
    for name in sorted(specs):
        shape, dtype, init = specs[name]
        groups.setdefault((init[0], dtype), []).append(name)
    for (kind, dtype), names in sorted(groups.items()):
        sizes = [math.prod(specs[n][0]) for n in names]
        dt = _DTYPES[dtype]
        if kind == "normal":
            flat = torch.randn(sum(sizes), generator=gen, dtype=dt,
                               device=device)
        elif kind == "uniform":
            flat = torch.rand(sum(sizes), generator=gen, dtype=dt,
                              device=device)
        else:
            raise ValueError(f"unknown init {kind!r}")
        for n, part in zip(names, flat.split(sizes)):
            shape, _, init = specs[n]
            t = part.view(shape)
            if kind == "normal":
                t.mul_(init[1])
            else:
                t.mul_(init[2] - init[1]).add_(init[1])
            out[n] = t
    return out


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // 128) * 128


# ---------------------------------------------------------------------------
# precisions: the reference in fp32, its control a precision lower
# ---------------------------------------------------------------------------
def exact(t):
    return t


def _round_fp8(t, dtype, top):
    """``t`` rounded to the fp8 ``dtype`` under a per-tensor scale that
    maps its largest magnitude to ``top``, back in t's dtype."""
    s = top / t.abs().max().clamp(min=1e-30)
    return (t * s).to(dtype).to(t.dtype) / s


class _Fp8(torch.autograd.Function):
    """An operand of a product in fp8 training's precision: rounded to
    e4m3 going forward, its gradient rounded to e5m2 coming back."""

    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, 57344.0)


def fp8(t):
    """The control's precision, one step below the bf16 the
    configurations state: every operand of a product in fp8 (e4m3
    forward, e5m2 gradients), per-tensor scaled, the rest in fp32."""
    return _Fp8.apply(t)


PRECISIONS = {"fp32": exact, "fp8": fp8}


def mm(a, w, cast):
    """``a @ w`` with both operands in the run's precision."""
    return cast(a) @ cast(w)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps=1e-6):
    """RMSNorm with statistics in fp32 and the scale ``1 + w``."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + w)


def rope(x, theta):
    """Rotary embedding of x (B, S, heads, hd) at positions 0..S-1: the
    two halves of each head rotated."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def cross_entropy(logits, labels):
    """Mean over tokens of logsumexp minus the gold logit."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


# ---------------------------------------------------------------------------
# three training steps and their readings
# ---------------------------------------------------------------------------
def train_readings(loss_fn, params: dict, steps, *, lr, b1=0.9, b2=0.95,
                   eps=1e-8, wd=0.0) -> dict:
    """Runs ``len(steps)`` AdamW steps from ``params`` ({name: fp32
    tensor}, changed in place).  Each step is a list of shards (one a
    rank); its loss and gradient are the means of the shards' (each
    shard's loss is ``loss_fn(params, shard)``).  Returns the readings
    the harness compares: each step's loss, each leaf's gradient norm at
    step 1, and each leaf's change after the last step."""
    names = sorted(params)
    start = {n: params[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    losses, grad_norms = [], None
    for i, shards in enumerate(steps, start=1):
        total = {n: torch.zeros_like(params[n]) for n in names}
        step_loss = 0.0
        for shard in shards:
            leaves = {n: params[n].detach().requires_grad_() for n in names}
            loss = loss_fn(leaves, shard)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
            for n, g in zip(names, grads):
                total[n].add_(g)
            step_loss += float(loss.detach())
            del loss, grads, leaves
        W = len(shards)
        losses.append(step_loss / W)
        c1, c2 = 1 - b1 ** i, 1 - b2 ** i
        with torch.no_grad():
            for n in names:
                g = total[n].div_(W)
                m[n].mul_(b1).add_((1 - b1) * g)
                v[n].mul_(b2).add_((1 - b2) * g * g)
                u = (m[n] / c1) / (torch.sqrt(v[n] / c2) + eps) \
                    + wd * params[n]
                params[n].sub_(lr * u)
            if i == 1:
                grad_norms = {n: float(torch.linalg.vector_norm(total[n]))
                              for n in names}
        del total
    change = {n: float(torch.linalg.vector_norm(params[n] - start[n]))
              for n in names}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}


def set_fp32_math():
    """fp32 products in fp32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
