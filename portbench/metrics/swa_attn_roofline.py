"""Sliding-window attention (``csrc/swa_attention_tc.cu``): the least
time of its launches over their device time.  Every launch in these
cells is one attention layer's forward (or its recompute) over the
rank's batch; its least time is the larger of the causal window's
operations at the bf16 peak and q, k, v and o at the memory's
bandwidth (``yardstick.swa_attention_cost``)."""
from portbench import yardstick

KERNEL = "swa_wgmma_kernel"


def read(ctx):
    t, n = ctx.trace.kernels(KERNEL)
    if n == 0 or t <= 0:
        return None
    cfg, mix = ctx.cell.cfg, ctx.cell.mix
    window = cfg["window"] if "local" in cfg["layer_pattern"] else None
    ops, nbytes = yardstick.swa_attention_cost(
        mix["batch"], mix["seq"], cfg["n_heads"], cfg["n_kv_heads"],
        yardstick.head_dim(cfg), window, cfg["dtype"])
    return 100.0 * n * yardstick.least_time(
        ops, nbytes, yardstick.PEAK_BF16_FLOPS) / t
