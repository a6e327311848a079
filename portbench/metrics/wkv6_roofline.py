"""WKV6 forward (``csrc/wkv6_tc.cu``): the least time of its launches
over their device time.  Every launch in these cells is one layer's
recurrence (or its recompute) over the rank's batch from a zero state;
its least time is the larger of the recurrence's operations at the TF32
peak (the route is 3xTF32) and its fp32 operands at the memory's
bandwidth (``yardstick.wkv6_cost``)."""
from portbench import yardstick

KERNEL = "wkv6_tc_kernel"


def read(ctx):
    t, n = ctx.trace.kernels(KERNEL)
    if n == 0 or t <= 0:
        return None
    cfg, mix = ctx.cell.cfg, ctx.cell.mix
    N = cfg["rwkv_head_dim"]
    ops, nbytes = yardstick.wkv6_cost(mix["batch"], mix["seq"],
                                      cfg["d_model"] // N, N)
    return 100.0 * n * yardstick.least_time(
        ops, nbytes, yardstick.PEAK_TF32_FLOPS) / t
