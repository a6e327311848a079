"""Fused AdamW (``csrc/fused_adamw.cu``): the least time of its launches
over their device time.  A step launches it once a leaf, under the
benchmark's span around ``Optimizer.update``; the least time of a
launch is its bytes (``yardstick.adamw_bytes``: g, m, v, p read once,
u, m, v written once) at the memory's bandwidth.  A step whose trace
lacks one of its launches (the profiler can lose a record) is left out,
since which leaf's launch it lacks is not known."""
from portbench import yardstick
from portbench.harness import SPAN_UPDATE

KERNEL = "fused_adamw_kernel"


def read(ctx):
    leaves = ctx.leaves
    whole = [t for t, n in ctx.trace.kernels_by_span(KERNEL, SPAN_UPDATE)
             if n == len(leaves) and t > 0]
    if not whole:
        return None
    per_step = sum(yardstick.least_time(0, yardstick.adamw_bytes(
        numel, dtype, dtype), yardstick.PEAK_BF16_FLOPS)
        for numel, dtype in leaves)
    return 100.0 * len(whole) * per_step / sum(whole)
