"""Device milliseconds a step of the work launched under the benchmark's
span around ``Optimizer.update`` (rank 0)."""
from portbench.harness import SPAN_UPDATE


def read(ctx):
    if ctx.trace.span_count(SPAN_UPDATE) == 0:
        return None
    return 1e3 * ctx.trace.span_device_s(SPAN_UPDATE) / ctx.steps
