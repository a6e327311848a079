"""Device milliseconds a step of the work launched under the benchmark's
span around ``Strategy.sync`` (rank 0): the flat fp32 copy in and out,
and across ranks the collective."""
from portbench.harness import SPAN_SYNC


def read(ctx):
    if ctx.trace.span_count(SPAN_SYNC) == 0:
        return None
    return 1e3 * ctx.trace.span_device_s(SPAN_SYNC) / ctx.steps
