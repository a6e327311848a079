"""The whole step's share of the cards' dense bf16 peak: the model FLOPs
of the tokens trained in the traced window (three times the forward, as
``yardstick.train_flops_per_token`` counts it) over the window's length
times the cards times the peak.  The window is that of the pass that
traces the device's work alone, whose steps the host issues at its
untraced pace."""
from portbench import yardstick


def read(ctx):
    if ctx.window_s <= 0 or ctx.busy_s <= 0:
        return None
    flops = ctx.steps * ctx.tokens_per_step * \
        yardstick.train_flops_per_token(ctx.cell.cfg, ctx.cell.mix["seq"])
    return 100.0 * flops / (ctx.window_s * ctx.cell.world
                            * yardstick.PEAK_BF16_FLOPS)
