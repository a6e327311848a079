"""Share of the traced window in which no operation ran on the device:
100 x (1 - busy / window), both of the pass that traces the device's
work alone, so the host issues the steps at its untraced pace, and both
averaged over the ranks."""


def read(ctx):
    if ctx.window_s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
