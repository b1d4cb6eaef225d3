"""Device-busy milliseconds of one training step: the union of the
traced block's device intervals over the steps it ran.  Nothing when the
trace lost records of attention launches."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_whole or not ctx.traced_units:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.traced_units
