"""The device's idle share of the traced block, in percent: one minus the
union of its kernel, copy and set intervals over the block's length.
Nothing when the trace lost records of attention launches."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_whole:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
