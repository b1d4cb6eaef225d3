"""The social-attention kernels' share of their roofline, in percent: the
sum of each launch's least time (``perfbench.bounds``, from the pairs its
inputs need) over the kernels' device time in the traced block, by kernel
name.  Nothing without attention records or when the trace lost some."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_whole:
        return None
    spent = ctx.trace.attn_seconds()
    if spent <= 0 or ctx.traced_bound_s <= 0:
        return None
    return 100.0 * ctx.traced_bound_s / spent
