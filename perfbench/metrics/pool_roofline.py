"""The Social GAN pool kernel's share of its roofline, in percent: the sum
of each pooling's least time (``perfbench.sgan_counts.pool_bound``, from
the pairs its crowd holds) over the kernel's device time in the traced
block, by kernel name.  Nothing without a trace or without the kernel's
records."""

KERNEL = "social_pool_kernel"


def read(ctx):
    if ctx.trace is None or ctx.traced_bound_s <= 0:
        return None
    spent = ctx.trace.by_name.get(KERNEL, 0.0)
    if spent <= 0:
        return None
    return 100.0 * ctx.traced_bound_s / spent
