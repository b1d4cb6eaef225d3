"""The share of the traced block's Social GAN rollout units (simulated
windows) whose pool ran as the one fused kernel, in percent: the
program's ``pool.fused`` counter (``socialways_torch.utils.profiling``),
as gained inside each unit, over the block's units.  Nothing outside a
traced run or from a program without the fused pool
(``models.sgan.pool``) or the counter's reader."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    try:
        from socialways_torch.models.sgan import pool  # noqa: F401
        from socialways_torch.utils.profiling import counted_share
    except ImportError:
        return None
    return counted_share("pool.fused", ctx.traced_units)
