"""The share of the traced block's rollout units (simulated windows,
forecast requests) whose encode ran as the one fused kernel, in percent:
the program's ``encode.fused`` counter (``socialways_torch.utils.
profiling``), as gained inside each unit, over the block's units.
Nothing outside a traced run or from a program without the fused encoder
(``models.generator.fused_encode``) or the counter's reader."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    try:
        from socialways_torch.models.generator import fused_encode  # noqa
        from socialways_torch.utils.profiling import counted_share
    except ImportError:
        return None
    return counted_share("encode.fused", ctx.traced_units)
