"""Median host milliseconds of a ``forecast.request`` unit of the
traced block, from its entry until its last launch returned (the
program's span, ``socialways_torch.utils.profiling``): the request's
rollout without the copies and the noise draw of
``perfbench/drivers/forecast.py``.  Nothing outside a
traced run or from a program without the span."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    try:
        from socialways_torch.utils.profiling import unit_host_ms
    except ImportError:
        return None
    return unit_host_ms(ctx.traced_units)
