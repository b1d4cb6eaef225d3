"""Device milliseconds of a training step's ``g_update`` phase (the G
loss against the unrolled D, its backward through the rollout, G's
Adam): the interval between the program's device stamps at the phase's
boundaries (``socialways_torch.utils.profiling``), summed over the
traced block's units and divided by their count.  Nothing outside a
traced run, from a program that records no such phase, or when the
session lost stamps."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    try:
        from socialways_torch.utils.profiling import phase_device_ms
    except ImportError:
        return None
    return phase_device_ms("g_update", ctx.traced_units)
