"""Device milliseconds of the ``pool`` phase of a Social GAN rollout unit
(the pooling module and the context MLP): the interval between the
program's device stamps at the phase's boundaries
(``socialways_torch.utils.profiling``), summed over the traced block's
units and divided by their count.  Nothing outside a traced run, from a
program that records no such phase, or when the session lost stamps."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    try:
        from socialways_torch.utils.profiling import phase_device_ms
    except ImportError:
        return None
    return phase_device_ms("pool", ctx.traced_units)
