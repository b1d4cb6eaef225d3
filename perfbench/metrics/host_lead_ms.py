"""Median, over the traced block's phase boundaries, of how far the
device ran each boundary's stamp behind the host's launch of it, in
milliseconds, on one clock through the session's anchor stamp
(``socialways_torch.utils.profiling``).  Near 0: the device waits on
the host there.  Nothing outside a traced run, from a program without
stamps, or when the session lost stamps."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    try:
        from socialways_torch.utils.profiling import host_lead_ms
    except ImportError:
        return None
    return host_lead_ms(ctx.traced_units)
