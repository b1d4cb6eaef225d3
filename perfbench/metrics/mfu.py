"""The whole loop's share of the card's peak, in percent: the model FLOPs
the window completed (``perfbench.flops``, counted from the shapes) over
the window's host time, against the peak of the configuration's compute
dtype (``perfbench.flops.PEAK_FLOPS``)."""


def read(ctx):
    w = ctx.window
    if not w.flops or w.seconds <= 0:
        return None
    return 100.0 * w.flops / w.seconds / ctx.peak_flops
