"""The share of the traced block's training steps that were replays of
the captured step, in percent: the program's ``graph.replays`` counter
(``socialways_torch.utils.profiling``), as gained inside each
``train.step`` unit, over the block's steps.  Nothing outside a traced
run or from a program without the counter."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    try:
        from socialways_torch.utils.profiling import counted_share
    except ImportError:
        return None
    return counted_share("graph.replays", ctx.traced_units)
