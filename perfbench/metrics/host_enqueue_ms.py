"""Median host milliseconds from a request's start until the program's
last launch for it returns (the forecast is queued, not yet done), over
the window's requests."""

import statistics


def read(ctx):
    enq = ctx.window.samples.get("enqueue_ms")
    return statistics.median(enq) if enq else None
