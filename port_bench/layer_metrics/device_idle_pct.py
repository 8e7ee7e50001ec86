"""The share of the window's time in which no kernel, copy or memset ran on
the card: the card's busy time a step or request in the profiled stretch
that follows the window (``torch.profiler``, the card's activity alone), over
the window's own time a step or request.

The stretch's own length is not the denominator: the tracer's work on the
host slows the host, which reads as idle device time where the host sets the
pace. Where the card is saturated the reading lies within the noise of 0,
on either side of it."""


def read(rec, ctx):
    if not rec.busy_s or not rec.traced_units or not rec.attempted:
        return None
    return 100.0 * (1.0 - (rec.busy_s / rec.traced_units) / (rec.window_s / rec.attempted))
