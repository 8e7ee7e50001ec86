"""The training window's share of the card's peak: the model operations of
every step (forward and backward, from the shapes) at their precision's peak,
over the window's time. The refresh and the optimizer count as time, not as
operations."""

from port_bench import roofline


def read(rec, ctx):
    if not rec.attempted or not rec.window_s:
        return None
    ops = roofline.train_step_ops(ctx.config, ctx.traffic["batch"])
    return 100.0 * rec.attempted * roofline.least_seconds(ops) / rec.window_s
