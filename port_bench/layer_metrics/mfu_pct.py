"""A request's share of the card's peak: the forward's model operations (from
the shapes; int8 products at the int8 peak, the rest at the float32 peak)
over the mean request's wall time."""

import numpy as np

from port_bench import roofline


def read(rec, ctx):
    if not rec.latencies_s:
        return None
    tr = ctx.traffic
    ops = roofline.forward_ops(ctx.config, tr["batch"], tr["precision"])
    return 100.0 * roofline.least_seconds(ops) / float(np.mean(rec.latencies_s))
