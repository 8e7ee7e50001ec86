"""The prune refresh's share of its roofline: the least time, every pruned
value read once and written once at HBM bandwidth, over the mean device time
of the window's ``PruneRefresh`` calls between CUDA events."""

import numpy as np

from port_bench import roofline


def read(rec, ctx):
    ms = rec.device_ms.get("prune_refresh")
    if not ms:
        return None
    return 100.0 * roofline.refresh_least_seconds(ctx.config) / (float(np.mean(ms)) * 1e-3)
