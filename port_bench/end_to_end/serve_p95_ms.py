"""The 95th percentile of all the window's requests, each timed from the call
until its logits are in host memory."""

import numpy as np


def read(rec, ctx):
    return float(np.percentile(rec.latencies_s, 95)) * 1e3 if rec.latencies_s else None
