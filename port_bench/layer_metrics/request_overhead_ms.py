"""The mean request's wall time less the forward's device time: the copies
in and out and the host's work around the replay."""

import numpy as np


def read(rec, ctx):
    ms = rec.device_ms.get("forward")
    if not ms or not rec.latencies_s:
        return None
    return float(np.mean(rec.latencies_s)) * 1e3 - ms[0]
