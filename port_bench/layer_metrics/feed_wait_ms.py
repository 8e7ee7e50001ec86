"""Device ms a training step waits for its batch from
``data.batching.prefetch_to_device``: the mean over the window, on CUDA
events, of the stretch from the end of one step's work (its refresh
included) to the start of the next step. It holds the next batch's copy to
the card and any time the card sat waiting for the host to hand the step
over; where the host runs ahead, only the copy."""

import numpy as np


def read(rec, ctx):
    ms = rec.device_ms.get("feed_wait")
    return float(np.mean(ms)) if ms else None
