"""Device ms of one ``make_train_step`` call (a graph replay on the card), the
mean over the window of CUDA events around each call."""

import numpy as np


def read(rec, ctx):
    ms = rec.device_ms.get("train_step")
    return float(np.mean(ms)) if ms else None
