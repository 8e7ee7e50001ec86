"""The CIN forward's share of its roofline: its least time at the step's batch
(its operations at the float32 peak or its compulsory bytes at HBM bandwidth,
whichever is longer; ``port_bench/cin_roofline.py``) over the mean
``device:CIN - Component`` span in the train step's graph."""

from port_bench import cin_roofline as counts
from port_bench import program_spans


def read(rec, ctx):
    ms = program_spans.mean_ms(rec, ctx, "device:CIN - Component")
    if not ms:
        return None
    return 100.0 * counts.cin_least_seconds(ctx.config, ctx.traffic["batch"]) / (ms * 1e-3)
