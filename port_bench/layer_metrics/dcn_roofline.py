"""The cross network's forward share of its roofline: its operations (two
GEMMs of D·r multiply-adds a layer and example, ``port_bench/dlrm_roofline.py``)
at the float32 peak, over the mean ``device:DCN - Component`` span in the
train step's graph."""

from port_bench import dlrm_roofline as counts
from port_bench import program_spans


def read(rec, ctx):
    ms = program_spans.mean_ms(rec, ctx, "device:DCN - Component")
    if not ms:
        return None
    return 100.0 * counts.dcn_least_seconds(ctx.config, ctx.traffic["batch"]) / (ms * 1e-3)
