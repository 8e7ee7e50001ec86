"""Device ms of DLRM-DCNv2's cross network in the train step's CUDA graph (the
``DCN - Component`` span of ``models/dlrm.forward``: the three low-rank cross
layers of ``ops/interactions.dcn_cross``, the forward only): the mean
``device:DCN - Component`` span of the loop's traced stretch."""

from port_bench import program_spans


def read(rec, ctx):
    return program_spans.mean_ms(rec, ctx, "device:DCN - Component")
