"""Device ms of xDeepFM's CIN forward inside the train step's CUDA graph (the
``CIN - Component`` span of ``models/deepfwfm.forward``: the outer products
and GEMMs of ``ops/interactions.cin_forward``): the mean
``device:CIN - Component`` span of the traced stretch."""

from port_bench import program_spans


def read(rec, ctx):
    return program_spans.mean_ms(rec, ctx, "device:CIN - Component")
