"""Device ms of DLRM-DCNv2's pooled lookup of its multi-hot bags in the train
step's CUDA graph (the ``Bags - Lookup`` span of ``models/dlrm.forward``,
``ops/embedding.bag_lookup``): the mean ``device:Bags - Lookup`` span of the
loop's traced stretch."""

from port_bench import program_spans


def read(rec, ctx):
    return program_spans.mean_ms(rec, ctx, "device:Bags - Lookup")
