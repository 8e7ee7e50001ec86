"""Device ms of the train step's ``Optimizer.update`` (L2, the moments, their
subnormal flush and the parameters' update) inside the step's CUDA graph: the
mean ``device:step.optimizer`` span of the traced stretch."""

from port_bench import program_spans


def read(rec, ctx):
    return program_spans.mean_ms(rec, ctx, "device:step.optimizer")
