"""Device ms of the train step's backward (``torch.autograd.grad`` over every
leaf) inside the step's CUDA graph: the mean ``device:step.backward`` span of
the traced stretch."""

from port_bench import program_spans


def read(rec, ctx):
    return program_spans.mean_ms(rec, ctx, "device:step.backward")
