"""Host ms of a request's copy out (``Predictor.logits``: the logits to host
numpy, after ``request.wait`` has waited for the card): the mean
``request.copy_out`` span of the traced stretch."""

from port_bench import program_spans


def read(rec, ctx):
    return program_spans.mean_ms(rec, ctx, "request.copy_out")
