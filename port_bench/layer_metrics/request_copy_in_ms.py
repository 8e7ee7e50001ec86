"""Host ms of a request's copy in (``Predictor.logits``: the host arrays as
tensors and their copy into the graph's static buffers, issued from pageable
memory): the mean ``request.copy_in`` span of the traced stretch."""

from port_bench import program_spans


def read(rec, ctx):
    return program_spans.mean_ms(rec, ctx, "request.copy_in")
