"""Host ms of a request's launch (``Predictor.logits``: the graph's replay
call): the mean self time of ``request.launch`` in the traced stretch, less
the tracer's own ``trace.read`` of the last replay's events inside it."""

from port_bench import program_spans


def read(rec, ctx):
    return program_spans.mean_ms(rec, ctx, "request.launch")
