"""The host's own ms a step: the self time of ``feed.stage`` (the batch into
its pinned slot, the copies issued), ``train.step`` (the step's call and its
replay's launch) and ``train.refresh`` in the traced stretch's steps without
the profiler, each followed by a sync (so that no call into CUDA waits for
the card), over its steps. Waits are left out: ``feed.wait`` is a span of its
own and the tracer's ``trace.read`` a child. A step that takes less device
time than this would wait for the host."""

from port_bench import program_spans


HOST = ("feed.stage", "train.step", "train.refresh")


def read(rec, ctx):
    spans = program_spans.stretch(rec, ctx)
    steps = sum(s.name == "train.step" for s in spans or ())
    return program_spans.self_ms_total(spans, HOST) / steps if steps else None
