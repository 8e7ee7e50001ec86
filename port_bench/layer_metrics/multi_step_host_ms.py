"""The host's own ms a step of the ``make_multi_step`` calls: the self time of
``feed.stage`` (the group into its pinned slot, the copies issued) and
``train.step`` (the call and its replay's launch) in the traced stretch's
calls without the profiler, each followed by a sync, over the real steps of
those calls (``info traced_stretch_steps``). Waits are left out: ``feed.wait``
is a span of its own and the tracer's ``trace.read`` a child."""

from port_bench import program_spans

HOST = ("feed.stage", "train.step")


def read(rec, ctx):
    spans = program_spans.stretch(rec, ctx)
    steps = rec.info.get("traced_stretch_steps")
    return program_spans.self_ms_total(spans, HOST) / steps if spans and steps else None
