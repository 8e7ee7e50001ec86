"""The bags' update's share of its roofline: its compulsory bytes (the bags'
gradient and every id read, each distinct row's weights and accumulator read
and written; ``port_bench/dlrm_roofline.py``) at HBM bandwidth over the mean
``device:Bags - Update`` span. The distinct rows are the benchmark's own
count over the profiled stretch's batches (``info bag_distinct_rows``)."""

from port_bench import dlrm_roofline as counts
from port_bench import program_spans


def read(rec, ctx):
    ms = program_spans.mean_ms(rec, ctx, "device:Bags - Update")
    rows = rec.info.get("bag_distinct_rows")
    if not ms or not rows:
        return None
    least = counts.update_least_seconds(ctx.config, ctx.traffic["batch"], rows)
    return 100.0 * least / (ms * 1e-3)
