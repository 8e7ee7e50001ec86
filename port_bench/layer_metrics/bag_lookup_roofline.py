"""The pooled lookup's share of its roofline: its compulsory bytes (every id,
each distinct row once, the pooled bags written; ``port_bench/dlrm_roofline.py``)
at HBM bandwidth over the mean ``device:Bags - Lookup`` span. The distinct
rows are the benchmark's own count over the profiled stretch's batches
(``info bag_distinct_rows``), never the program's."""

from port_bench import dlrm_roofline as counts
from port_bench import program_spans


def read(rec, ctx):
    ms = program_spans.mean_ms(rec, ctx, "device:Bags - Lookup")
    rows = rec.info.get("bag_distinct_rows")
    if not ms or not rows:
        return None
    least = counts.lookup_least_seconds(ctx.config, ctx.traffic["batch"], rows)
    return 100.0 * least / (ms * 1e-3)
