"""The bag exchanges' share of their roofline: the bytes that must enter one
card a step whatever the algorithm (``port_bench/dlrm_sharded_roofline.py``)
at the card's link peak a direction, over the exchanges' device ms a step on
rank 0."""

from port_bench import dlrm_sharded_roofline as counts


def read(rec, ctx):
    ms = counts.exchange_ms(rec, ctx)
    if not ms:
        return None
    least = counts.exchange_least_seconds(ctx.config, ctx.traffic["batch"], ctx.traffic["ranks"])
    return 100.0 * least / (ms * 1e-3)
