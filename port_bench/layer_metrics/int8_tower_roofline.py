"""The int8 tower's share of its roofline: the least time at the request's
batch (bytes at HBM bandwidth or int8 operations at the int8 peak, whichever
is longer) over the device time of one tower call as ``quantized_forward``
makes it, on its real input, timed at the entry in a graph of 20 calls."""

from port_bench import roofline


def read(rec, ctx):
    ms = rec.device_ms.get("int8_tower")
    if not ms:
        return None
    least = roofline.int8_tower_least_seconds(ctx.config, ctx.traffic["batch"])
    return 100.0 * least / (ms[0] * 1e-3)
