"""The DLRM-DCNv2 training window's share of the card's float32 peak: three
times the forward's operations (the dense arch, the cross network and the over
arch, from the shapes; ``port_bench/dlrm_roofline.py``) a step, over the
window's time a step. The bags, the loss and the optimizer count as time, not
as operations."""

from port_bench import dlrm_roofline as counts
from port_bench.roofline import FP32_FLOPS


def read(rec, ctx):
    if not rec.attempted or not rec.window_s:
        return None
    flops = counts.train_step_flops(ctx.config, ctx.traffic["batch"])
    return 100.0 * rec.attempted * flops / FP32_FLOPS / rec.window_s
