"""Device ms a step of the sharded DLRM-DCNv2 step's three bag exchanges
(``parallel/bag_sharding``: the ids' all-gather, the partial bags'
reduce-scatter, the bag gradients' all-gather, each a span of its own in the
train step's CUDA graph): their ``device:Bags - ... Exchange`` spans in rank
0's traced stretch, summed, over its steps."""

from port_bench import dlrm_sharded_roofline as counts


def read(rec, ctx):
    return counts.exchange_ms(rec, ctx)
