"""Device ms of the sharded DLRM-DCNv2 step's all-reduce of the dense leaves'
gradients (``parallel/bag_sharding.ShardedBags.reduce``): the mean
``device:Dense - All Reduce`` span of rank 0's traced stretch."""

from port_bench import program_spans


def read(rec, ctx):
    return program_spans.mean_ms(rec, ctx, "device:Dense - All Reduce")
