"""Device ms of DLRM-DCNv2's sparse Adagrad in the train step's CUDA graph
(the ``Bags - Update`` span of ``train/trainer.Optimizer.update``: the sort of
the batch's ids, the summed gradients of each distinct row and their update,
``ops/embedding.bag_adagrad_``): the mean ``device:Bags - Update`` span of the
loop's traced stretch."""

from port_bench import program_spans


def read(rec, ctx):
    return program_spans.mean_ms(rec, ctx, "device:Bags - Update")
