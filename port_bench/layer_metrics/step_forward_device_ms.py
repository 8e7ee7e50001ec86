"""Device ms of the train step's forward (``train/trainer.batch_loss``: the
lookups, the interactions, the tower and the masked BCE) inside the step's
CUDA graph: the mean ``device:step.forward`` span of the traced stretch, read
from the timing events the traced capture holds."""

from port_bench import program_spans


def read(rec, ctx):
    return program_spans.mean_ms(rec, ctx, "device:step.forward")
