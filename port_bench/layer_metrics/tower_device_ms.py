"""Device ms of the deep tower in the request's graph (the ``Deep - Component``
span of ``models/deepfwfm.forward`` or ``compression/quantization.quantized_forward``:
the fused int8 kernel, or the fp32 GEMMs): the mean ``device:Deep - Component``
span of the traced stretch."""

from port_bench import program_spans


def read(rec, ctx):
    return program_spans.mean_ms(rec, ctx, "device:Deep - Component")
