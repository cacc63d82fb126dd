"""requant_ms.serve: device milliseconds a request launched inside the
program's ``quant.requant`` spans (models/quant.py: each convolution's f32
dequantize, bias, ReLU and requantize to int8 or 4 bits, and each residual
add), from the traced sub-window (portbench/program_spans.py)."""

from portbench.program_spans import per_iteration


def read(rec):
    return per_iteration(rec, "serve", "quant.requant", "device")
