"""int_mm_ms.serve: device milliseconds a request launched inside the
program's ``quant.int_mm`` spans (models/quant.py ``_conv_int8``: the
operands' padding to multiples of 32 and ``torch._int_mm``), from the
traced sub-window (portbench/program_spans.py)."""

from portbench.program_spans import per_iteration


def read(rec):
    return per_iteration(rec, "serve", "quant.int_mm", "device")
