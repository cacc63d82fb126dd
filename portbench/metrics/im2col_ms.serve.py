"""im2col_ms.serve: device milliseconds a request launched inside the
program's ``quant.im2col`` spans (models/quant.py ``_im2col``: the padded
copy and the column matrix of each int8 convolution), from the traced
sub-window (portbench/program_spans.py)."""

from portbench.program_spans import per_iteration


def read(rec):
    return per_iteration(rec, "serve", "quant.im2col", "device")
