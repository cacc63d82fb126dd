"""im2col_mb.serve: megabytes a request that the program's ``quant.im2col``
spans count as written (the padded inputs and the column matrices that
are not views of the input), from the traced sub-window
(portbench/program_spans.py)."""

from portbench.program_spans import per_iteration


def read(rec):
    return per_iteration(rec, "serve", "quant.im2col", "bytes")
