"""requant_mb.serve: megabytes a request that the program's ``quant.requant``
spans count as read and written (each site's int32 sums and, at a block's
tail, its int8 residual read; its int8 output written), from the traced
sub-window (portbench/program_spans.py). None where no such span counts
bytes (a program older than the count)."""

from portbench import program_spans
from portbench.program_spans import per_iteration


def read(rec):
    att = program_spans.read(rec) if rec.kind == "serve" else None
    if att is None or not any("bytes" in s.counts for s in att.spans
                              if s.name == "quant.requant"):
        return None
    return per_iteration(rec, "serve", "quant.requant", "bytes")
