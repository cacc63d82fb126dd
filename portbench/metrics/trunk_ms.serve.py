"""trunk_ms.serve: device milliseconds a request in every operation that is
not a hand kernel of the program (``posetpu::``) nor a copy or fill: the
int8 trunk's im2col, ``torch._int_mm`` and requantize passes, and the
PyTorch passes around them, from the traced sub-window."""

from portbench.trace import HAND

COPIES = ("Memcpy", "Memset")


def read(rec):
    tr = rec.trace
    if rec.kind != "serve" or tr is None or not tr.iterations:
        return None
    us = sum(b - a for n, a, b in tr.ops
             if HAND not in n and not any(c in n for c in COPIES))
    return us / 1e3 / tr.iterations
