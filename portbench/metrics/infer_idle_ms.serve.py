"""infer_idle_ms.serve: milliseconds a request in which the device was idle
while the host was inside the program's ``serve.infer`` span (or one of
its children), the gap taken at its middle, from the traced sub-window
(portbench/program_spans.py)."""

from portbench.program_spans import per_iteration


def read(rec):
    return per_iteration(rec, "serve", "serve.infer", "idle")
