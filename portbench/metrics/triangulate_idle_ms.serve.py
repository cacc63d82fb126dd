"""triangulate_idle_ms.serve: milliseconds a request in which the device
was idle while the host was inside the program's ``geometry.triangulate``
span, the gap taken at its middle, from the traced sub-window
(portbench/program_spans.py)."""

from portbench.program_spans import per_iteration


def read(rec):
    return per_iteration(rec, "serve", "geometry.triangulate", "idle")
