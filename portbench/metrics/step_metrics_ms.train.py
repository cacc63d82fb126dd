"""step_metrics_ms.train: device milliseconds a step launched inside the
program's ``train.metrics`` span (train/step.py: the metrics' detach and
the PCK on the routed output), from the traced sub-window
(portbench/program_spans.py)."""

from portbench.program_spans import per_iteration


def read(rec):
    return per_iteration(rec, "train", "train.metrics", "device")
