"""backward_ms.train: device milliseconds a step launched inside the program's
``train.backward`` span (train/step.py), from the traced sub-window
(portbench/program_spans.py)."""

from portbench.program_spans import per_iteration


def read(rec):
    return per_iteration(rec, "train", "train.backward", "device")
