"""optimizer_ms.train: device milliseconds a step in the optimizer's
kernels (PyTorch's ``foreach`` / ``multi_tensor_apply`` passes of Adam),
from the traced sub-window."""

OPTIMIZER = ("foreach", "multi_tensor")


def read(rec):
    tr = rec.trace
    if rec.kind != "train" or tr is None or not tr.iterations:
        return None
    us = sum(b - a for n, a, b in tr.ops if any(k in n for k in OPTIMIZER))
    return us / 1e3 / tr.iterations if us > 0 else None
