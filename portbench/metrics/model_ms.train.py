"""model_ms.train: device milliseconds a step outside the optimizer's
kernels: the forward, the losses and the backward, from the traced
sub-window."""

OPTIMIZER = ("foreach", "multi_tensor")


def read(rec):
    tr = rec.trace
    if rec.kind != "train" or tr is None or not tr.iterations:
        return None
    us = sum(b - a for n, a, b in tr.ops if not any(k in n for k in OPTIMIZER))
    return us / 1e3 / tr.iterations
