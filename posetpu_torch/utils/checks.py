"""Run-time guards: the canonical batch layout, and an opt-in guard
(``POSETPU_CHECK_FINITE=1``, the switch the JAX package reads) that stops a
run at the first NaN or Inf metric."""

from __future__ import annotations

import os

import numpy as np


def assert_batch_shapes(batch: dict, nviews: int = 4, num_joints: int = 16) -> None:
    """Validate the [N, V, ...] training batch layout; ValueError if not."""
    n = batch["images"].shape[0]
    expect = {
        "images": (n, nviews, None, None, 3),
        "target": (n, nviews, None, None, num_joints),
        "weight": (n, nviews, num_joints),
        "is_h36m": (n,),
        "center": (n, nviews, 2),
        "scale": (n, nviews, 2),
    }
    for key, shape in expect.items():
        if key not in batch:
            raise ValueError(f"batch missing '{key}'")
        got = tuple(batch[key].shape)
        if len(got) != len(shape) or any(e is not None and g != e for g, e in zip(got, shape)):
            raise ValueError(f"batch['{key}'] shape {got}, expected {shape}")


def finite_guard_enabled() -> bool:
    return os.environ.get("POSETPU_CHECK_FINITE", "0") == "1"


def check_finite_metrics(metrics: dict, step: int = -1) -> None:
    """FloatingPointError on a non-finite scalar metric (a no-op unless
    enabled). Reading a metric on the device waits for its step."""
    if not finite_guard_enabled():
        return
    for k, v in metrics.items():
        val = np.asarray(v.detach().float().cpu() if hasattr(v, "detach") else v)
        if val.size == 1 and not np.isfinite(float(val)):
            raise FloatingPointError(f"non-finite metric '{k}' at step {step}: {val}")
