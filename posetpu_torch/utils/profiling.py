"""Tracing and step timing.

The reference's observability is wall-clock AverageMeters and GPU memory in
the log line (lib/core/function.py:93-96, 471-487). Here:

* :func:`trace`: a ``torch.profiler`` span (CPU and CUDA activity) written
  as a Chrome trace, for the device timeline of the steps inside it;
* :class:`StepTimer`: the loop's step and data times. It waits for the
  device only where the caller hands it a value to fetch (the loop does so
  on its logging steps), so between them the host runs ahead of the card.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a span: ``with trace(dir): run_steps()`` writes
    ``<dir>/trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> dict:
    """The card's bytes in use and their peak (``torch.cuda.memory_stats``);
    {} where there is no card."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats()
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", -1)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", -1))}


def sync(value) -> float:
    """Wait for the device by fetching ``value``'s sum; returns it."""
    return float(torch.as_tensor(value).detach().float().sum())


class StepTimer:
    """Rolling step and data times of the train loop (the reference's
    batch_time / data_time AverageMeters)."""

    def __init__(self):
        self.step_times: list[float] = []
        self.data_times: list[float] = []
        self._t = time.perf_counter()

    def data_ready(self):
        now = time.perf_counter()
        self.data_times.append(now - self._t)
        self._t = now

    def step_done(self, sync_value=None):
        if sync_value is not None:
            sync(sync_value)
        now = time.perf_counter()
        self.step_times.append(now - self._t)
        self._t = now

    def summary(self, samples_per_step: int = 0) -> dict:
        out = {}
        if self.step_times:
            st = float(np.mean(self.step_times[-50:]))
            out["step_ms"] = st * 1e3
            if samples_per_step:
                out["samples_per_s"] = samples_per_step / st
        if self.data_times:
            out["data_ms"] = float(np.mean(self.data_times[-50:])) * 1e3
        out.update(device_memory_stats())
        return out
