"""The traced sub-window: torch.profiler over the last iterations of a
``--trace 1`` run, reduced to device intervals by kernel name, the
benchmark's own host spans, the device's busy time, and the breakdown.

The reduction is ``chip_smoke.py:profile_request``'s (lines 451-513),
frozen here: the device busy time as the union of the intervals of every
device operation, the idle share as one minus busy over the host clock's
wall of the window (ending in a synchronize). Hand kernels carry the
``posetpu::`` namespace.

On a GPU only the CUDA activity is profiled (the device's operations and
the runtime's calls), not the host's operators: recording each of them
(5,000-21,000 a training step) slowed the host so that the traced window
idled two to four times as much as the measured one. The benchmark's spans
are therefore its own, read on the host clock in the profiler's time base
(``time.time_ns``), and so are the window's ends, which cut the device's
operations to the window.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

HAND = "posetpu::"
SPAN = "portbench."


@dataclass
class Trace:
    """Device operations [(name, start us, end us)], the benchmark's host
    spans [(name, start us, end us)], the host's innermost operation at
    each instant (for the idle gaps), the iterations traced and the wall
    seconds of the traced window."""

    ops: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    host_ops: list = field(default_factory=list)
    iterations: int = 0
    wall_s: float = 0.0
    reduce_s: float = 0.0
    clock_check: dict = field(default_factory=dict)

    def busy_us(self, ops=None) -> float:
        """The union of the intervals of ``ops`` (all device operations)."""
        busy, end = 0.0, float("-inf")
        for _, a, b in sorted(ops if ops is not None else self.ops, key=lambda o: o[1]):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy

    def gaps(self):
        """[(start us, end us)] of the device's idle gaps between its first
        and last operation."""
        out, end = [], None
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if end is not None and a > end:
                out.append((end, a))
            end = b if end is None else max(end, b)
        return out

    def host_at(self, t: float) -> str:
        """What the host did at ``t``: the innermost of the benchmark's
        spans, the runtime call it was in, and the device operation it
        launched next."""
        span = next((n for n, a, b in reversed(self.spans) if a <= t <= b), "outside spans")
        call = None
        for n, a, b in self.host_ops:
            if a <= t <= b and (call is None or a >= call[1]):
                call = (n, a)
        after = next((n for n, a, _ in sorted(self.ops, key=lambda o: o[1]) if a >= t), "the end")
        return f"{span} / {call[0] if call else 'host'} before {after[:60]}"

    def breakdown(self, top: int = 10) -> dict:
        by = {}
        for n, a, b in self.ops:
            by[n] = by.get(n, 0.0) + (b - a)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:120], us / 1e6] for n, us in ops],
                "idle_gaps": [[self.host_at((a + b) / 2), (b - a) / 1e6] for a, b in gaps]}


def idle_share(rec):
    """The share of the traced window's wall in which no operation ran on
    the device, in %: what the result's ``device.busy_s`` and ``window_s``
    give. None without a trace."""
    tr = rec.trace
    if tr is None or not tr.ops or not tr.wall_s > 0:
        return None
    return 100.0 * (1.0 - tr.busy_us() / 1e6 / tr.wall_s)


class Traced:
    """A profiled sub-window: the driver runs ``iterations + 1`` iterations,
    each inside one top-level ``span``, and calls :meth:`tick` after each.
    The first warms the profiler up and is left out: the window runs from
    a synchronize after it to one after the last."""

    def __init__(self, iterations: int, sync):
        self.trace = Trace(iterations=iterations)
        self.ticks, self.start, self.end = 0, None, None
        self.start_us = self.end_us = None
        self._sync = sync

    def tick(self):
        self.ticks += 1
        if self.ticks == 1:
            self._sync()
            self.start, self.start_us = time.perf_counter(), time.time_ns() / 1e3
        elif self.ticks == self.trace.iterations + 1:
            self._sync()
            self.end, self.end_us = time.perf_counter(), time.time_ns() / 1e3


_spans = None  # [(name, start us, end us)] while a window is traced


@contextmanager
def traced(iterations: int, device):
    """Profile ``iterations`` iterations (CUDA activity on a GPU, the host's
    operators elsewhere) after one that warms the profiler up; yields a
    :class:`Traced`. Python's garbage collector is held off meanwhile: a
    collection among the profiler's own objects once stalled the host for
    167 ms inside one traced R50 training step."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    global _spans
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    sync()
    gc.disable()
    _spans = []
    try:
        with profile(activities=acts) as prof:
            t = Traced(iterations, sync)
            yield t
    finally:
        gc.enable()
        spans, _spans = _spans, None
    if t.ticks != iterations + 1:
        raise RuntimeError(f"the traced window ticked {t.ticks} times, not {iterations + 1}")
    tr = t.trace
    tr.wall_s = t.end - t.start
    t1 = time.perf_counter()
    t0_us, t1_us = t.start_us, t.end_us
    ops, host = [], []
    dev_type = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        b = a + e.duration_ns() / 1e3
        if e.device_type() == dev_type:
            if not e.is_user_annotation():
                ops.append((e.name(), a, b))
        elif e.duration_ns() > 0:
            host.append((e.name(), a, b))
    # the window's ends on the host clock against the device's operations:
    # the first iteration's lie before it, and none after its last synchronize
    tr.clock_check = {"ops_before_window": sum(b <= t0_us for _, _, b in ops),
                      "ops_after_window": sum(a >= t1_us for _, a, _ in ops)}
    tr.ops = [(n, max(a, t0_us), min(b, t1_us)) for n, a, b in ops if b > t0_us and a < t1_us]
    tr.spans = sorted((sp for sp in spans if sp[1] >= t0_us), key=lambda sp: sp[1])
    tr.host_ops = [h for h in host if h[2] > t0_us and h[1] < t1_us]
    tr.reduce_s = time.perf_counter() - t1


@contextmanager
def span(name: str):
    """A host span named ``portbench.<name>``, kept while a window is traced."""
    if _spans is None:
        yield
        return
    a = time.time_ns() / 1e3
    try:
        yield
    finally:
        _spans.append((SPAN + name, a, time.time_ns() / 1e3))
