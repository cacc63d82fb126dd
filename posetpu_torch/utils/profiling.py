"""Tracing and step timing.

The reference's observability is wall-clock AverageMeters and GPU memory in
the log line (lib/core/function.py:93-96, 471-487). Here:

* :func:`span`: the program's own spans, recorded only while a
  ``torch.profiler`` session runs (PyTorch's own flag, so :func:`trace` and
  any other session turn them on). A span keeps its name, its host start
  and end on ``time.time_ns``'s clock in microseconds (the profiler's time
  base, so the device trace lines up with it), the span open around it on
  its thread, the thread, and integer counts; :func:`recorded` returns the
  last :data:`SPANS_KEPT`. Off, a span is one flag test that returns a
  shared null context;
* :func:`trace`: a ``torch.profiler`` session (CUDA activity on a GPU, the
  host's operators elsewhere) written as a Chrome trace, and the spans of
  the session with the device time and idle time put down to each;
* :class:`StepTimer`: the loop's step and data times. It waits for the
  device only where the caller hands it a value to fetch (the loop does so
  on its logging steps), so between them the host runs ahead of the card.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

SPANS_KEPT = 1 << 16
# the runtime and driver calls that put an operation on a stream
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")
# the tracer's own pause on the host, collecting the device's records
TRACER = "Activity Buffer Request"


class Span(NamedTuple):
    """A closed span: ``start_us`` and ``end_us`` on ``time.time_ns``'s
    clock; ``parent`` the id of the span open around it on its thread (0:
    none); ``thread`` the native thread id; ``counts`` its integer counts."""

    id: int
    name: str
    start_us: float
    end_us: float
    parent: int
    thread: int
    counts: dict


_kept: collections.deque = collections.deque(maxlen=SPANS_KEPT)
_ids = itertools.count(1)
_open = threading.local()  # .stack: the ids of the thread's open spans
_NULL = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "counts", "id", "parent", "start", "_rf")

    def __init__(self, name, counts):
        self.name, self.counts = name, counts

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        # PyTorch's fast record_function: about 1 us on the host against
        # record_function's 10 (a few hundred spans a request)
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._rf.__exit__(*exc)
        _open.stack.pop()
        _kept.append(Span(self.id, self.name, self.start / 1e3, end / 1e3, self.parent,
                          threading.get_native_id(), self.counts))
        return False


def span(name: str, **counts: int):
    """``with span("quant.im2col", bytes=n): ...`` records the block while a
    profiler session runs (and opens a profiler range of its name, so a
    trace that records host operators shows it); otherwise returns a shared
    null context and records nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return _Recording(name, counts)
    return _NULL


def recorded() -> list[Span]:
    """The last :data:`SPANS_KEPT` spans closed, in the order they closed."""
    return list(_kept)


def innermost(spans, times) -> list[int]:
    """For each of the ascending ``times`` (us), the index in ``spans`` of
    the innermost span open then (the latest to start), or -1."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i].start_us, -spans[i].end_us))
    out, active, k = [], [], 0
    for t in times:
        while k < len(order) and spans[order[k]].start_us <= t:
            active.append(order[k])
            k += 1
        active = [i for i in active if spans[i].end_us >= t]
        out.append(active[-1] if active else -1)
    return out


def attribute(spans, ops, wall_us, tracer=()):
    """Put the device's time down to ``spans``. ``ops``: the device
    operations of a window [(launch us, start us, end us)], the launch on
    the host's clock; ``wall_us``: the window's length, which starts and
    ends with the device idle; ``tracer``: [(start us, end us)] in which the
    tracer held the host. An operation goes to the innermost span open when
    the host launched it, an idle gap between two operations to the
    innermost span open at its middle unless the tracer held the host then;
    the rest ("outside" = index -1) covers what no span holds, the tracer's
    pauses and the window's idle ends. Returns ({index: device us},
    {index: idle us})."""
    device, idle = collections.defaultdict(float), collections.defaultdict(float)
    ops = sorted(ops, key=lambda o: o[1])
    launches = sorted(range(len(ops)), key=lambda i: ops[i][0])
    for i, s in zip(launches, innermost(spans, [ops[i][0] for i in launches])):
        device[s] += ops[i][2] - ops[i][1]
    gaps, end, busy = [], None, 0.0
    for _, a, b in ops:
        if end is not None and a > end:
            gaps.append((end, a))
        if end is None or b > end:
            busy += b - (a if end is None else max(a, end))
            end = b
    for s, (a, b) in zip(innermost(spans, [(a + b) / 2 for a, b in gaps]), gaps):
        held = any(c <= (a + b) / 2 <= d for c, d in tracer)
        idle[-1 if held else s] += b - a
    idle[-1] += wall_us - busy - sum(b - a for a, b in gaps)
    return dict(device), dict(idle)


def span_table(spans, ops=None, wall_us=None, tracer=()) -> dict:
    """Each span with its host and self ms, counts, and with ``ops`` (see
    :func:`attribute`) the device ms and idle ms put down to it; the same
    summed by name; and what went outside every span."""
    by_id = {s.id: k for k, s in enumerate(spans)}
    child_us = collections.defaultdict(float)
    for s in spans:
        if s.parent in by_id:
            child_us[by_id[s.parent]] += s.end_us - s.start_us
    device = idle = None
    if ops is not None:
        device, idle = attribute(spans, ops, wall_us, tracer)
    rows, names = [], {}
    for k, s in enumerate(spans):
        host = (s.end_us - s.start_us) / 1e3
        row = {"id": s.id, "name": s.name, "parent": s.parent, "thread": s.thread,
               "start_us": s.start_us, "host_ms": host, "self_ms": host - child_us[k] / 1e3,
               "counts": s.counts,
               "device_ms": None if device is None else device.get(k, 0.0) / 1e3,
               "idle_ms": None if idle is None else idle.get(k, 0.0) / 1e3}
        rows.append(row)
        agg = names.setdefault(s.name, {"calls": 0, "host_ms": 0.0, "self_ms": 0.0,
                                        "device_ms": 0.0, "idle_ms": 0.0, "counts": {}})
        agg["calls"] += 1
        for key in ("host_ms", "self_ms", "device_ms", "idle_ms"):
            agg[key] += row[key] or 0.0
        for key, n in s.counts.items():
            agg["counts"][key] = agg["counts"].get(key, 0) + n
    outside = None if device is None else {"device_ms": device.get(-1, 0.0) / 1e3,
                                            "idle_ms": idle.get(-1, 0.0) / 1e3}
    return {"window_ms": None if wall_us is None else wall_us / 1e3,
            "device_ops": None if ops is None else len(ops),
            "outside": outside, "by_name": names, "spans": rows}


def _device_ops(prof, t0_us, t1_us):
    """[(launch us, start us, end us)] of the session's device operations,
    each matched to the runtime call that launched it by correlation id;
    the number left unmatched (left out); the tracer's pauses."""
    launch_at, ops, tracer = {}, [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                ops.append((e.correlation_id(), a, a + e.duration_ns() / 1e3))
        elif e.name().startswith(LAUNCHES):
            launch_at[e.correlation_id()] = a
        elif e.name() == TRACER:
            tracer.append((a, a + e.duration_ns() / 1e3))
    kept = [(launch_at[c], max(a, t0_us), min(b, t1_us)) for c, a, b in ops
            if c in launch_at and b > t0_us and a < t1_us]
    return kept, len(ops) - len(kept), tracer


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a span of work: ``with trace(dir): run_steps()`` writes
    ``<dir>/trace.json`` (chrome://tracing, Perfetto) and
    ``<dir>/spans.json``: the program's spans of the session (see
    :func:`span_table`), on a GPU with the device ms and idle ms each
    caused. On a GPU only the CUDA activity is recorded (the device's
    operations and the runtime's calls): recording every host operator
    slows the host enough to idle the card several times as much."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    os.makedirs(log_dir, exist_ok=True)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.time_ns() / 1e3
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    t1 = time.time_ns() / 1e3
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    spans = [s for s in recorded() if s.start_us >= t0 and s.end_us <= t1]
    if cuda:
        ops, unmatched, tracer = _device_ops(prof, t0, t1)
        table = span_table(spans, ops, t1 - t0, tracer)
        table["unmatched_ops"] = unmatched
    else:
        table = span_table(spans)
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(table, f, indent=1)


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
