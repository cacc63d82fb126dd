"""The traced window's reduction on the CPU: the benchmark's spans are
kept only while a window is traced, on the profiler's time base; the busy
time is the union of the device's intervals; the idle share is what
``busy_s`` and ``window_s`` give; an idle gap is labelled by the host's
span and the operation launched next."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from portbench import trace
from portbench.trace import Trace, span, traced


def test_spans_are_kept_only_inside_a_traced_window():
    with span("outside"):
        pass
    with traced(2, torch.device("cpu")) as t:
        for _ in range(3):
            with span("step"):
                torch.ones(64).sum()
            t.tick()
    tr = t.trace
    assert trace._spans is None
    # the first iteration warms the profiler up and is left out
    assert [n for n, _, _ in tr.spans] == ["portbench.step"] * 2
    assert tr.wall_s > 0
    now_us = time.time_ns() / 1e3
    assert all(0 < now_us - a < 60e6 for _, a, _ in tr.spans)


def test_busy_idle_and_gap_labels():
    tr = Trace(ops=[("k1", 0.0, 40.0), ("k2", 20.0, 60.0), ("k3", 80.0, 90.0)],
               spans=[("portbench.step", -1.0, 100.0), ("portbench.infer", 55.0, 85.0)],
               iterations=1, wall_s=100e-6)
    assert tr.busy_us() == pytest.approx(70.0)
    assert trace.idle_share(SimpleNamespace(trace=tr)) == pytest.approx(30.0)
    assert tr.gaps() == [(60.0, 80.0)]
    assert tr.breakdown()["idle_gaps"] == [["portbench.infer / host before k3",
                                            pytest.approx(20e-6)]]
    assert trace.idle_share(SimpleNamespace(trace=None)) is None
