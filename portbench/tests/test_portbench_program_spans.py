"""The program's spans against a synthetic trace (portbench/program_spans.py):
the launches are matched to the device's operations in order and each
operation goes to the innermost span open at its launch; the spans are
cut to the traced window; nothing is read where the launches and the
operations differ in number; the idle put down to spans plus "outside" is
the window's idle; the readers take a traced iteration's share."""

from __future__ import annotations

from collections import namedtuple

import pytest

from portbench import harness, program_spans
from portbench.program_spans import OUTSIDE, attribute, cut, launches
from portbench.trace import Trace, idle_share

S = namedtuple("S", "id name start_us end_us parent thread counts")


def _spans():
    """One iteration from 100 to 200 us: infer (100-160) with a stage
    (105-150) and two ops inside it, then triangulate (165-190)."""
    return [S(1, "serve.infer", 100.0, 160.0, 0, 7, {}),
            S(2, "trunk.stem", 105.0, 150.0, 1, 7, {}),
            S(3, "quant.im2col", 106.0, 110.0, 2, 7, {"bytes": 3_000_000}),
            S(4, "quant.int_mm", 111.0, 120.0, 2, 7, {"macs": 5}),
            S(5, "geometry.triangulate", 165.0, 190.0, 0, 7, {})]


def _trace(extra_launch=False):
    # (name, start, end); the runtime's launch with a driver call inside it
    host = [("cudaLaunchKernel", 107.0, 108.0), ("cuLaunchKernel", 107.2, 107.8),
            ("cudaMemcpyAsync", 112.0, 113.0), ("cudaStreamSynchronize", 113.0, 114.0),
            ("cudaLaunchKernelExC", 140.0, 141.0), ("cudaLaunchKernel", 170.0, 171.0)]
    if extra_launch:
        host.append(("cudaMemsetAsync", 180.0, 181.0))
    ops = [("im2col_copy", 110.0, 130.0), ("Memcpy HtoD", 130.0, 135.0),
           ("stage_kernel", 145.0, 155.0), ("tri_kernel", 175.0, 185.0)]
    return Trace(ops=ops, spans=[("portbench.request", 95.0, 200.0)], host_ops=host,
                 iterations=1, wall_s=110e-6)


def test_launches_counted_once_in_order():
    calls = launches(_trace().host_ops)
    assert [c[0] for c in calls] == ["cudaLaunchKernel", "cudaMemcpyAsync",
                                     "cudaLaunchKernelExC", "cudaLaunchKernel"]


def test_launch_order_attribution():
    att = attribute(_trace(), _spans())
    assert (att.launches, att.ops) == (4, 4)
    # the copy launched in im2col, the upload in int_mm, the stage's own
    # kernel in the stem, the last in triangulate
    assert att.device_us == {2: 20.0, 3: 5.0, 1: 10.0, 4: 10.0}
    assert att.under("trunk.stem") == [1, 2, 3]
    assert att.under("serve.infer") == [0, 1, 2, 3]


def test_window_cut():
    tr = _trace()
    early = S(9, "serve.infer", 10.0, 60.0, 0, 7, {})
    late = S(10, "serve.infer", 195.0, 205.0, 0, 7, {})
    assert cut([early] + _spans() + [late], tr) == _spans()
    assert cut(_spans(), Trace()) == []


def test_nothing_read_where_counts_differ():
    assert attribute(_trace(extra_launch=True), _spans()) is None
    assert attribute(_trace(), []) is None


def test_idle_conserved():
    tr = _trace()
    att = attribute(tr, _spans())
    # gaps 135-145 (middle 140: the stem), 155-175 (165: triangulate); the
    # window's ends 110 us - (185 - 110) us outside
    assert att.idle_us == {1: 10.0, 4: 20.0, OUTSIDE: 35.0}
    share = idle_share(harness.Record(kind="serve", cfg={}, cell={}, trace=tr))
    window_idle = share / 100 * 110.0
    assert sum(att.idle_us.values()) == pytest.approx(window_idle)
    # the tracer's buffer request held the host at 165: that gap goes outside
    tr.host_ops.append(("Activity Buffer Request", 160.0, 172.0))
    att = attribute(tr, _spans())
    assert att.idle_us == {1: 10.0, OUTSIDE: 55.0}
    assert sum(att.idle_us.values()) == pytest.approx(window_idle)


def test_per_iteration_readers(monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", _spans)
    rec = harness.Record(kind="serve", cfg={}, cell={}, trace=_trace())

    def read(name, what, kind="serve", r=rec):
        return program_spans.per_iteration(r, kind, name, what)

    assert read("quant.im2col", "device") == pytest.approx(0.02)
    assert read("trunk.stem", "device") == pytest.approx(0.035)
    assert read("quant.im2col", "bytes") == pytest.approx(3.0)
    assert read("serve.infer", "idle") == pytest.approx(0.01)
    assert read("geometry.triangulate", "idle") == pytest.approx(0.02)
    # another kind, a span the window lacks, an iteration count that differs
    assert read("train.forward", "device", kind="train") is None
    assert read("quant.requant", "device") is None
    rec2 = harness.Record(kind="serve", cfg={}, cell={}, trace=_trace())
    rec2.trace.iterations = 2
    assert read("quant.im2col", "device", r=rec2) is None
    # a program that records nothing
    monkeypatch.setattr(program_spans, "recorded", lambda: [])
    rec3 = harness.Record(kind="serve", cfg={}, cell={}, trace=_trace())
    assert read("quant.im2col", "device", r=rec3) is None
