"""The port's own spans and counts (utils/profiling.py) on the CPU.

- with no profiler session a span records nothing and is one shared null
  context;
- the int8 serving pipeline (ResNet-18 at 64x64, 16x16 maps, the bank) and
  the supervised train step give bit-identical outputs with recording on
  and off;
- on, a request's and a step's spans have the names and parents the
  benchmark's readers look for, every trunk operation under its stage;
- the im2col spans count the bytes and the int8 GEMM spans the
  multiply-accumulates that the convolutions' shapes give, the requantize
  spans the bytes they read and write;
- ``trace`` writes ``trace.json`` and ``spans.json``;
- device time and idle gaps are put down to the innermost span open when
  the host launched the operation (at the gap's middle), the rest and the
  tracer's own pauses outside, and nothing is lost.
"""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from posetpu_torch.config import default_config
from posetpu_torch.geometry.cameras import CameraParams
from posetpu_torch.geometry.triangulate import triangulate_points
from posetpu_torch.models.multiview import MultiViewPose
from posetpu_torch.models.pose_resnet import PoseResNet
from posetpu_torch.serving import build_serving_pipeline
from posetpu_torch.train.optim import make_optimizer
from posetpu_torch.train.step import init_train_state, make_train_step
from posetpu_torch.utils import profiling
from posetpu_torch.utils.profiling import Span

N, V, J = 2, 4, 16
STAGES = ("trunk.stem", "trunk.layer1", "trunk.layer2", "trunk.layer3", "trunk.layer4")
REQUEST = ("serve.u8_affine",) + STAGES + ("trunk.deconv0", "trunk.tail", "serve.fuse",
                                           "serve.decode")
OPS = {"quant.im2col", "quant.int_mm", "quant.requant"}


def _cfg():
    cfg = default_config()
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.NETWORK.IMAGE_SIZE = np.array([64, 64])
    cfg.NETWORK.HEATMAP_SIZE = np.array([16, 16])
    cfg.NETWORK.NUM_JOINTS = J
    cfg.NETWORK.AGGRE = True
    return cfg


@pytest.fixture(scope="module")
def served():
    torch.manual_seed(0)
    rng = np.random.RandomState(0)
    model = MultiViewPose(PoseResNet(num_layers=18), heatmap_size=16).eval()
    calib = [torch.from_numpy(rng.randn(4, 64, 64, 3).astype(np.float32))]
    pipe = build_serving_pipeline(_cfg(), model, calib, device="cpu")
    request = {"images": rng.randint(0, 256, (N, V, 64, 64, 3)).astype(np.uint8),
               "center": torch.from_numpy((100 + 50 * rng.rand(N, V, 2)).astype(np.float32)),
               "scale": torch.from_numpy((1 + rng.rand(N, V, 2)).astype(np.float32)),
               "is_h36m": torch.tensor([1.0, 0.0])}
    cams = CameraParams(*(torch.from_numpy(a) for a in (
        np.tile(np.eye(3, dtype=np.float32), (N, V, 1, 1)),
        (rng.randn(N, V, 3) * 100 - [0.0, 0.0, 5000.0]).astype(np.float32),
        np.full((N, V, 2), 1000.0, np.float32), np.full((N, V, 2), 500.0, np.float32),
        np.zeros((N, V, 3), np.float32), np.zeros((N, V, 2), np.float32))))
    return pipe, request, cams


def _serve(pipe, request, cams):
    x = pipe.prepare(request["images"])
    preds, maxvals = pipe.infer(pipe.params, x, request["center"], request["scale"],
                                request["is_h36m"])
    return preds, maxvals, triangulate_points(preds, cams, (maxvals > 0).float())


def _tree(spans):
    """[(name, parent's name or None)] in the order the spans opened."""
    by_id = {s.id: s for s in spans}
    return [(s.name, by_id[s.parent].name if s.parent in by_id else None)
            for s in sorted(spans, key=lambda s: s.start_us)]


def _session_spans(fn):
    """fn()'s result and the spans it recorded inside a bare profiler
    session, which turns recording on."""
    from torch.profiler import ProfilerActivity, profile

    before = {s.id for s in profiling.recorded()}
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, [s for s in profiling.recorded() if s.id not in before]


def test_recording_off_records_nothing(served):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("a") is profiling.span("b", bytes=3)
    before = profiling.recorded()
    _serve(*served)
    assert profiling.recorded() == before


def test_serving_outputs_equal_and_request_tree(served):
    pipe, request, cams = served
    off = _serve(pipe, request, cams)
    on, spans = _session_spans(lambda: _serve(pipe, request, cams))
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    tree = _tree(spans)
    assert [n for n, p in tree if p is None] == ["serve.prepare", "serve.infer",
                                                 "geometry.triangulate"]
    assert [n for n, p in tree if p == "serve.infer"] == list(REQUEST)
    under = {}
    for n, p in tree:
        under.setdefault(p, set()).add(n)
    for stage in STAGES:
        assert under[stage] == OPS, stage
    for leaf in ("trunk.deconv0", "trunk.tail", "serve.u8_affine", "serve.fuse",
                 "serve.decode", "geometry.triangulate", "serve.prepare") + tuple(OPS):
        assert leaf not in under, leaf
    prepare = next(s for s in spans if s.name == "serve.prepare")
    assert prepare.counts == {"bytes": request["images"].nbytes}


def _r18_convs():
    """(H, W, C in, kernel, stride, pad, C out) of each int8 GEMM of the
    serving trunk at 64x64, in the order it runs: the space-to-depth stem
    (the 7x7/s2 kernel as 4x4/s1 over 12 channels, padding (2, 1)), then
    each basic block's conv1, downsample and conv2 (the last, requantized
    with the residual)."""
    convs = [(32, 32, 12, 4, 1, (2, 1), 64)]
    h, c = 16, 64
    for planes in (64, 128, 256, 512):
        for b in range(2):
            stride = 2 if (b == 0 and planes != 64) else 1
            convs.append((h, h, c, 3, stride, (1, 1), planes))
            if stride == 2:
                convs.append((h, h, c, 1, 2, (0, 0), planes))
            ho = h // stride
            convs.append((ho, ho, planes, 3, 1, (1, 1), planes))
            h, c = ho, planes
    return convs


def test_im2col_bytes_and_int_mm_macs_from_shapes(served):
    _, spans = _session_spans(lambda: _serve(*served))
    spans = sorted(spans, key=lambda s: s.start_us)
    got_bytes = [s.counts["bytes"] for s in spans if s.name == "quant.im2col"]
    got_macs = [s.counts["macs"] for s in spans if s.name == "quant.int_mm"]
    nv = N * V
    want_bytes, want_macs = [], []
    for h, w, c, k, stride, (p0, p1), o in _r18_convs():
        ho, wo = (h + p0 + p1 - k) // stride + 1, (w + p0 + p1 - k) // stride + 1
        padded = nv * (h + p0 + p1) * (w + p0 + p1) * c if p0 + p1 else 0
        cols = nv * ho * wo * k * k * c if (k > 1 or stride > 1) else 0
        want_bytes.append(padded + cols)
        want_macs.append(nv * ho * wo * k * k * c * o)
    assert got_bytes == want_bytes
    assert got_macs == want_macs


def test_requant_bytes_from_shapes(served):
    """Each requantize site counts the int32 sums it reads (4 bytes an
    output element), the int8 it writes (1) and, at a block's tail, the int8
    residual it reads (1): the stem, then each block's conv1, its downsample
    and its tail (conv2 with the residual), in the order they run."""
    _, spans = _session_spans(lambda: _serve(*served))
    got = [s.counts["bytes"] for s in sorted(spans, key=lambda s: s.start_us)
           if s.name == "quant.requant"]
    nv = N * V

    def out(h, w, c, k, stride, pad, o):
        return nv * ((h + sum(pad) - k) // stride + 1) * ((w + sum(pad) - k) // stride + 1) * o

    convs = _r18_convs()
    want, i = [5 * out(*convs[0])], 1
    while i < len(convs):
        block = convs[i:i + (3 if convs[i + 1][3] == 1 else 2)]  # a 1x1: the downsample
        want += [5 * out(*cv) for cv in block[:-1]] + [6 * out(*block[-1])]
        i += len(block)
    assert len(got) == 20 and got == want


def _train_batch(rng):
    return {"images": torch.from_numpy(rng.randn(N, V, 64, 64, 3).astype(np.float32)),
            "target": torch.from_numpy(rng.rand(N, V, 16, 16, J).astype(np.float32)),
            "weight": torch.ones(N, V, J), "is_h36m": torch.tensor([1.0, 0.0]),
            "center": torch.full((N, V, 2), 500.0), "scale": torch.full((N, V, 2), 2.0)}


@pytest.mark.parametrize("watch_grad", [False, True])
def test_train_step_outputs_equal_and_step_tree(watch_grad):
    cfg = _cfg()
    cfg.LOSS.USE_CONSISTENT_LOSS = True
    cfg.LOSS.WATCH_GRAD_NORM = watch_grad
    torch.manual_seed(0)
    model = MultiViewPose(PoseResNet(num_layers=18), heatmap_size=16)
    batch = _train_batch(np.random.RandomState(1))
    runs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU's threaded backward sums in no fixed order
    try:
        for on in (False, True):
            net = copy.deepcopy(model)
            tx = make_optimizer(cfg, 10)
            state = init_train_state(net, tx, device="cpu")
            step = make_train_step(net, cfg, tx, device="cpu")
            if on:
                (state, metrics), spans = _session_spans(lambda: step(state, batch))
            else:
                state, metrics = step(state, batch)
            runs.append((metrics, net.state_dict()))
    finally:
        torch.set_num_threads(threads)
    (m_off, sd_off), (m_on, sd_on) = runs
    assert m_off.keys() == m_on.keys()
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for k in sd_off:
        assert torch.equal(sd_off[k], sd_on[k]), k
    tree = _tree(spans)
    assert [n for n, p in tree if p is None] == ["train.step"]
    phases = ["train.forward", "train.loss", "train.backward"]
    phases += ["train.grad_probe"] if watch_grad else []
    assert [n for n, p in tree if p == "train.step"] == phases + ["train.optimizer",
                                                                 "train.metrics"]


def test_trace_writes_trace_and_spans(tmp_path, served):
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer", items=2):
            _serve(*served)
    assert json.load(open(tmp_path / "trace.json"))["traceEvents"]
    table = json.load(open(tmp_path / "spans.json"))
    names = table["by_name"]
    assert names["outer"]["calls"] == 1 and names["outer"]["counts"] == {"items": 2}
    assert names["serve.infer"]["calls"] == 1 and names["quant.int_mm"]["calls"] == 20
    assert names["quant.int_mm"]["counts"]["macs"] > 0
    outer = next(r for r in table["spans"] if r["name"] == "outer")
    children = sum(r["host_ms"] for r in table["spans"] if r["parent"] == outer["id"])
    assert outer["self_ms"] == pytest.approx(outer["host_ms"] - children)
    # no device on the CPU: nothing put down to a span
    assert table["outside"] is None and outer["device_ms"] is None


def _span(i, name, a, b, parent=0):
    return Span(i, name, a, b, parent, 1, {})


def test_device_and_idle_put_down_to_innermost_spans():
    spans = [_span(1, "step", 0.0, 100.0), _span(2, "forward", 10.0, 40.0, 1),
             _span(3, "optimizer", 60.0, 90.0, 1)]
    # (launch, start, end): launched in forward, in step alone, in optimizer,
    # and one after every span closed
    ops = [(12.0, 20.0, 30.0), (45.0, 50.0, 55.0), (61.0, 70.0, 80.0), (102.0, 103.0, 105.0)]
    device, idle = profiling.attribute(spans, ops, wall_us=110.0)
    assert device == {1: 10.0, 0: 5.0, 2: 10.0, -1: 2.0}
    # gaps 30-50 (middle 40: forward), 55-70 (62.5: optimizer), 80-103
    # (91.5: step alone); the window's ends 0-20 and 105-110 outside
    assert idle == {1: 20.0, 2: 15.0, 0: 23.0, -1: 25.0}
    busy = sum(b - a for _, a, b in ops)
    assert sum(idle.values()) == pytest.approx(110.0 - busy)
    assert sum(device.values()) == pytest.approx(busy)
    # the tracer held the host at 91.5: that gap goes outside
    _, idle = profiling.attribute(spans, ops, wall_us=110.0, tracer=[(85.0, 100.0)])
    assert idle == {1: 20.0, 2: 15.0, -1: 48.0}
    table = profiling.span_table(spans, ops, 110.0)
    assert table["outside"] == {"device_ms": pytest.approx(0.002), "idle_ms": pytest.approx(0.025)}
    step = table["by_name"]["step"]
    assert step["self_ms"] == pytest.approx((100.0 - 30.0 - 30.0) / 1e3)
