#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``posetpu_torch`` beside it).
Phases, each of which fails the run on its own:

1. the card: ``nvidia-smi`` name and power limit; no CUDA device -> exit 1;
2. build every CUDA kernel from ``posetpu_torch/csrc`` (one nvcc per source,
   all started together), printing the build time and ptxas' report;
3. the main path at full width: ResNet-50, 256x256 input, 4 views, 16
   joints, 64x64 heatmaps, the S=4096 aggregation bank, random weights from
   a seed, calibrated on 2 batches; ``build_serving_pipeline`` then serves
   4 requests of 32 four-view groups (128 images) through prepare -> infer
   -> triangulate_points. The first request warms up; frames/s is over the
   last 3. Every kernel's launch count is set to 0 just before and read just
   after: each must have launched. One more request is timed in parts: the
   host packing, then infer + triangulate under torch.profiler (device time
   by kernel family, and the device's idle share);
4. each kernel against its plain PyTorch version on the card, on the inputs
   the main path gives it (taken from one more request): int8 and f32
   outputs must be equal. Timed with CUDA events (3 warm-up calls, median
   of 20): the kernel, its plain version, and for the aggregation the
   yardstick of 4 ``torch._int_mm`` calls on pre-gathered operands;
5. card vs CPU: one group (4 images) through the same port on
   ``device="cpu"`` with the same params: maxvals equal, preds within
   atol 1e-4 (the inverse affine's tiny matmul may round differently).

The last lines are the card line, one JSON object ``{"kernels": [...]}``
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA data sheet): int8 tensor cores and HBM3
PEAK_INT8_OPS = 1.979e15
PEAK_BYTES = 3.35e12

GROUPS, VIEWS, REQUESTS = 32, 4, 4


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def trained_like_(module, gen):
    """Seeded random weights with trained-like statistics (He-scaled trunk
    and deconv kernels, BN near identity), so activations are not
    degenerate as they are under the reference's N(0, 0.001) init. The
    head keeps that init; main() rescales it so heatmaps span [-1, 1], the
    range the aggregation's input scale (1.2 / 127) assumes."""
    import torch

    with torch.no_grad():
        for name, t in module.state_dict().items():
            if (name.endswith("num_batches_tracked") or name.startswith("aggre_layer")
                    or name.endswith("final_layer.weight")):
                continue
            r = torch.randn(t.shape, generator=gen)
            if t.dim() == 4:
                fan_in = t[0].numel() if "deconv" not in name else t.shape[0] * 4
                t.copy_(r * (2.0 / fan_in) ** 0.5)
            elif name.endswith("running_var"):
                t.copy_(1.0 + 0.05 * r.abs())
            elif name.endswith("weight"):  # BN scale
                t.copy_(1.0 + 0.1 * r)
            else:  # BN shift, running mean, conv bias
                t.copy_(0.1 * r)


@contextmanager
def capture_first_calls(targets):
    """Record the arguments of the first call of each (module, name) while
    the block runs; the calls still go through the real function."""
    seen, saved = {}, []
    for mod, name in targets:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapper(*a, _fn=fn, _name=name, **kw):
            seen.setdefault(_name, (a, kw))
            return _fn(*a, **kw)
        # a kernel wrapper counts its launches on its module-level name, which
        # points here meanwhile: those launches are not the main path's
        wrapper.launches = 0
        setattr(mod, name, wrapper)
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def cuda_ms(fn, warmup=3, reps=20):
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_request(fn) -> dict:
    """Device time of one call of ``fn`` by kernel family, from
    torch.profiler's CUDA activity, and the device's idle share of the
    call's wall time (host clock, ending in a synchronize)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(dev, "torch.profiler recorded no device activity")
    families = {"phase_conv (B1, B2)": ("phase_conv",), "phase_head (B1)": ("phase_head",),
                "aggregation (B3)": ("aggregation_kernel",),
                "int8 GEMM (trunk, torch._int_mm)": ("gemm", "Gemm", "cutlass", "xmma"),
                "memcpy/memset": ("Memcpy", "Memset")}
    by_family, by_name = {}, {}
    spans = []
    for e in dev:
        us = e.time_range.end - e.time_range.start
        spans.append((e.time_range.start, e.time_range.end))
        fam = next((f for f, keys in families.items() if any(k in e.name for k in keys)),
                   "other PyTorch kernels (im2col, epilogues, decode)")
        by_family[fam] = by_family.get(fam, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):  # union of device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "by_family_ms": {k: v / 1e3 for k, v in sorted(by_family.items(),
                                                           key=lambda kv: -kv[1])},
            "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top]}


def nbytes(*tensors) -> int:
    total = 0
    for t in tensors:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        else:
            total += t.numel() * t.element_size()
    return total


def bound(macs: float, nbytes_: float):
    """(least ms, "operations" | "bytes") at the published peaks."""
    t_ops, t_bytes = 2 * macs / PEAK_INT8_OPS * 1e3, nbytes_ / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    check((ROOT / "posetpu_torch" / "csrc").is_dir(),
          f"posetpu_torch/csrc not found beside {Path(__file__).name}: "
          f"run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    from posetpu_torch.config import default_config
    from posetpu_torch.data.synthetic import make_camera_ring, tile_cameras
    from posetpu_torch.geometry.triangulate import triangulate_points
    from posetpu_torch.models.multiview import get_multiview_pose_net
    from posetpu_torch.ops import _build
    from posetpu_torch.ops import aggregation as agg
    from posetpu_torch.ops import phase_tail as pt
    from posetpu_torch.serving import build_serving_pipeline, pack_hwcn

    # ------------------------------------------------------------ 1. the card
    card = card_line()
    dev = torch.device("cuda")
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ------------------------------------------------------------ 2. build
    sources = sorted(p.stem for p in (ROOT / "posetpu_torch" / "csrc").glob("*.cu"))
    secs = _build.build(sources)
    log(f"build: {sources} in {secs:.1f} s")
    for s in sources:
        for line in _build.build_log(s).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {s}: {line.strip()}")

    # ------------------------------------------------------------ 3. main path
    cfg = default_config()
    cfg.NETWORK.IMAGE_SIZE = np.array([256, 256])
    cfg.NETWORK.HEATMAP_SIZE = np.array([64, 64])
    cfg.NETWORK.AGGRE = True
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    model = get_multiview_pose_net(cfg, generator=gen)
    trained_like_(model, gen)
    model.eval()
    rs = np.random.RandomState(0)
    calib = [rs.randn(8, 256, 256, 3).astype(np.float32) for _ in range(2)]
    with torch.no_grad():  # heatmaps into the [-1, 1] range a trained head gives
        hm, _, _ = model.resnet(torch.from_numpy(calib[0][:1]))
        model.resnet.final_layer.weight.mul_(1.0 / float(hm.abs().max()))
    pipe = build_serving_pipeline(cfg, model, calib, device=dev)
    torch.cuda.synchronize()
    log(f"model + calibration + quantization: {time.perf_counter() - t0:.1f} s")

    images = rs.randint(0, 256, (GROUPS, VIEWS, 256, 256, 3)).astype(np.uint8)
    center = torch.full((GROUPS, VIEWS, 2), 500.0, device=dev)
    scale = torch.full((GROUPS, VIEWS, 2), 2.5, device=dev)
    is_h36m = torch.ones(GROUPS, device=dev)
    cams = tile_cameras(make_camera_ring(device=dev), GROUPS)
    wrappers = {"fused_subpixel_deconv_batched": pt.fused_subpixel_deconv_batched,
                "fused_phase_tail2": pt.fused_phase_tail2,
                "aggregation_grouped": agg.aggregation_grouped}

    def serve(x):
        preds, maxvals = pipe.infer(pipe.params, x, center, scale, is_h36m)
        return preds, maxvals, triangulate_points(preds, cams, (maxvals > 0.0).float())

    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(REQUESTS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        preds, maxvals, pts3d = serve(pipe.prepare(images))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for k, n in launches.items():
        check(n > 0, f"{k} never launched on the main path")
    check(tuple(preds.shape) == (GROUPS, VIEWS, 16, 2), f"preds {tuple(preds.shape)}")
    check(tuple(maxvals.shape) == (GROUPS, VIEWS, 16), f"maxvals {tuple(maxvals.shape)}")
    check(tuple(pts3d.shape) == (GROUPS, 16, 3), f"pts3d {tuple(pts3d.shape)}")
    for name, t in (("preds", preds), ("maxvals", maxvals), ("pts3d", pts3d)):
        check(bool(torch.isfinite(t).all()), f"non-finite {name}")
    check(float(maxvals.std()) > 0, "maxvals are constant")
    fps = 3 * GROUPS * VIEWS / sum(times[1:])
    log(f"main path: {REQUESTS} requests x {GROUPS * VIEWS} images, request s "
        f"{[round(t, 4) for t in times]}, {fps:.1f} frames/s over the last 3, "
        f"peak {peak_gib:.2f} GiB, launches {launches} | {card}")

    # where one request's time goes: host packing, then the device by kernel
    t = time.perf_counter()
    x = pipe.prepare(images)
    torch.cuda.synchronize()
    prepare_ms = (time.perf_counter() - t) * 1e3
    prof = profile_request(lambda: serve(x))
    log("profile: " + json.dumps({"prepare_ms": prepare_ms, **prof}))

    # one more request to take each kernel's inputs for phase 4 (serving.py
    # and quant.py look the kernels up on their modules at call time)
    with capture_first_calls([(pt, "fused_subpixel_deconv_batched"),
                              (pt, "fused_phase_tail2"),
                              (agg, "aggregation_grouped")]) as seen:
        serve(x)
    check(set(seen) == set(wrappers), f"kernels not reached on the path: "
          f"{set(wrappers) - set(seen)}")

    # ------------------------------------------------------------ 4. kernels
    results = []

    def compare(name, source, replaces, plain, args, kw, macs, nbytes_, library=None):
        kernel = lambda: wrappers[name](*args, **kw)
        ref_fn = lambda: plain(*args, **kw)
        got, ref = kernel(), ref_fn()
        torch.cuda.synchronize()
        check(got.dtype == ref.dtype and got.shape == ref.shape, f"{name}: shape/dtype")
        err = float((got.double() - ref.double()).abs().max())
        check(torch.equal(got, ref), f"{name}: kernel != plain (max abs err {err})")
        ms, plain_ms = cuda_ms(kernel), cuda_ms(ref_fn)
        lib_ms = None if library is None else cuda_ms(library)
        b_ms, b_by = bound(macs, nbytes_)
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        log(f"kernel {name}: equal to plain, {ms:.4f} ms (plain {plain_ms:.4f}, "
            f"library {lib_ms}, bound {b_ms:.4f} by {b_by}) | {card}")

    (x0, a0), kw0 = seen["fused_subpixel_deconv_batched"]
    n, hw, cin = x0.shape
    cout = a0["w"].shape[2]
    compare("fused_subpixel_deconv_batched", "posetpu_torch/csrc/phase_tail.cu",
            "posetpu/ops/pallas/phase_tail.py:609", pt.subpixel_deconv_plain,
            (x0, a0), kw0, 16 * n * hw * cout * cin,
            nbytes(x0, a0) + 4 * n * hw * cout)

    (x1, a1), kw1 = seen["fused_phase_tail2"]
    n, hw, cin = x1.shape
    cmid, cout, joints = a1["w1"].shape[2], a1["w2"].shape[2], a1["wh"].shape[0]
    macs1 = (16 * n * hw * cmid * cin + 16 * n * 4 * hw * cout * cmid
             + n * 16 * hw * joints * cout)
    compare("fused_phase_tail2", "posetpu_torch/csrc/phase_tail.cu",
            "posetpu/ops/pallas/phase_tail.py:384", pt.phase_tail2_plain,
            (x1, a1), kw1, macs1, nbytes(x1, a1) + 4 * joints * n * 16 * hw)

    (qagg, hm), kw3 = seen["aggregation_grouped"]
    j, ng, v, s = hm.shape
    # the library yardstick: per target one int8 GEMM [JN, 3S] x [3S, S] on
    # operands gathered beforehand (not timed)
    xq, _ = agg._quantize(qagg, hm)
    gathered = [torch.cat([xq[p] for p in range(4) if p != t], dim=1) for t in range(4)]
    bank_kn = [qagg["wq"][t].transpose(-1, -2).reshape(3 * s, s).contiguous()
               for t in range(4)]
    compare("aggregation_grouped", "posetpu_torch/csrc/aggregation.cu",
            "posetpu/ops/pallas/aggregation.py:148", agg.aggregation_grouped_plain,
            (qagg, hm), kw3, 4 * j * ng * 3 * s * s, nbytes(hm, qagg) + hm.numel() * 4,
            library=lambda: [torch._int_mm(gathered[t], bank_kn[t]) for t in range(4)])
    del gathered, bank_kn

    # ------------------------------------------------------------ 5. card vs CPU
    one = images[:1]
    x_cpu = pack_hwcn(torch.from_numpy(one.reshape(VIEWS, 256, 256, 3)))
    to_cpu = lambda t: ({k: to_cpu(u) for k, u in t.items()} if isinstance(t, dict)
                        else None if t is None else t.cpu())
    args_gpu = (center[:1], scale[:1], is_h36m[:1])
    p_gpu, m_gpu = pipe.infer(pipe.params, x_cpu.to(dev), *args_gpu)
    t = time.perf_counter()
    p_cpu, m_cpu = pipe.infer(to_cpu(pipe.params), x_cpu, *[a.cpu() for a in args_gpu])
    check(torch.equal(m_gpu.cpu(), m_cpu), "card vs CPU: maxvals differ (max "
          f"{float((m_gpu.cpu() - m_cpu).abs().max())})")
    perr = float((p_gpu.cpu() - p_cpu).abs().max())
    check(perr <= 1e-4, f"card vs CPU: preds differ by {perr}")
    log(f"card vs CPU on one group: maxvals equal, preds max abs diff {perr} "
        f"(CPU run {time.perf_counter() - t:.1f} s)")

    log(card)
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
