#!/usr/bin/env python3
"""Check and time the port's redesigned kernels on one NVIDIA GPU.

    python3 tools/torch_kernel_sweep.py check        # build, ptxas, kernel == plain
    python3 tools/torch_kernel_sweep.py sweep        # B8a: ms per layer and per th
    python3 tools/torch_kernel_sweep.py v2           # B8b: every form and ring, beside B8a
    python3 tools/torch_kernel_sweep.py decode       # B7: device, wrapper, host split
    python3 tools/torch_kernel_sweep.py imma         # mma.sync and wgmma int8 rates
    python3 tools/torch_kernel_sweep.py tail2        # B1, B5: per launch and ring shape
    python3 tools/torch_kernel_sweep.py agg          # B3, B4: quantize, GEMM, rings
    python3 tools/torch_kernel_sweep.py deconv       # B9a, B9b, B2, B6: designs, rings, sets
    python3 tools/torch_kernel_sweep.py requant      # the trunk's requantize, site by site

``check`` builds ``csrc/resblock.cu`` and ``csrc/decode.cu``, prints ptxas'
register report and holds B8a (``ops/resblock.fused_bottleneck``) equal to
its plain version on ResNet-50's five stride-1 block shapes at 256x256 input
and on ragged shapes, and B7 equal on edge cases. ``sweep`` times B8a at 128
images on each shape for every row-tile height ``th`` that fits (CUDA events,
median of 20 after 3 warm-ups) with the blocks per SM the card reports.
``v2`` times B8b (``ops/resblock.fused_bottleneck_v2``) at 128 images on
ResNet-50's identity block shapes at 256x256 input and layer4's at 320x320
and 384x384 (10x10, 12x12), in every tile form (``plan_v2``: "tile",
"split") and ring (stages x weight images a stage) that fits, each held
equal to the plain version, beside B8a on the same input and
``torch._int_mm`` on the block's products gathered beforehand, with the
blocks per SM the card reports and back-to-back device time a call; then
where the planned block's cycles go (the clock64 counters of the kernel's
timed instance, ``V2_CLOCK_SLOTS``, as shares of a warpgroup's cycles).
``decode`` times B7 at 512 and 2,048 maps of 64x64: the kernel alone on the
device (torch.profiler's kernel time, and events around 50 back-to-back
launches), the wrapper, ``torch.max``
over the same maps, and the wrapper's host time term by term
(``time.perf_counter`` loops of 2,000 calls with the launch stubbed out).
``imma`` builds ``tools/imma_rate.cu`` with nvcc into ``build/`` and runs it:
the TOP/s the card reaches with ``mma.sync.m16n8k32.s8`` and with
``wgmma.m64n128k32.s8`` when nothing but the instruction is in the loop.
``tail2`` times B1 at 128 images of 16x16 at C = 256, J = 16: deconv1 and
deconv2 + head alone for each ring depth (each held equal to its plain
version), the wrapper, and the device time by kernel from torch.profiler;
then B5 (B1's deconv2 + head instance with the levels=1 store) on deconv1's
output at 32 and 128 images of 32x32: each ring depth, the wrapper and its
device time. ``agg`` times B3 at J*N = 512, S = 4096: the quantize
pass and the GEMM alone, the wrapper, the plain quantize, ``torch._int_mm``
on pre-gathered operands, and the kernels' device time by torch.profiler;
then B4 at the same shape on a random 4-bit bank: its kernel alone on the
quantised planes at every ring depth that fits, and the wrapper, each held
equal to its plain version, ``torch._int_mm`` on the bank widened to int8,
and the device time by kernel.
``deconv`` times B9a and B9b at path 5's shapes, 128 images: deconv0 (8x8,
2048 -> 256) on the streamed halo (its planes through the ring) for every
ring depth the planner allows and 1, 2, 4 or 8 (phase, n-half) pairs a block
(the pixels a block are fixed at 128: two images, one a warpgroup), deconv1
(16x16, 256 -> 256) and deconv2 + head (32x32, 256 -> 256 -> 16) on the
resident halo for each ring depth, every launch held equal to its plain
version; then the two wrappers, ``torch._int_mm`` on the pre-gathered
phase operands (the GEMMs alone), and the device time by kernel. Then B2
(``fused_subpixel_deconv_batched``, tail2_kernel's phase-major instance on
the streamed halo) at 128 and 256 images of deconv0's 8x8, 2048 -> 256: every
ring depth for 1, 2, 4 or 8 (phase, n-half) pairs a block, each launch held
equal to its plain version, then its wrapper and the device time by kernel;
then B6 (the same launch with the N-minor store) at 32 and 128 images: 1, 2,
4 or 8 pairs a block at rings 4 and 7, and its wrapper beside B2's on the same
input. ``requant`` times the int8 trunk's requantize kernel
(``ops/requant.requant``) at each distinct site of a serving request
(ResNet-50 at 256x256, 128 images): back-to-back device time a call, the
plain passes it replaced, and GB/s by the bytes the site must move (the
int32 sums and any residual read, the int8 written), each held equal to its
plain version; then the request's 53 sites summed against 3.35 TB/s. Inputs are random from a seed; nothing is read from disk. Every line of
numbers ends with the card's name and power limit.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from posetpu_torch.ops import _build  # noqa: E402
from posetpu_torch.ops import aggregation as agg  # noqa: E402
from posetpu_torch.ops import decode as dec  # noqa: E402
from posetpu_torch.ops import deconv as dcv  # noqa: E402
from posetpu_torch.ops import phase_tail as pt  # noqa: E402
from posetpu_torch.ops import requant as rq  # noqa: E402
from posetpu_torch.ops import resblock as rb  # noqa: E402
from posetpu_torch.ops.heatmap import decode_heatmaps  # noqa: E402
from chip_smoke import phase_gemms  # noqa: E402

# ResNet-50's stride-1 bottlenecks at 256x256 input: h, w, Cin, Cm, Cout, projection
LAYERS = {"layer1_0": (64, 64, 64, 64, 256, True),
          "layer1_1": (64, 64, 256, 64, 256, False),
          "layer2_1": (32, 32, 512, 128, 512, False),
          "layer3_1": (16, 16, 1024, 256, 1024, False),
          "layer4_1": (8, 8, 2048, 512, 2048, False)}
RAGGED = {"7x9 c32": (7, 9, 32, 32, 32, False),
          "5x6 c96 wd": (5, 6, 96, 32, 40, True),
          "10x10 c64": (10, 10, 64, 96, 64, False),
          "3x130 c64": (3, 130, 64, 64, 64, False),
          "9x7 c160 wd": (9, 7, 160, 160, 264, True)}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=3, reps=20):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def burst_ms(fn, k=20):
    """Milliseconds a call over ``k`` back-to-back calls between two CUDA
    events: the host enqueues ahead of the card, so this is the device's
    time a call without the launch gaps of a lone call."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(k):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / k


def block_inputs(rs, n, h, w, cin, cm, cout, wd, dev):
    """Random block input and kernel arguments whose requants neither
    saturate nor vanish (scales ~ 40 / the sums' spread)."""
    def vec(c, k):
        return np.stack([(rs.uniform(0.5, 1.5, c) / (135.0 * np.sqrt(k))),
                         rs.uniform(-2, 2, c)]).astype(np.float32)

    args = {"w1": rs.randint(-127, 128, (cin, cm)).astype(np.int8),
            "w2": rs.randint(-127, 128, (9, cm, cm)).astype(np.int8),
            "w3": rs.randint(-127, 128, (cm, cout)).astype(np.int8),
            "v1": vec(cm, cin), "v2": vec(cm, 9 * cm), "v3": vec(cout, cm),
            "vr": np.stack([rs.uniform(0.5, 1.5, cout), rs.uniform(-1, 1, cout)]
                           ).astype(np.float32)}
    if wd:
        args["wd"] = rs.randint(-127, 128, (cin, cout)).astype(np.int8)
        args["vd"] = vec(cout, cin)
    x = torch.from_numpy(rs.randint(0, 128, (n, h * w, cin)).astype(np.int8)).to(dev)
    return x, rb.bottleneck_device_args(args, dev)


def ptxas(names):
    print(f"build: {_build.build(names):.1f} s")
    for s in names:
        for line in _build.build_log(s).splitlines():
            if "registers" in line or "spill" in line or "error" in line or "warning" in line:
                print(f"  ptxas {s}: {line.strip()}")


def check(dev):
    ptxas(["resblock", "decode"])
    rs = np.random.RandomState(0)
    for name, (h, w, cin, cm, cout, wd) in {**RAGGED, **LAYERS}.items():
        n = 3
        x, a = block_inputs(rs, n, h, w, cin, cm, cout, wd, dev)
        ref = rb.bottleneck_plain(x, a, h=h, w=w)
        for th in sorted({1, 2, rb.plan_rows(h, w, cin, cm, cout, wd).th, min(h, 5)}):
            try:
                rb.plan_rows(h, w, cin, cm, cout, wd, th)
            except ValueError:
                continue
            got = rb._launch_rows(x, a, h, w, th)
            torch.cuda.synchronize()
            bad = int((got != ref).sum())
            print(f"B8a {name} n={n} th={th}: {'equal' if not bad else f'{bad} DIFFER'} "
                  f"(nonzero share {float((ref != 0).float().mean()):.2f})", flush=True)
    # B7
    g = torch.Generator().manual_seed(0)
    cases = {"512 maps": torch.randn(8, 4, 16, 64, 64, generator=g),
             "7 maps (ragged block)": torch.randn(7, 64, 64, generator=g),
             "H*W % 4 != 0": torch.randn(5, 7, 9, generator=g),
             "ties": torch.zeros(6, 8, 8).index_fill_(2, torch.tensor([3, 5]), 1.0),
             "all negative": -torch.rand(3, 16, 16, generator=g) - 0.1,
             "all NaN": torch.full((2, 8, 8), float("nan"))}
    for name, hm in cases.items():
        hm = hm.to(dev)
        got, ref = dec.decode_heatmaps_kernel(hm), decode_heatmaps(hm)
        same = all(torch.equal(a, b) or (name == "all NaN" and a.shape == b.shape)
                   for a, b in zip(got, ref))
        print(f"B7 {name}: {'equal' if same else 'DIFFER'}")
    off = torch.randn(4 * 64 * 64 + 1, generator=g).to(dev)[1:].reshape(4, 64, 64)
    got, ref = dec.decode_heatmaps_kernel(off), decode_heatmaps(off)
    print(f"B7 unaligned view: {'equal' if all(torch.equal(a, b) for a, b in zip(got, ref)) else 'DIFFER'}")


def sweep(dev, n=128):
    ptxas(["resblock"])
    rs = np.random.RandomState(0)
    for name, (h, w, cin, cm, cout, wd) in LAYERS.items():
        x, a = block_inputs(rs, n, h, w, cin, cm, cout, wd, dev)
        ref = rb.bottleneck_plain(x, a, h=h, w=w)
        chosen = rb.plan_rows(h, w, cin, cm, cout, wd).th
        for th in range(1, h + 1):
            if h % th and th not in (3, 5, 6):
                continue
            try:
                plan = rb.plan_rows(h, w, cin, cm, cout, wd, th)
            except ValueError:
                continue
            got = rb._launch_rows(x, a, h, w, th)
            ok = torch.equal(got, ref)
            ms = cuda_ms(lambda: rb._launch_rows(x, a, h, w, th))
            print(f"B8a {name} th={th}{' (planned)' if th == chosen else ''}: {ms:.4f} ms, "
                  f"{'equal' if ok else 'DIFFERS'}, smem {plan.smem}, blocks/SM "
                  f"{rb.rows_blocks_per_sm(cm, plan.smem)}, grid {-(-h // th) * n} | {card()}",
                  flush=True)


V2_LAYERS = {"layer1_1": (64, 64, 256, 64), "layer2_1": (32, 32, 512, 128),
             "layer3_1": (16, 16, 1024, 256), "layer4_1": (8, 8, 2048, 512),
             "layer4 320": (10, 10, 2048, 512), "layer4 384": (12, 12, 2048, 512)}


def v2(dev, n=128):
    ptxas(["resblock"])
    rs = np.random.RandomState(0)
    for name, (h, w, c, cm) in V2_LAYERS.items():
        x, a = block_inputs(rs, n, h, w, c, cm, c, False, dev)
        ref = rb.bottleneck_plain(x, a, h=h, w=w)
        macs = n * h * w * (2 * c * cm + 9 * cm * cm)
        nbytes = 2 * x.numel() + sum(a[k].numel() for k in ("w1", "w2", "w3"))
        bound = max(2 * macs / 1.979e15, nbytes / 3.35e12) * 1e3
        rows_ms = cuda_ms(lambda: rb.fused_bottleneck(x, a, h=h, w=w))
        x2 = x.reshape(-1, c)
        h1 = rb._requant(torch._int_mm(x2, a["w1"].t().contiguous()), a["v1"])
        patches = torch.cat(rb._taps(h1.reshape(n, h, w, cm)), dim=1).contiguous()
        h2 = rb._requant(torch._int_mm(patches, a["w2"].t().contiguous()), a["v2"])
        ops = [(x2, a["w1"].t().contiguous()), (patches, a["w2"].t().contiguous()),
               (h2, a["w3"].t().contiguous())]
        lib_ms = cuda_ms(lambda: [torch._int_mm(m, k) for m, k in ops])
        del h1, patches, h2, ops
        planned = rb.plan_v2(h, w, c, cm, c)
        print(f"B8b {name}: B8a {rows_ms:.4f} ms, torch._int_mm {lib_ms:.4f} ms, bound "
              f"{bound:.4f} ms; planned {planned.form}, ring {planned.stages} x {planned.ips} "
              f"image(s) | {card()}", flush=True)
        for form in rb.V2_FORMS:
            for ips in (1, 2):
                for stages in range(2, 9):
                    try:
                        plan = rb.plan_v2(h, w, c, cm, c, form=form, stages=stages, ips=ips)
                    except ValueError:
                        continue
                    run = lambda: rb._launch_v2(x, a, h, w, form, stages, ips)
                    ok = torch.equal(run(), ref)
                    ms, dev_ms = cuda_ms(run), burst_ms(run)
                    mark = " (planned)" if plan == planned else ""
                    print(f"B8b {name} {form} ring {stages} x {ips}{mark}: {ms:.4f} ms, back to "
                          f"back {dev_ms:.4f} ms, {2 * macs / dev_ms / 1e9:.1f} TOP/s, "
                          f"{'equal' if ok else 'DIFFERS'}, smem {plan.smem}, blocks/SM "
                          f"{rb.v2_blocks_per_sm(plan, cm)} | {card()}", flush=True)
        # where a warpgroup's cycles go at the planned block (clock64 marks)
        clocks = torch.zeros(len(rb.V2_CLOCK_SLOTS), dtype=torch.int64, device=dev)
        timed = rb._launch_v2(x, a, h, w, clocks=clocks)
        assert torch.equal(timed, ref), f"B8b {name}: the timed instance differs"
        got = dict(zip(rb.V2_CLOCK_SLOTS, clocks.tolist()))
        total = got["total"]
        print(f"B8b {name} clocks: " + ", ".join(
            f"{k} {v / total:.3f}" for k, v in got.items()
            if k not in ("total", "steps", "jobs")) + f"; cycles a step "
              f"{total / max(got['steps'], 1):.0f}, steps a job "
              f"{got['steps'] / max(2 * got['jobs'], 1):.1f}, jobs {got['jobs']} | {card()}",
              flush=True)


def decode(dev):
    ptxas(["decode"])
    g = torch.Generator().manual_seed(0)
    for maps in (512, 2048):
        hm = torch.randn(maps // 64, 4, 16, 64, 64, generator=g).to(dev)
        flat = hm.reshape(maps, -1)
        dec.decode_heatmaps_kernel(hm)
        out = torch.empty(maps, 3, device=dev)
        fn, stream = dec._kernel, pt.stream_of(hm)

        def raw(k=50):
            for _ in range(k):
                fn(hm.data_ptr(), out.data_ptr(), maps, 64, 64, 1, stream)
        device_ms = cuda_ms(raw) / 50
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            raw(20)
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if "decode_kernel" in e.name]
        kernel_ms = statistics.median(spans) / 1e3 if spans else float("nan")
        wrapper_ms = cuda_ms(lambda: dec.decode_heatmaps_kernel(hm))
        max_ms = cuda_ms(lambda: torch.max(flat, dim=-1))
        plain_ms = cuda_ms(lambda: decode_heatmaps(hm))
        print(f"B7 {maps} maps: kernel {kernel_ms:.4f} ms (profiler, median of {len(spans)}), "
              f"back-to-back launches {device_ms:.4f} ms each, wrapper {wrapper_ms:.4f} ms, "
              f"torch.max {max_ms:.4f} ms, plain {plain_ms:.4f} ms | {card()}")

    def host_us(f, reps=2000):
        f()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            f()
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        return dt / reps * 1e6

    real = dec._kernel
    terms = {"whole wrapper, launch included": lambda: dec.decode_heatmaps_kernel(hm),
             "torch.max (host side of the call)": lambda: torch.max(flat, dim=-1),
             "torch.empty [.., 3]": lambda: torch.empty(hm.shape[:-2] + (3,),
                                                        dtype=torch.float32, device=dev),
             "two views of the output": lambda: dec.split_decoded(out),
             "stream_of (raw handle)": lambda: pt.stream_of(hm),
             "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream(
                 hm.device).cuda_stream,
             "dtype and contiguity test": lambda: (hm.dtype is not torch.float32
                                                   or not hm.is_contiguous()),
             ".float().contiguous() on an f32 contiguous tensor": lambda: hm.float().contiguous(),
             "two data_ptr()": lambda: (hm.data_ptr(), out.data_ptr()),
             "ctypes call with the launch": lambda: real(hm.data_ptr(), out.data_ptr(), 2048,
                                                         64, 64, 1, stream)}
    for name, f in terms.items():
        print(f"B7 host: {name}: {host_us(f):.2f} us")
    dec._kernel = lambda *a: 0  # the launch stubbed: what is left is the wrapper's host time
    try:
        print(f"B7 host: whole wrapper, launch stubbed: "
              f"{host_us(lambda: dec.decode_heatmaps_kernel(hm)):.2f} us | {card()}")
    finally:
        dec._kernel = real


def imma(dev):
    root = Path(__file__).resolve().parents[1]
    exe = root / "build" / "imma_rate"
    exe.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-o", str(exe), str(root / "tools" / "imma_rate.cu")], check=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout
    for line in out.strip().splitlines():
        print(f"{line} | {card()}")


def tail2_inputs(rs, n, h, c, joints, dev):
    """B1's serving-shaped inputs: x int8 [n, h*h, c], args whose requants
    neither saturate nor vanish."""
    def vec(k):
        return np.stack([rs.uniform(0.5, 1.5, c) * 40.0 / (127.0 * np.sqrt(4 * k) * 60.0),
                         rs.uniform(-2, 2, c)]).astype(np.float32)
    args = {"w1": rs.randint(-127, 128, (4, 4, c, c)).astype(np.int8),
            "w2": rs.randint(-127, 128, (4, 4, c, c)).astype(np.int8),
            "s1": vec(c), "s2": vec(c),
            "so1": np.asarray([[0.5]], np.float32), "so2": np.asarray([[0.5]], np.float32),
            "wh": rs.randint(-127, 128, (c, joints)).astype(np.int8),
            "vh": np.stack([rs.uniform(1e-4, 1e-3, joints),
                            rs.uniform(-1, 1, joints)]).astype(np.float32)}
    x = torch.from_numpy(rs.randint(0, 128, (n, h * h, c)).astype(np.int8)).to(dev)
    return x, pt.tail2_device_args(args, dev)


def tail2(dev, n=128, h=16, c=256, joints=16):
    ptxas(["tail2"])
    rs = np.random.RandomState(0)
    x, a = tail2_inputs(rs, n, h, c, joints, dev)
    x4 = x.reshape(n, h, h, c)
    ref = pt.phase_tail2_plain(x, a, h=h, w=h)
    z1_ref = pt._phase_conv_plain(x4, a["w1"], a["s1"][0], a["s1"][1], a["so1"], interleave=True)
    print(f"B1 inputs: z1 nonzero share {float((z1_ref != 0).float().mean()):.2f}, "
          f"{len(torch.unique(z1_ref))} values; heatmap std {float(ref.std()):.4f}", flush=True)
    macs1 = 16 * n * h * h * c * c
    macs2 = 16 * n * 4 * h * h * c * c + n * 16 * h * h * joints * c
    for label, run, macs, jt, hh in (
            ("deconv1", lambda st: pt.launch_tail2(
                x4, a["w1t"], a["s1"], a["so1"], stages=st), macs1, 0, h),
            ("deconv2 + head", lambda st: pt.launch_tail2(
                z1_ref, a["w2t"], a["s2"], a["so2"], a["wht"], a["vh"], stages=st),
             macs2, 2, 2 * h)):
        want = z1_ref if jt == 0 else ref
        chosen = pt.plan_tail2(hh, hh, c, c, jt)
        for stages in (2, 3, 4):
            plan = pt.plan_tail2(hh, hh, c, c, jt, stages)
            ok = torch.equal(run(stages), want)
            ms = cuda_ms(lambda: run(stages))
            mark = " (planned)" if plan == chosen else ""
            print(f"B1 {label} ring {stages} x 128 B{mark}: {ms:.4f} ms, "
                  f"{2 * macs / ms / 1e9:.1f} TOP/s, {'equal' if ok else 'DIFFERS'}, smem "
                  f"{plan.smem}, blocks/SM {pt.tail2_blocks_per_sm(plan, jt)}, grid "
                  f"{plan.tiles_x * plan.tiles_y * n} | {card()}", flush=True)
    ok = torch.equal(pt.fused_phase_tail2(x, a, h=h, w=h), ref)
    wrapper_ms = cuda_ms(lambda: pt.fused_phase_tail2(x, a, h=h, w=h))
    print(f"B1 wrapper: {wrapper_ms:.4f} ms ({'equal' if ok else 'DIFFERS'}); "
          f"bound {2 * (macs1 + macs2) / 1.979e15 * 1e3:.4f} ms | {card()}", flush=True)
    print(f"B1 device ms a call by kernel: "
          f"{device_by_kernel(lambda: pt.fused_phase_tail2(x, a, h=h, w=h))} | {card()}",
          flush=True)

    # B5: B1's deconv2 + head instance with the levels=1 store, at path 3's
    # 32 images of 32x32 and at 128
    b5 = {"w": a["w2"], "sv": a["s2"], "so": a["so2"], "wh": a["wh"], "vh": a["vh"]}
    b5 = pt.with_tail_weights(b5)
    for n5 in (32, 128):
        x5 = z1_ref[:n5].reshape(n5, 4 * h * h, c)
        ref5 = pt.phase_tail_plain(x5, b5, h=2 * h, w=2 * h)
        macs5 = 16 * n5 * 4 * h * h * c * c + n5 * 16 * h * h * joints * c
        for stages in (2, 3, 4):
            def run(st=stages):
                return pt.launch_tail2(x5.reshape(n5, 2 * h, 2 * h, c), b5["wt"], b5["sv"],
                                       b5["so"], b5["wht"], b5["vh"], store="head_packed1",
                                       stages=st)
            ok = torch.equal(run(), ref5)
            ms, b_ms = cuda_ms(run), burst_ms(run)
            mark = " (planned)" if stages == pt.TAIL2_STAGES else ""
            print(f"B5 {n5} images ring {stages} x 128 B{mark}: {ms:.4f} ms, back to back "
                  f"{b_ms:.4f} ms ({2 * macs5 / b_ms / 1e9:.1f} TOP/s), "
                  f"{'equal' if ok else 'DIFFERS'} | {card()}", flush=True)
        fn = lambda: pt.fused_phase_tail(x5, b5, h=2 * h, w=2 * h)
        ok = torch.equal(fn(), ref5)
        print(f"B5 {n5} images wrapper: {cuda_ms(fn):.4f} ms ({'equal' if ok else 'DIFFERS'}); "
              f"bound {2 * macs5 / 1.979e15 * 1e3:.4f} ms; device ms a call by kernel "
              f"{device_by_kernel(fn)} | {card()}", flush=True)


def device_by_kernel(fn, reps=5):
    """Device milliseconds a call of ``fn`` by kernel name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            k = e.name.split("(")[0].replace("void ", "").replace("posetpu::", "")[-40:]
            by[k] = by.get(k, 0.0) + (e.time_range.end - e.time_range.start) / (reps * 1e3)
    return {k: round(v, 4) for k, v in sorted(by.items(), key=lambda kv: -kv[1])}


def aggregation(dev, j=16, ng=32, s=4096):
    ptxas(["aggregation"])
    g = torch.Generator(device=dev).manual_seed(0)
    qagg = {"wq": torch.randint(-127, 128, (4, 3, s, s), generator=g, device=dev,
                                dtype=torch.int8),
            "w_scale": torch.rand(4, 1, s, generator=g, device=dev) * 1e-3 + 1e-4,
            "x_scale": torch.tensor(1.2 / 127, device=dev)}
    qagg["sv"] = agg.fold_sv(qagg).contiguous()
    hm = torch.randn(j, ng, 4, s, generator=g, device=dev) * 0.5
    jn = j * ng
    ref = agg.aggregation_grouped_plain(qagg, hm)
    ok = torch.equal(agg.aggregation_grouped(qagg, hm), ref)
    xq = agg.quantize_heatmaps(qagg, hm)
    out = torch.empty((4, jn, s), dtype=torch.float32, device=dev)
    lib = _build.load("aggregation", agg._SIGNATURES)
    stream = pt.stream_of(hm)

    def gemm():
        lib.aggregation_grouped(xq.data_ptr(), qagg["wq"].data_ptr(), qagg["sv"].data_ptr(),
                                out.data_ptr(), jn, s, stream)
    gathered = [torch.cat([xq[p] for p in range(4) if p != t], dim=1) for t in range(4)]
    bank_kn = [qagg["wq"][t].transpose(-1, -2).reshape(3 * s, s).contiguous() for t in range(4)]
    macs = 4 * jn * 3 * s * s
    times = {"quantize pass": cuda_ms(lambda: agg.quantize_heatmaps(qagg, hm)),
             "plain quantize (PyTorch passes)": cuda_ms(lambda: agg._quantize(qagg, hm)),
             "GEMM kernel": cuda_ms(gemm),
             "wrapper": cuda_ms(lambda: agg.aggregation_grouped(qagg, hm)),
             "4 x torch._int_mm, pre-gathered": cuda_ms(
                 lambda: [torch._int_mm(gathered[t], bank_kn[t]) for t in range(4)])}
    for k, v in times.items():
        extra = f", {2 * macs / v / 1e9:.1f} TOP/s" if k in ("GEMM kernel", "wrapper") else ""
        print(f"B3 {k}: {v:.4f} ms{extra}", flush=True)
    print(f"B3 wrapper equal to plain: {ok}; bound {2 * macs / 1.979e15 * 1e3:.4f} ms by "
          f"operations, bank {4 * 3 * s * s / 1e6:.1f} MB at 3.35 TB/s "
          f"{4 * 3 * s * s / 3.35e12 * 1e3:.4f} ms | {card()}", flush=True)
    from torch.profiler import ProfilerActivity, profile
    agg.aggregation_grouped(qagg, hm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            agg.aggregation_grouped(qagg, hm)
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by[e.name[:40]] = by.get(e.name[:40], 0.0) + (e.time_range.end - e.time_range.start) / 10e3
    print(f"B3 device ms a call by kernel: "
          f"{ {k: round(v, 4) for k, v in sorted(by.items(), key=lambda kv: -kv[1])} } | {card()}",
          flush=True)

    # B4 on a random 4-bit bank at the same shape
    w4 = agg.pack_nibbles_k(torch.randint(-7, 8, (4, 3, s, s), generator=g, device=dev,
                                          dtype=torch.int8))
    q4 = {"wq4": w4, "w_scale": qagg["w_scale"], "x_scale": qagg["x_scale"],
          "dv": torch.rand(4, 3, s, generator=g, device=dev) * 0.05}
    q4["sv"] = agg.fold_sv(q4).contiguous()
    ref4 = agg.aggregation_grouped_s4_plain(q4, hm)
    for stages in range(2, 6):
        def gemm4(stages=stages):
            _build.check(lib.aggregation_grouped_s4(
                xq.data_ptr(), q4["wq4"].data_ptr(), q4["sv"].data_ptr(), q4["dv"].data_ptr(),
                out.data_ptr(), jn, s, stages, stream), "aggregation_grouped_s4")
        try:
            gemm4()
        except RuntimeError as e:  # the ring does not fit a block
            print(f"B4 ring {stages}: {e}")
            break
        ok = torch.equal(agg._unpack(out, hm), ref4)
        k_ms = cuda_ms(gemm4)
        b_ms = statistics.median(burst_ms(gemm4) for _ in range(5))
        print(f"B4 ring {stages} x 40 KB{' (planned)' if stages == agg.S4_STAGES else ''}: "
              f"GEMM kernel {k_ms:.4f} ms, back to back {b_ms:.4f} ms "
              f"({2 * macs / b_ms / 1e9:.1f} TOP/s); {'equal' if ok else 'DIFFERS'} | {card()}",
              flush=True)
    ok = torch.equal(agg.aggregation_grouped_s4(q4, hm), ref4)
    w_ms = cuda_ms(lambda: agg.aggregation_grouped_s4(q4, hm))
    print(f"B4 wrapper {w_ms:.4f} ms ({2 * macs / w_ms / 1e9:.1f} TOP/s); "
          f"{'equal' if ok else 'DIFFERS'} | {card()}", flush=True)
    bank4 = agg.unpack_nibbles_k(q4["wq4"])
    bank4_kn = [bank4[t].transpose(-1, -2).reshape(3 * s, s).contiguous() for t in range(4)]
    del bank4
    print(f"B4 plain {cuda_ms(lambda: agg.aggregation_grouped_s4_plain(q4, hm), reps=5):.4f} ms; "
          f"4 x torch._int_mm on the widened bank, pre-gathered "
          f"{cuda_ms(lambda: [torch._int_mm(gathered[t], bank4_kn[t]) for t in range(4)]):.4f}"
          f" ms; bank {4 * 3 * s * s / 2e6:.1f} MB packed at 3.35 TB/s "
          f"{4 * 3 * s * s / 2 / 3.35e12 * 1e3:.4f} ms | {card()}", flush=True)
    agg.aggregation_grouped_s4(q4, hm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            agg.aggregation_grouped_s4(q4, hm)
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by[e.name[:48]] = by.get(e.name[:48], 0.0) + (e.time_range.end - e.time_range.start) / 10e3
    print(f"B4 device ms a call by kernel: "
          f"{ {k: round(v, 4) for k, v in sorted(by.items(), key=lambda kv: -kv[1])} } | {card()}",
          flush=True)


def deconv_inputs(rs, n, h, cin, cout, joints, dev):
    """B9's inputs: x int8 [n, h*h, cin] and kernel arguments whose folded
    requants neither saturate nor vanish."""
    args = {"w": rs.randint(-127, 128, (4, cin, 4 * cout)).astype(np.int8),
            "v": np.stack([rs.uniform(0.5, 1.5, 4 * cout) * 40.0 / (127.0 * np.sqrt(4 * cin) * 60.0),
                           rs.uniform(-2, 2, 4 * cout)]).astype(np.float32)}
    if joints:
        args["wh"] = rs.randint(-127, 128, (cout, joints)).astype(np.int8)
        args["vh"] = np.stack([rs.uniform(1e-4, 1e-3, joints),
                               rs.uniform(-1, 1, joints)]).astype(np.float32)
    x = torch.from_numpy(rs.randint(0, 128, (n, h * h, cin)).astype(np.int8)).to(dev)
    return x, dcv.deconv_device_args(args, dev)


def deconv(dev, n=128):
    ptxas(["tail2"])
    rs = np.random.RandomState(0)
    shapes = (("deconv0", 8, 2048, 0), ("deconv1", 16, 256, 0), ("deconv2 + head", 32, 256, 16))
    wrappers = {}
    for label, h, cin, joints in shapes:
        cout = 256
        x, a = deconv_inputs(rs, n, h, cin, cout, joints, dev)
        x4 = x.reshape(n, h, h, cin)
        head = joints > 0
        plain = dcv.subpixel_deconv_head_plain if head else dcv.subpixel_deconv_plain
        ref = plain(x, a, h=h, w=h)
        want = ref if head else ref.reshape(n, 2 * h, 2 * h, cout)
        macs = 16 * n * h * h * cin * cout + (4 * n * h * h * joints * cout if head else 0)
        print(f"B9 {label} inputs: nonzero share {float((ref != 0).float().mean()):.2f}, "
              f"{len(torch.unique(ref))} values; bound {2 * macs / 1.979e15 * 1e3:.4f} ms",
              flush=True)
        jt = 2 if head else 0
        d = dcv.deconv_design(cin, cout, joints)
        stream = d == "stream"
        wt = pt.tile_phase_weight(a["w"], chunked=stream)
        for sets in ((1, 2, 4, 8) if stream else (8,)):
            for stages in range(2, 8):
                try:
                    plan = pt.plan_tail2(h, h, cin, cout, jt, stages, design=d, folded=True,
                                         sets=sets)
                except ValueError:
                    break

                def run(st=stages, sets=sets):
                    return pt.launch_tail2(x4, wt, a["v"], None, a.get("wht"), a.get("vh"),
                                           epilogue="folded", design=d, sets=sets, stages=st)
                ok = torch.equal(run(), want)
                ms = cuda_ms(run)
                chosen = (stages, sets) == ((dcv.STREAM_STAGES,
                                             pt.stream_sets(n, h, h, cout, pt.sm_count(0)))
                                            if stream
                                            else (pt.TAIL2_STAGES, 8))
                grid = plan.tiles_x * plan.tiles_y * (-(-n // 2) if stream else n) * (8 // sets)
                print(f"B9 {label} {d} sets {sets} ring {stages} x 128 B"
                      f"{' (planned)' if chosen else ''}: {ms:.4f} ms, "
                      f"{2 * macs / ms / 1e9:.1f} TOP/s, {'equal' if ok else 'DIFFERS'}, "
                      f"smem {plan.smem}, blocks/SM {pt.tail2_blocks_per_sm(plan, jt, epilogue="folded")}"
                      f", grid {grid} | {card()}", flush=True)
        fused = dcv.fused_subpixel_deconv_head if head else dcv.fused_subpixel_deconv
        ok = torch.equal(fused(x, a, h=h, w=h), ref)
        wrappers[label] = cuda_ms(lambda: fused(x, a, h=h, w=h))
        zq = dcv.subpixel_deconv_plain(x, a, h=h, w=h) if head else None
        lib_ms = cuda_ms(phase_gemms(x4, a["w"], zq, a.get("wh")))
        print(f"B9 {label} wrapper: {wrappers[label]:.4f} ms ({'equal' if ok else 'DIFFERS'}); "
              f"torch._int_mm on the pre-gathered phase operands {lib_ms:.4f} ms; plain "
              f"{cuda_ms(lambda: plain(x, a, h=h, w=h), reps=5):.4f} ms | {card()}", flush=True)
        from torch.profiler import ProfilerActivity, profile
        fused(x, a, h=h, w=h)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fused(x, a, h=h, w=h)
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type.name == "CUDA":
                k = e.name.split("(")[0][-40:]
                by[k] = by.get(k, 0.0) + (e.time_range.end - e.time_range.start) / 10e3
        print(f"B9 {label} device ms a call by kernel: "
              f"{ {k: round(v, 4) for k, v in sorted(by.items(), key=lambda kv: -kv[1])} } "
              f"| {card()}", flush=True)
    print(f"B9a wrapper, both calls: {wrappers['deconv0'] + wrappers['deconv1']:.4f} ms; "
          f"B9b {wrappers['deconv2 + head']:.4f} ms | {card()}", flush=True)

    # B2: deconv0's phase-major instance, at paths 1 and 2's batches
    h, cin, cout = 8, 2048, 256
    for n2 in (128, 256):
        x = torch.from_numpy(rs.randint(0, 128, (n2, h * h, cin)).astype(np.int8)).to(dev)
        a = pt.subpixel_device_args(
            {"w": rs.randint(-127, 128, (4, 4, cin, cout)).astype(np.int8),
             "sv": (rs.uniform(0.5, 1.5, (4, cout)) * 40.0 / (127.0 * np.sqrt(4 * cin) * 60.0)
                    ).astype(np.float32),
             "bv": rs.uniform(-2, 2, (4, cout)).astype(np.float32),
             "so": np.asarray([[0.5]], np.float32)}, dev)
        ref = pt.subpixel_deconv_plain(x, a, h=h, w=h)
        macs = 16 * n2 * h * h * cin * cout
        print(f"B2 {n2} images: nonzero share {float((ref != 0).float().mean()):.2f}, "
              f"{len(torch.unique(ref))} values; bound {2 * macs / 1.979e15 * 1e3:.4f} ms",
              flush=True)
        x4 = x.reshape(n2, h, h, cin)
        for sets in (1, 2, 4, 8):
            for stages in range(2, 9):
                try:
                    plan = pt.plan_tail2(h, h, cin, cout, 0, stages, design="stream",
                                         folded=True, sets=sets)
                except ValueError:
                    break

                def run(st=stages, sets=sets):
                    return pt.launch_tail2(x4, a["wt"], a["svb"], a["so"], epilogue="relu_phase",
                                           design="stream", sets=sets, stages=st)
                ok = torch.equal(run(), ref)
                ms = cuda_ms(run)
                b_ms = burst_ms(run)
                chosen = (stages, sets) == (pt.STREAM_STAGES,
                                            pt.stream_sets(n2, h, h, cout, pt.sm_count(0)))
                print(f"B2 {n2} images sets {sets} ring {stages} x 128 B"
                      f"{' (planned)' if chosen else ''}: {ms:.4f} ms, back to back "
                      f"{b_ms:.4f} ms ({2 * macs / b_ms / 1e9:.1f} TOP/s), "
                      f"{'equal' if ok else 'DIFFERS'}, smem "
                      f"{plan.smem}, blocks/SM {pt.tail2_blocks_per_sm(plan, 0, epilogue='relu_phase')}, "
                      f"grid {plan.tiles_x * plan.tiles_y * (-(-n2 // 2)) * (8 // sets)} "
                      f"| {card()}", flush=True)
        ok = torch.equal(pt.fused_subpixel_deconv_batched(x, a, h=h, w=h), ref)
        w_ms = cuda_ms(lambda: pt.fused_subpixel_deconv_batched(x, a, h=h, w=h))
        # the same launches on activation-like input: ReLU'd, half of it zeros
        xr = torch.clamp(torch.randn(n2, h * h, cin, device=dev) * 30, 0, 127).to(torch.int8)
        xr4 = xr.reshape(n2, h, h, cin)
        okr = torch.equal(pt.fused_subpixel_deconv_batched(xr, a, h=h, w=h),
                          pt.subpixel_deconv_plain(xr, a, h=h, w=h))
        for sets in (4, 8):
            def run_r(sets=sets):
                return pt.launch_tail2(xr4, a["wt"], a["svb"], a["so"], epilogue="relu_phase",
                                       design="stream", sets=sets, stages=pt.STREAM_STAGES)
            print(f"B2 {n2} images, ReLU'd input, sets {sets} ring {pt.STREAM_STAGES}: "
                  f"{cuda_ms(run_r):.4f} ms, back to back {burst_ms(run_r):.4f} ms "
                  f"({'equal' if okr else 'DIFFERS'}) | {card()}", flush=True)
        print(f"B2 {n2} images wrapper: {w_ms:.4f} ms ({'equal' if ok else 'DIFFERS'}); "
              f"torch._int_mm on the pre-gathered phase operands "
              f"{cuda_ms(phase_gemms(x4, a['w'])):.4f} ms; plain "
              f"{cuda_ms(lambda: pt.subpixel_deconv_plain(x, a, h=h, w=h), reps=5):.4f} ms "
              f"| {card()}", flush=True)
        pt.fused_subpixel_deconv_batched(x, a, h=h, w=h)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                pt.fused_subpixel_deconv_batched(x, a, h=h, w=h)
            torch.cuda.synchronize()
        dev_ms = sum(e.time_range.end - e.time_range.start for e in prof.events()
                     if "tail2_kernel" in e.name) / 10e3
        print(f"B2 {n2} images device ms a call: {dev_ms:.4f} | {card()}", flush=True)

    # B6: the same launch with the N-minor store, at path 3's 32 images and at
    # 128, beside B2 on the same input
    for n6 in (32, 128):
        x = torch.from_numpy(rs.randint(0, 128, (n6, h * h, cin)).astype(np.int8)).to(dev)
        ref = pt.subpixel_deconv_pairs_plain(x, a, h=h, w=h)
        macs = 16 * n6 * h * h * cin * cout
        x4 = x.reshape(n6, h, h, cin)
        for sets in (1, 2, 4, 8):
            for stages in (4, pt.STREAM_STAGES):
                def run(st=stages, sets=sets):
                    return pt.launch_tail2(x4, a["wt"], a["svb"], a["so"], epilogue="relu_phase",
                                           store="n_minor", design="stream", sets=sets, stages=st)
                ok = torch.equal(run(), ref)
                chosen = (stages, sets) == (pt.STREAM_STAGES,
                                            pt.stream_sets(n6, h, h, cout, pt.sm_count(0)))
                b_ms = burst_ms(run)
                print(f"B6 {n6} images sets {sets} ring {stages} x 128 B"
                      f"{' (planned)' if chosen else ''}: {cuda_ms(run):.4f} ms, back to back "
                      f"{b_ms:.4f} ms ({2 * macs / b_ms / 1e9:.1f} TOP/s), "
                      f"{'equal' if ok else 'DIFFERS'}, grid "
                      f"{-(-n6 // 2) * (8 // sets)} | {card()}", flush=True)
        b6 = lambda: pt.fused_subpixel_deconv(x, a, h=h, w=h)
        b2 = lambda: pt.fused_subpixel_deconv_batched(x, a, h=h, w=h)
        ok = torch.equal(b6(), ref)
        print(f"B6 {n6} images wrapper: {cuda_ms(b6):.4f} ms ({'equal' if ok else 'DIFFERS'}), "
              f"B2's on the same input {cuda_ms(b2):.4f} ms; bound "
              f"{2 * macs / 1.979e15 * 1e3:.4f} ms; device ms a call by kernel: B6 "
              f"{device_by_kernel(b6)}, B2 {device_by_kernel(b2)} | {card()}", flush=True)


# the distinct requantize sites of a serving request (ResNet-50 at 256x256,
# 128 images): (rows, channels, form, hi, sites a request); "tail" a block's
# last conv with its residual, "linear" a downsample
REQUANT_SITES = [(2097152, 64, "relu", 127, 1), (524288, 64, "relu", 127, 6),
                 (524288, 256, "linear", 127, 1), (524288, 256, "tail", 7, 3),
                 (524288, 128, "relu", 127, 1), (131072, 128, "relu", 127, 7),
                 (131072, 512, "linear", 127, 1), (131072, 512, "tail", 7, 4),
                 (131072, 256, "relu", 127, 1), (32768, 256, "relu", 127, 11),
                 (32768, 1024, "linear", 127, 1), (32768, 1024, "tail", 127, 6),
                 (32768, 512, "relu", 127, 1), (8192, 512, "relu", 127, 5),
                 (8192, 2048, "linear", 127, 1), (8192, 2048, "tail", 127, 3)]


def requant(dev):
    ptxas(["requant"])
    gen = torch.Generator(device=dev).manual_seed(0)
    total_ms = plain_total = total_mb = 0.0
    for m, c, form, hi, count in REQUANT_SITES:
        acc = torch.randint(-2 ** 21, 2 ** 21, (m, c), generator=gen, dtype=torch.int32,
                            device=dev)
        sv = (torch.rand(c, generator=gen, device=dev) + 0.5) * 2.0 ** -14
        bias = torch.rand(c, generator=gen, device=dev) * 40 - 20
        args = (acc, sv, bias, torch.tensor(1 / 0.9, device=dev), hi, form != "linear")
        kw = {}
        if form == "tail":
            kw = {"residual": torch.randint(-hi, hi + 1, (m, c), generator=gen,
                                            dtype=torch.int8, device=dev),
                  "r_scale": torch.tensor(0.41, device=dev)}
        ok = torch.equal(rq.requant(*args, **kw), rq.requant_plain(*args, **kw))
        ms = burst_ms(lambda: rq.requant(*args, **kw))
        plain = burst_ms(lambda: rq.requant_plain(*args, **kw), k=5)
        mb = m * c * (6 if form == "tail" else 5) / 1e6
        total_ms, plain_total, total_mb = (total_ms + count * ms, plain_total + count * plain,
                                           total_mb + count * mb)
        print(f"requant {m} x {c} {form} hi {hi} (x{count} a request): {ms:.4f} ms "
              f"({'equal' if ok else 'DIFFERS'}), {mb / ms:.0f} GB/s; plain {plain:.4f} ms; "
              f"bound {mb / 3.35e3:.4f} ms | {card()}", flush=True)
    print(f"requant a request (53 sites): {total_ms:.3f} ms, {total_mb:.1f} MB, "
          f"{total_mb / total_ms:.0f} GB/s; plain {plain_total:.3f} ms; bound "
          f"{total_mb / 3.35e3:.3f} ms | {card()}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {card()} | torch {torch.__version__}")
    for mode in sys.argv[1:] or ["check"]:
        {"check": check, "sweep": sweep, "v2": v2, "decode": decode, "imma": imma,
         "tail2": tail2,
         "agg": aggregation, "deconv": deconv, "requant": requant}[mode](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
