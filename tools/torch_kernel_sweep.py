#!/usr/bin/env python3
"""Check and time the port's two redesigned kernels on one NVIDIA GPU.

    python3 tools/torch_kernel_sweep.py check        # build, ptxas, kernel == plain
    python3 tools/torch_kernel_sweep.py sweep        # B8a: ms per layer and per th
    python3 tools/torch_kernel_sweep.py decode       # B7: device, wrapper, host split
    python3 tools/torch_kernel_sweep.py imma         # mma.sync and wgmma int8 rates

``check`` builds ``csrc/resblock.cu`` and ``csrc/decode.cu``, prints ptxas'
register report and holds B8a (``ops/resblock.fused_bottleneck``) equal to
its plain version on ResNet-50's five stride-1 block shapes at 256x256 input
and on ragged shapes, and B7 equal on edge cases. ``sweep`` times B8a at 128
images on each shape for every row-tile height ``th`` that fits (CUDA events,
median of 20 after 3 warm-ups) with the blocks per SM the card reports.
``decode`` times B7 at 512 and 2,048 maps of 64x64: the kernel alone on the
device (torch.profiler's kernel time, and events around 50 back-to-back
launches), the wrapper, ``torch.max``
over the same maps, and the wrapper's host time term by term
(``time.perf_counter`` loops of 2,000 calls with the launch stubbed out).
``imma`` builds ``tools/imma_rate.cu`` with nvcc into ``build/`` and runs it:
the TOP/s the card reaches with ``mma.sync.m16n8k32.s8`` and with
``wgmma.m64n128k32.s8`` when nothing but the instruction is in the loop.
Inputs are random from a seed; nothing is read from disk. Every line of
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
from posetpu_torch.ops import decode as dec  # noqa: E402
from posetpu_torch.ops import phase_tail as pt  # noqa: E402
from posetpu_torch.ops import resblock as rb  # noqa: E402
from posetpu_torch.ops.heatmap import decode_heatmaps  # noqa: E402

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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {card()} | torch {torch.__version__}")
    for mode in sys.argv[1:] or ["check"]:
        {"check": check, "sweep": sweep, "decode": decode, "imma": imma}[mode](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
