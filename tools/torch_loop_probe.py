#!/usr/bin/env python3
"""Where the train loop's host time goes on one GPU: the loader's threads
against the step's dispatch.

    python3 tools/torch_loop_probe.py [--steps 16] [--out FILE]

Writes data/synthetic.write_image_fixture's MPII (1280x720 JPEGs in a zip),
sets up ``python -m posetpu_torch.cli.train --cfg
experiments/mpii/resnet50/140e_32batch.yaml`` (bf16 R50, 8 four-view groups
a batch) through ``cli/train.setup`` on the card, then times on the host
clock, each over ``--steps`` steps ending in a synchronize:

1. the loop (``train/loop.train_epoch``, prefetch 2) with the loader's pool
   at 1, 2, 4 and 8 threads: groups/s and the mean wait for a batch;
2. the step alone on batches held on the card;
3. the same held steps while a loader of 8 (then 2) threads runs on
   another thread into a sink: what the loader's threads cost the step's
   dispatch;
4. the loader alone at 8 threads, no step;
5. the held steps again after a ``torch.profiler`` span with CUDA activity
   over two of them (does tracing leave a cost on each launch behind it?);
6. the loop at 8 threads with the CLI's logging step (a logger and the
   DEBUG drawings at step 0, as PRINT_FREQ has it): each wait for a batch,
   and the logging step alone; then the same with the interpreter's switch
   interval at 1 ms and 0.2 ms (5 ms by default);
7. the logging step's parts on one batch on the card: the DEBUG drawings
   (utils/vis.save_debug_images) and ``device_memory_stats``.

Prints one JSON object (and writes it to ``--out`` where given), with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--out", default="")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from posetpu_torch.cli import train as train_cli
    from posetpu_torch.cli.common import load_cfg
    from posetpu_torch.data.loader import GroupLoader
    from posetpu_torch.data.synthetic import write_image_fixture
    from posetpu_torch.train.loop import train_epoch
    from posetpu_torch.utils.profiling import StepTimer

    if not torch.cuda.is_available():
        print("torch_loop_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    n = args.steps
    out = {"card": card, "steps": n}
    with tempfile.TemporaryDirectory(prefix="posetpu-loop-") as tmp:
        write_image_fixture(f"{tmp}/data", n_images=64, mpii_train=8 * 4 * (n + 2),
                            mpii_valid=32, h36m_train_groups=2, h36m_valid_groups=2)
        cli = train_cli.parse_args(["--cfg", str(ROOT / "experiments/mpii/resnet50/"
                                                 "140e_32batch.yaml"),
                                    "--modelDir", f"{tmp}/output", "--logDir", f"{tmp}/log",
                                    "--dataDir", tmp])
        cfg = load_cfg(cli)
        cfg.DEBUG.DEBUG = False
        tr = train_cli.setup(cfg, cli, device="cuda")
        ds, bs = tr.train_ds, int(cfg.TRAIN.BATCH_SIZE)
        ds.grouping = ds.grouping[:bs * n]

        def loop(threads: int):
            timer = StepTimer()
            loader = GroupLoader(ds, bs, num_threads=threads)
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.state = train_epoch(cfg, loader, tr.prepare, tr.train_step, tr.state, 0,
                                   timer=timer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            return {"groups_per_s": bs * n / wall,
                    "data_ms_mean": 1e3 * sum(timer.data_times) / len(timer.data_times)}

        loop(8)  # warm-up: cuDNN's plans, the pinned pool
        out["loop"] = {f"pool {k}": loop(k) for k in (1, 2, 4, 8)}

        held = [tr.prepare(b) for b in GroupLoader(ds, bs, prefetch=0, num_threads=8)]

        def held_steps():
            torch.cuda.synchronize()
            t = time.perf_counter()
            for b in held:
                tr.state, _ = tr.train_step(tr.state, b)
            torch.cuda.synchronize()
            return bs * len(held) / (time.perf_counter() - t)

        held_steps()
        out["step_alone_groups_per_s"] = held_steps()
        for threads in (8, 2):
            stop = threading.Event()

            def sink(threads=threads):
                while not stop.is_set():
                    for _ in GroupLoader(ds, bs, prefetch=0, num_threads=threads):
                        if stop.is_set():
                            break

            th = threading.Thread(target=sink)
            th.start()
            time.sleep(0.5)
            out[f"step_beside_a_loader_of_{threads}_groups_per_s"] = held_steps()
            stop.set()
            th.join()
        t = time.perf_counter()
        batches = sum(1 for _ in GroupLoader(ds, bs, prefetch=0, num_threads=8))
        out["loader_alone_8_threads_ms_a_batch"] = (time.perf_counter() - t) * 1e3 / batches
        from torch.profiler import ProfilerActivity, profile

        out["step_alone_again_groups_per_s"] = held_steps()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for b in held[:2]:
                tr.state, _ = tr.train_step(tr.state, b)
            torch.cuda.synchronize()
        out["step_alone_after_a_profile_groups_per_s"] = [held_steps() for _ in range(3)]
        out["loop_pool_8_after_a_profile"] = loop(8)
        import logging

        logger = logging.getLogger("torch_loop_probe")
        logger.propagate = False
        cfg.DEBUG.DEBUG = True
        for interval in (0.005, 0.001, 0.0002):
            sys.setswitchinterval(interval)
            timer = StepTimer()
            loader = GroupLoader(ds, bs, num_threads=8)
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.state = train_epoch(cfg, loader, tr.prepare, tr.train_step, tr.state, 0,
                                   logger=logger, debug_dir=f"{tmp}/debug", timer=timer)
            torch.cuda.synchronize()
            out[f"loop_pool_8_logging_switch_{interval}"] = {
                "groups_per_s": bs * n / (time.perf_counter() - t),
                "data_ms": [round(1e3 * x, 2) for x in timer.data_times]}
        sys.setswitchinterval(0.005)
        from posetpu_torch.utils.profiling import device_memory_stats
        from posetpu_torch.utils.vis import save_debug_images

        host = next(iter(GroupLoader(ds, bs, prefetch=0, num_threads=8)))
        b = tr.prepare(host)
        parts = {}
        for rep in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            save_debug_images(cfg, b["images"][:, 0], host["joints_crop"][:, 0],
                              host["joints_vis"][:, 0], host["joints_crop"][:, 0],
                              b["target"][:, 0], b["target"][:, 0], f"{tmp}/debug/p{rep}")
            parts[f"save_debug_images_ms_{rep}"] = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            device_memory_stats()
            parts[f"device_memory_stats_ms_{rep}"] = (time.perf_counter() - t) * 1e3
        import cProfile
        import io
        import pstats

        prof = cProfile.Profile()
        prof.runcall(save_debug_images, cfg, b["images"][:, 0], host["joints_crop"][:, 0],
                     host["joints_vis"][:, 0], host["joints_crop"][:, 0], b["target"][:, 0],
                     b["target"][:, 0], f"{tmp}/debug/p2")
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(8)
        parts["save_debug_images_top_functions"] = [
            ln.strip() for ln in text.getvalue().splitlines() if "{" in ln or ".py:" in ln][:8]
        out["logging_step_parts"] = parts
        tr.writer.close()
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
