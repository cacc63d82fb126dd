#!/usr/bin/env python3
"""Time the port's host image loader on the CPU cores of the machine it runs on.

    python3 tools/torch_loader_probe.py [--batches 8] [--out FILE]

Writes data/synthetic.write_image_fixture's MPII and H36M (1280x720 and
1000x1000 JPEGs in zips) into a temporary directory, then times, on the
host clock:

1. one image's decode (cv2.imdecode of the zip member) and its 256x256 crop
   warp, on one thread, for each source;
2. the train loader of experiments/mpii/resnet50/140e_32batch.yaml (8 groups
   of 4 views a batch, MPII's augmentation, no prefetch) per batch, over
   pool sizes 1, 2, 4 and 8 and with cv2's own threads left at their
   default or set to 1 (cv2 warps on a pool of its own; a loader thread
   that calls it then waits for that pool, and the two pools oversubscribe
   the cores);
3. the same loader with the zip members read through one ``ZipFile`` a
   thread in place of the shared one under its lock.

Prints one JSON object (and writes it to ``--out`` where given). Needs no
card; the numbers are the host's, so record which machine ran it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import threading
import time
import zipfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def per_batch_ms(loader, batches: int) -> float:
    """Median host ms a batch over ``batches`` batches, after one."""
    times, it = [], iter(loader)
    next(it)
    for _ in range(batches):
        t = time.perf_counter()
        next(it)
        times.append((time.perf_counter() - t) * 1e3)
    it.close()
    return statistics.median(times)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--out", default="")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import cv2
    import numpy as np

    from posetpu_torch.config import load_config
    from posetpu_torch.data import zipreader
    from posetpu_torch.data.base import _affine_matrix_np
    from posetpu_torch.data.loader import GroupLoader
    from posetpu_torch.data.registry import get_dataset
    from posetpu_torch.data.synthetic import write_image_fixture

    out = {"cpu_count": os.cpu_count(), "cv2": cv2.__version__,
           "cv2_threads_default": cv2.getNumThreads()}
    with tempfile.TemporaryDirectory(prefix="posetpu-loader-") as tmp:
        t = time.perf_counter()
        write_image_fixture(tmp, n_images=64, mpii_train=512, mpii_valid=32,
                            h36m_train_groups=16, h36m_valid_groups=2)
        out["fixture_s"] = time.perf_counter() - t

        # 1. one image's decode and warp, one thread
        flags = cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION
        for source in ("mpii", "h36m"):
            zf = zipfile.ZipFile(os.path.join(tmp, source, "images.zip"))
            names = [n for n in zf.namelist() if n.endswith(".jpg")]
            blobs = [zf.read(n) for n in names]
            t = time.perf_counter()
            imgs = [cv2.imdecode(np.frombuffer(b, np.uint8), flags) for b in blobs]
            decode = (time.perf_counter() - t) * 1e3 / len(blobs)
            h, w = imgs[0].shape[:2]
            trans = _affine_matrix_np((w / 2, h / 2), (h / 200 * 0.8, h / 200 * 0.8), 12.0,
                                      (256, 256))
            cv2.setNumThreads(1)
            t = time.perf_counter()
            for img in imgs:
                cv2.warpAffine(img, trans, (256, 256), flags=cv2.INTER_LINEAR)
            warp = (time.perf_counter() - t) * 1e3 / len(imgs)
            cv2.setNumThreads(out["cv2_threads_default"])
            out[f"{source}_image"] = {"size": [w, h], "jpeg_kb": sum(map(len, blobs)) / len(blobs)
                                      / 1e3, "decode_ms": decode, "warp_ms": warp}

        # 2. the train loader over pool sizes and cv2 threads
        cfg = load_config(str(ROOT / "experiments/mpii/resnet50/140e_32batch.yaml"))
        cfg.DATASET.ROOT = tmp
        ds = get_dataset("mpii")(cfg, "train", True)
        grid = {}
        for cv2_threads in (out["cv2_threads_default"], 1):
            cv2.setNumThreads(cv2_threads)
            for n in (1, 2, 4, 8):
                grid[f"cv2 {cv2_threads}, pool {n}"] = per_batch_ms(
                    GroupLoader(ds, 8, prefetch=0, num_threads=n), args.batches)
        out["loader_ms_a_batch"] = grid

        # 3. one ZipFile a thread, at pool 8 with cv2 on one thread
        local = threading.local()

        def read_bytes(path):
            zp, inner = zipreader.split_zip_path(path)
            handles = local.__dict__.setdefault("zips", {})
            if zp not in handles:
                handles[zp] = zipfile.ZipFile(zp)
            return handles[zp].read(inner)

        shared = zipreader.read_bytes
        zipreader.read_bytes = read_bytes
        try:
            out["loader_ms_a_batch_zip_per_thread"] = {
                f"cv2 1, pool {n}": per_batch_ms(GroupLoader(ds, 8, prefetch=0, num_threads=n),
                                                 args.batches) for n in (4, 8)}
        finally:
            zipreader.read_bytes = shared
        cv2.setNumThreads(out["cv2_threads_default"])
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
