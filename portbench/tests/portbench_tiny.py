"""A cell of the benchmark cut to a CPU's size for the tests: ResNet-18 at
64x64 with 16x16 maps (the bank 256 x 256), 2 groups a request or a step.
The harness is driven below its look for a chip."""

from __future__ import annotations

import time

import torch

from portbench import harness

CPU = torch.device("cpu")


def tiny_cfg(name="r50_256_fusion", layers=18):
    cfg = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    cfg["overrides"] = {**cfg["overrides"], "TRAIN.BATCH_SIZE": 2,
                        "POSE_RESNET.NUM_LAYERS": layers,
                        "NETWORK.IMAGE_SIZE": [64, 64], "NETWORK.HEATMAP_SIZE": [16, 16]}
    cfg.update(num_layers=layers, image_size=[64, 64], heatmap_size=[16, 16], batch_groups=2)
    return cfg


def tiny_context(cell_name, seed=2**33 + 5, seconds=0.5, limits=None, **kw):
    _, cell, cfg = harness.cell_files(cell_name)
    cfg = tiny_cfg(cfg["name"])
    cell = dict(cell, groups=2, pool=2 if cell["kind"] == "serve" else 4, calib_images=4,
                calib_batches=1, warmup_requests=1, sample_requests=2,
                reference_checkpoint=False)
    if limits is not None:
        cell["limits"] = limits
    return harness.Context(cell=cell, cfg=cfg, seed=seed, seconds=seconds, trace=False,
                           device=CPU, t_start=time.perf_counter(), **kw)


def run_tiny(cell_name, **kw):
    ctx = tiny_context(cell_name, **kw)
    drv = harness.driver(ctx.cell["kind"])
    if ctx.variant == "control" and hasattr(drv, "control"):
        return drv.control(ctx)
    return drv.run(ctx)
