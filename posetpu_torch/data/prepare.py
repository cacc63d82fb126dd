"""The device side of the input pipeline.

Takes the host loader's uint8 crops and joint arrays and makes the train and
eval batch on the device: float conversion and mean/std normalisation (the
ToTensor + Normalize of the reference's run scripts) and the batched
Gaussian targets (joints_dataset_compatible.py:207-253, which the reference
renders per sample on the host). Uploading uint8 rather than f32 moves a
quarter of the bytes. On a card every array goes up from pinned memory with
``non_blocking``, so preparing a batch never waits for the steps before it.
"""

from __future__ import annotations

import numpy as np
import torch

from posetpu_torch import resolve_device
from posetpu_torch.ops.heatmap import render_gaussian_heatmaps


def make_prepare_fn(cfg, device=None):
    """``prepare(host_batch) -> device batch``: images [N, V, H, W, 3]
    normalised f32, target [N, V, h, w, J], weight [N, V, J] (times
    ``supervise``), and is_h36m, center, scale, joints_crop, joints_vis as
    they came. CUDA unless ``device`` is given."""
    dev = resolve_device(device)
    mean = torch.as_tensor(np.asarray(cfg.DATASET.MEAN, np.float32), device=dev)
    std = torch.as_tensor(np.asarray(cfg.DATASET.STD, np.float32), device=dev)
    hm_size = (int(cfg.NETWORK.HEATMAP_SIZE[0]), int(cfg.NETWORK.HEATMAP_SIZE[1]))
    img_size = (int(cfg.NETWORK.IMAGE_SIZE[0]), int(cfg.NETWORK.IMAGE_SIZE[1]))
    sigma = int(cfg.NETWORK.SIGMA)
    # a tensor, not a Python scalar: CUDA divides by a scalar as a multiply by
    # its reciprocal (an ulp off), by a tensor as the CPU does
    full_scale = torch.tensor(255.0, device=dev)

    def put(x):
        t = torch.as_tensor(x)
        if dev.type == "cuda" and not t.is_cuda:
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    def prepare(host_batch):
        images = put(host_batch["images"]).to(torch.float32) / full_scale
        images = (images - mean) / std
        joints_crop, joints_vis = put(host_batch["joints_crop"]), put(host_batch["joints_vis"])
        target, weight = render_gaussian_heatmaps(joints_crop, joints_vis, hm_size, img_size,
                                                  sigma)
        # h36m groups without pseudo labels get zero supervision weight
        # (joints_dataset_compatible.py:250-251)
        weight = weight * put(host_batch["supervise"])[:, None, None]
        return {
            "images": images,
            "target": target.movedim(2, -1).contiguous(),  # [N, V, h, w, J]
            "weight": weight,
            "is_h36m": put(host_batch["is_h36m"]),
            "center": put(host_batch["center"]),
            "scale": put(host_batch["scale"]),
            # crop-frame joints and visibility feed the MI pair samplers
            "joints_crop": joints_crop,
            "joints_vis": joints_vis,
        }

    return prepare
