"""The one generator of the benchmark's traffic: serving requests and
training batches, made from ``--seed`` and a cell's parameters
(``portbench/workloads/<cell>.json``), on the device in bulk.

Every seed gives the same sizes and the same amount of work; the seed
moves only values (pixels, crops, cameras, joints) and the order of the
H36M and MPII groups in a batch.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.weights import generator

# ImageNet's per-channel mean and deviation, the reference's DATASET.MEAN/STD
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def normalise(u8):
    """uint8 [..., 3] -> (x / 255 - mean) / std in f32."""
    mean = torch.tensor(MEAN, device=u8.device)
    std = torch.tensor(STD, device=u8.device)
    return (u8.float() / 255.0 - mean) / std


def camera_rings(cam: dict, n: int, seed: int, stream: int) -> dict:
    """``n`` rings of four cameras on a circle looking at the origin, H36M's
    scales (mm), as ``posetpu_torch.data.synthetic.make_camera_ring``
    (lines 15-43) with its jitter drawn a ring: {R [n, 4, 3, 3], T, f, c,
    k, p} float32 numpy, x_cam = R (x - T)."""
    rs = np.random.default_rng([int(seed), stream])
    views = cam["views"]
    ang = 2 * np.pi * np.arange(views) / views + cam["angle0"]
    pos = np.stack([cam["radius_mm"] * np.cos(ang), cam["radius_mm"] * np.sin(ang),
                    np.full(views, cam["height_mm"])], axis=-1)  # [V, 3]
    z = -pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    x = np.cross(z, np.array([0.0, 0.0, 1.0]))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)  # [V, 3, 3]
    jit = lambda scale, *shape: rs.uniform(-scale, scale, (n, views) + shape)
    out = {"R": np.broadcast_to(R, (n, views, 3, 3)),
           "T": np.broadcast_to(pos, (n, views, 3)),
           "f": cam["focal_px"] + jit(cam["focal_jitter_px"], 2),
           "c": np.array(cam["image_px"], float) / 2 + jit(cam["principal_jitter_px"], 2),
           "k": np.array(cam["k"]) + jit(cam["k_jitter"], 3),
           "p": np.array(cam["p"]) + jit(cam["p_jitter"], 2)}
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def serve_pool(cell: dict, cfg: dict, seed: int, device) -> dict:
    """The requests a serving run cycles through: ``pool`` requests of
    ``groups`` four-view groups. images [P, G, V, H, W, 3] uint8 in pinned
    host memory; center, scale [P, G, V, 2], is_h36m [P, G] on the device;
    cams {field: [P, G, V, ...]} float32 numpy."""
    p, g, v = cell["pool"], cell["groups"], cell["views"]
    size = cfg["image_size"]
    gen = generator(seed, 1, device)
    images = torch.randint(0, 256, (p, g, v, size[1], size[0], 3), generator=gen,
                           device=device, dtype=torch.uint8)
    pinned = torch.empty(images.shape, dtype=torch.uint8, pin_memory=device.type == "cuda")
    pinned.copy_(images)
    lo, hi = cell["scale"]
    center = (torch.tensor(cell["center_px"], device=device)
              + (torch.rand(p, g, v, 2, generator=gen, device=device) * 2 - 1)
              * cell["center_jitter_px"])
    scale = (lo + (hi - lo) * torch.rand(p, g, v, 1, generator=gen, device=device)).expand(
        p, g, v, 2).contiguous()
    is_h36m = torch.stack([_mix(g, cell["h36m_share"], gen, device) for _ in range(p)])
    rings = camera_rings(cell["camera"], p * g, seed, 2)
    cams = {k: a.reshape((p, g) + a.shape[1:]) for k, a in rings.items()}
    return {"images": pinned, "center": center, "scale": scale, "is_h36m": is_h36m,
            "cams": cams}


def _mix(groups: int, share: float, gen, device):
    """[groups] 1.0 for H36M and 0.0 for MPII: round(share * groups) H36M
    groups in a seeded order."""
    n = int(round(share * groups))
    flags = torch.zeros(groups, device=device)
    flags[torch.randperm(groups, generator=gen, device=device)[:n]] = 1.0
    return flags


def train_pool(cell: dict, cfg: dict, seed: int, device) -> list[dict]:
    """``pool`` supervised batches of ``groups`` four-view groups, every row
    its own draw: normal images [G, V, H, W, 3], Gaussian targets [G, V, h,
    w, J] of deviation ``sigma`` map pixels at joints drawn uniformly
    ``margin`` pixels inside the map, unit joint weights, the H36M / MPII
    mix of ``h36m_share``, and the crop geometry (center, scale) the batch
    contract carries."""
    g, v, j = cell["groups"], cell["views"], cfg["num_joints"]
    size, hm = cfg["image_size"], cfg["heatmap_size"]
    gen = generator(seed, 1, device)
    m, sigma = cell["margin"], cell["sigma"]
    ys = torch.arange(hm[1], device=device, dtype=torch.float32).view(1, 1, hm[1], 1, 1)
    xs = torch.arange(hm[0], device=device, dtype=torch.float32).view(1, 1, 1, hm[0], 1)
    out = []
    for _ in range(cell["pool"]):
        images = torch.randn(g, v, size[1], size[0], 3, generator=gen, device=device)
        jx = m + (hm[0] - 1 - 2 * m) * torch.rand(g, v, 1, 1, j, generator=gen, device=device)
        jy = m + (hm[1] - 1 - 2 * m) * torch.rand(g, v, 1, 1, j, generator=gen, device=device)
        target = torch.exp(-((xs - jx) ** 2 + (ys - jy) ** 2) / (2 * sigma * sigma))
        out.append({"images": images, "target": target,
                    "weight": torch.ones(g, v, j, device=device),
                    "is_h36m": _mix(g, cell["h36m_share"], gen, device),
                    "center": torch.full((g, v, 2), cell["center_px"][0], device=device),
                    "scale": torch.full((g, v, 2), sum(cell["scale"]) / 2, device=device)})
    return out

