"""Synthetic multi-camera rigs for tests and benchmarks: a 4-camera
H36M-like rig with known intrinsics and distortion."""

from __future__ import annotations

import numpy as np
import torch

from posetpu_torch.geometry.cameras import CameraParams


def make_camera_ring(n_cams: int = 4, radius: float = 5000.0,
                     height: float = 1500.0, image_size=(1000, 1000),
                     distortion: bool = True, seed: int = 0,
                     device=None) -> CameraParams:
    """Cameras on a ring looking at the origin, H36M-ish scales (mm), with
    leading dim [n_cams]. The same seed gives the JAX package's rig."""
    rs = np.random.RandomState(seed)
    Rs, Ts, fs, cs, ks, ps = [], [], [], [], [], []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams + 0.3
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        # look-at rotation: camera z axis toward origin (x_cam = R(x - T))
        z = -pos / np.linalg.norm(pos)
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(z, up)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rs.append(np.stack([x, y, z], axis=0))
        Ts.append(pos)
        fs.append(np.array([1100.0, 1100.0]) + rs.uniform(-30, 30, 2))
        cs.append(np.array(image_size, float) / 2 + rs.uniform(-8, 8, 2))
        if distortion:
            ks.append(np.array([-0.20, 0.24, -0.002]) + rs.uniform(-0.01, 0.01, 3))
            ps.append(np.array([-0.001, -0.0008]) + rs.uniform(-5e-4, 5e-4, 2))
        else:
            ks.append(np.zeros(3))
            ps.append(np.zeros(2))
    t = lambda a: torch.as_tensor(np.stack(a), dtype=torch.float32, device=device)
    return CameraParams(t(Rs), t(Ts), t(fs), t(cs), t(ks), t(ps))


def tile_cameras(cams: CameraParams, n_groups: int) -> CameraParams:
    """Tile a [V]-camera rig to [G, V] groups."""
    return cams.map(lambda x: x[None].expand((n_groups,) + x.shape))
