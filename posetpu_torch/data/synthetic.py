"""Synthetic multi-camera rigs and poses for tests and benchmarks: a
4-camera H36M-like rig with known intrinsics and distortion, and
ground-truth 3D skeletons, from which the geometry's invariants (GT 2D ->
~0 MPJPE, RANSAC outlier rejection, RPSM refinement) are checkable without
the real data sets. The same seed gives the JAX package's arrays."""

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


def make_poses3d(n_groups: int, n_joints: int = 16, seed: int = 0) -> np.ndarray:
    """Random human-scale 3D point clouds near the rig centre (mm)."""
    rs = np.random.RandomState(seed)
    root = rs.uniform(-500, 500, size=(n_groups, 1, 3))
    root[..., 2] = rs.uniform(800, 1200, size=(n_groups, 1))
    offsets = rs.uniform(-600, 600, size=(n_groups, n_joints, 3))
    return (root + offsets).astype(np.float32)


# Canonical standing pose in the 16-joint MPII order (geometry/body.py
# JOINT_NAMES), mm, z-up, root over the origin: realistic bone lengths, so
# synthetic MPJPE numbers mean mm and RPSM's limb-length prior holds.
CANONICAL_POSE_MM = np.array(
    [
        [-150, 30, 80],     # rank
        [-140, 20, 550],    # rkne
        [-130, 0, 990],     # rhip
        [130, 0, 990],      # lhip
        [140, 20, 550],     # lkne
        [150, 30, 80],      # lank
        [0, 0, 1000],       # root
        [0, -20, 1450],     # thorax
        [0, -30, 1580],     # upper neck
        [0, -20, 1750],     # head top
        [-270, 80, 900],    # rwri
        [-260, 40, 1150],   # relb
        [-220, 0, 1420],    # rsho
        [220, 0, 1420],     # lsho
        [260, 40, 1150],    # lelb
        [270, 80, 900],     # lwri
    ],
    np.float32,
)


def make_skeleton_poses(n_groups: int, seed: int = 0, jitter: float = 40.0) -> np.ndarray:
    """Human skeletons [n_groups, 16, 3] (mm): the canonical pose, a random
    yaw, a root shift and per-joint jitter (bone lengths stay within RPSM's
    limb tolerance)."""
    rs = np.random.RandomState(seed)
    poses = np.empty((n_groups, 16, 3), np.float32)
    for g in range(n_groups):
        ang = rs.uniform(0, 2 * np.pi)
        cs, sn = np.cos(ang), np.sin(ang)
        rot = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]], np.float32)
        p = CANONICAL_POSE_MM @ rot.T
        p += rs.uniform(-jitter, jitter, (16, 3)).astype(np.float32)
        p[:, :2] += rs.uniform(-400, 400, 2).astype(np.float32)
        poses[g] = p
    return poses


def tile_cameras(cams: CameraParams, n_groups: int) -> CameraParams:
    """Tile a [V]-camera rig to [G, V] groups."""
    return cams.map(lambda x: x[None].expand((n_groups,) + x.shape))
