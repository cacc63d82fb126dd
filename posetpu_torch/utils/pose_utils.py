"""Offline pose-fitting utilities (lib/utils/pose_utils.py:12-143):
weak-perspective camera estimation by SVD, 3D-to-2D alignment and
MATLAB-style Procrustes, in numpy on the host, as the reference's offline
analysis tools are (the JAX package's are the same numpy)."""

from __future__ import annotations

import numpy as np


def estimate_camera(pose3d, pose2d):
    """Fit a weak-perspective camera (R 2x3 row-orthonormal, t, s) mapping
    pose3d [J, 3] onto pose2d [J, 2] in the least-squares sense."""
    x3 = pose3d - pose3d.mean(axis=0)
    x2 = pose2d - pose2d.mean(axis=0)
    # solve for M [2, 3]: x2 ~ s * M x3 with M row-orthonormal
    a, _, _, _ = np.linalg.lstsq(x3, x2, rcond=None)
    m = a.T  # [2, 3]
    u, s, vt = np.linalg.svd(m)
    r = u @ np.eye(2, 3) @ vt  # closest row-orthonormal matrix
    scale = s.mean()
    t = pose2d.mean(axis=0) - scale * (r @ pose3d.mean(axis=0))
    return r, t, scale


def align_3d_to_2d(pose3d, pose2d):
    """Project pose3d with the fitted weak-perspective camera."""
    r, t, s = estimate_camera(pose3d, pose2d)
    return s * (pose3d @ r.T) + t


def procrustes(X, Y, scaling: bool = True, reflection: str = "best"):
    """MATLAB-style Procrustes: transform Y to best fit X.

    Returns (d, Z, tform) with normalized residual d, transformed Z, and
    tform = {'rotation', 'scale', 'translation'}.
    """
    n, m = X.shape
    ny, my = Y.shape
    mu_x = X.mean(0)
    mu_y = Y.mean(0)
    x0 = X - mu_x
    y0 = Y - mu_y
    ss_x = (x0**2).sum()
    ss_y = (y0**2).sum()
    norm_x = np.sqrt(ss_x)
    norm_y = np.sqrt(ss_y)
    x0 /= norm_x
    y0 /= norm_y
    if my < m:
        y0 = np.concatenate((y0, np.zeros((n, m - my))), axis=1)
    a = x0.T @ y0
    u, s, vt = np.linalg.svd(a, full_matrices=False)
    v = vt.T
    t = v @ u.T
    if reflection != "best":
        have_reflection = np.linalg.det(t) < 0
        if reflection != have_reflection:
            v[:, -1] *= -1
            s[-1] *= -1
            t = v @ u.T
    trace_ta = s.sum()
    if scaling:
        b = trace_ta * norm_x / norm_y
        d = 1 - trace_ta**2
        z = norm_x * trace_ta * (y0 @ t) + mu_x
    else:
        b = 1
        d = 1 + ss_y / ss_x - 2 * trace_ta * norm_y / norm_x
        z = norm_y * (y0 @ t) + mu_x
    if my < m:
        t = t[:my, :]
    c = mu_x - b * (mu_y @ t)
    return d, z, {"rotation": t, "scale": b, "translation": c}
