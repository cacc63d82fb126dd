"""Batched camera models. Two distortion conventions of the reference:

* the H36M one of ``project_point_radial`` (lib/multiviews/cameras.py:25-49):
  the averaged focal and a scalar tangential term applied multiplicatively
  (:func:`project_pose`);
* the OpenCV one of the triangulation stack (lib/multiviews/triangulate.py:
  17-40): per-axis focals and the standard [k1, k2, p1, p2, k3] distortion
  (:func:`project_points`, :func:`undistort_opencv`).

Cameras are a struct of tensors with matching leading batch dims, so every
op runs over any batch of cameras at once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CameraParams(NamedTuple):
    """R [..., 3, 3] world->camera rotation; T [..., 3] camera centre in
    world coords (x_cam = R @ (x - T)); f [..., 2] (fx, fy); c [..., 2]
    principal point; k [..., 3] radial (k1, k2, k3); p [..., 2] tangential."""

    R: torch.Tensor
    T: torch.Tensor
    f: torch.Tensor
    c: torch.Tensor
    k: torch.Tensor
    p: torch.Tensor

    def map(self, fn) -> "CameraParams":
        return CameraParams(*[fn(x) for x in self])

    @staticmethod
    def from_dict(cam: dict) -> "CameraParams":
        """Build from the reference's per-view camera dict ({R, T, fx, fy,
        cx, cy, k, p}, the multiview_h36m annotation format): read as
        float64, then rounded once to float32. CPU tensors."""
        def t(x, *shape):
            a = np.asarray(x, np.float64)
            return torch.from_numpy(a.reshape(shape or a.shape).astype(np.float32))

        return CameraParams(
            R=t(cam["R"]), T=t(cam["T"], 3),
            f=t([np.squeeze(cam["fx"]), np.squeeze(cam["fy"])]),
            c=t([np.squeeze(cam["cx"]), np.squeeze(cam["cy"])]),
            k=t(cam["k"], 3), p=t(cam["p"], 2))

    @staticmethod
    def stack(cams: list["CameraParams"]) -> "CameraParams":
        """Stack cameras along a new leading dim."""
        return CameraParams(*[torch.stack(xs) for xs in zip(*cams)])


def _distortion(yx, yy, k, p):
    r2 = yx * yx + yy * yy
    k1, k2, k3 = k[..., 0:1], k[..., 1:2], k[..., 2:3]
    p1, p2 = p[..., 0:1], p[..., 1:2]
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    dx = 2.0 * p1 * yx * yy + p2 * (r2 + 2.0 * yx * yx)
    dy = p1 * (r2 + 2.0 * yy * yy) + 2.0 * p2 * yx * yy
    return radial, dx, dy


def world_to_camera_frame(x, R, T):
    """[..., N, 3] world points -> the camera frame (cameras.py:57-68)."""
    return torch.einsum("...ij,...nj->...ni", R, x - T[..., None, :])


def camera_to_world_frame(x, R, T):
    """[..., N, 3] camera points -> the world frame (cameras.py:71-82)."""
    return torch.einsum("...ji,...nj->...ni", R, x) + T[..., None, :]


def project_pose(x, cam: CameraParams):
    """The H36M projection (project_point_radial): [..., N, 3] world points
    -> [..., N, 2] pixels, with the averaged focal 0.5 (fx + fy) and the
    scalar tangential term ``p0 y1 + p1 y0``, as the reference."""
    xc = world_to_camera_frame(x, cam.R, cam.T)
    y = xc[..., :2] / xc[..., 2:3]
    r2 = (y * y).sum(-1)
    k1, k2, k3 = cam.k[..., 0:1], cam.k[..., 1:2], cam.k[..., 2:3]
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    tan = cam.p[..., 0:1] * y[..., 1] + cam.p[..., 1:2] * y[..., 0]
    pq = torch.stack([cam.p[..., 1], cam.p[..., 0]], dim=-1)
    y = y * (radial + tan)[..., None] + pq[..., None, :] * r2[..., None]
    favg = 0.5 * (cam.f[..., 0] + cam.f[..., 1])
    return favg[..., None, None] * y + cam.c[..., None, :]


def project_points(x, cam: CameraParams, no_distortion: bool = False):
    """The OpenCV projection (pymvg's find2d): [..., N, 3] world points ->
    [..., N, 2] pixels."""
    xc = world_to_camera_frame(x, cam.R, cam.T)
    y = xc[..., :2] / xc[..., 2:3]
    if not no_distortion:
        y = distort_opencv(y, cam.k, cam.p)
    return y * cam.f[..., None, :] + cam.c[..., None, :]


def distort_opencv(y, k, p):
    """OpenCV's radial and tangential distortion of normalised coords y
    [..., N, 2]; k [..., 3], p [..., 2]."""
    radial, dx, dy = _distortion(y[..., 0], y[..., 1], k, p)
    return torch.stack([y[..., 0] * radial + dx, y[..., 1] * radial + dy], dim=-1)


def undistort_opencv(yd, k, p, iters: int = 10):
    """Invert OpenCV distortion by fixed-point iteration (the cv2/pymvg
    ``undistortPoints`` scheme). yd: [..., N, 2] distorted normalised coords."""
    y = yd
    for _ in range(iters):
        radial, dx, dy = _distortion(y[..., 0], y[..., 1], k, p)
        y = torch.stack([(yd[..., 0] - dx) / radial,
                         (yd[..., 1] - dy) / radial], dim=-1)
    return y


def pixels_to_normalized(pix, cam: CameraParams, no_distortion: bool = False,
                         iters: int = 10):
    """Pixels [..., N, 2] -> undistorted normalised camera coords."""
    y = (pix - cam.c[..., None, :]) / cam.f[..., None, :]
    if no_distortion:
        return y
    return undistort_opencv(y, cam.k, cam.p, iters=iters)


def extrinsic_matrix(cam: CameraParams, t_scale: float = 1.0):
    """[..., 3, 4] matrix P = [R | -R T / t_scale]: x_cam = P @ [x/t_scale; 1]."""
    t = -torch.einsum("...ij,...j->...i", cam.R, cam.T) / t_scale
    return torch.cat([cam.R, t[..., None]], dim=-1)
