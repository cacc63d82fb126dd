"""Batched multi-view DLT triangulation.

The reference triangulates one point at a time through pymvg's per-point SVD
(lib/multiviews/triangulate.py:57-99). Here every group and joint solves at
once: pixels -> undistorted normalised coords, then the inhomogeneous DLT
as a 3x3 weighted normal-equation solve in metre-scaled coordinates (float32
stays well-conditioned), in closed form.
"""

from __future__ import annotations

import torch

from posetpu_torch.geometry.cameras import (
    CameraParams,
    extrinsic_matrix,
    pixels_to_normalized,
)

# World-unit rescale for DLT conditioning; H36M worlds are in mm.
_T_SCALE = 1000.0


def _solve3(G, r):
    """Closed-form 3x3 symmetric solve G x = r via the adjugate."""
    a, b, c = G[..., 0, 0], G[..., 0, 1], G[..., 0, 2]
    d, e, f = G[..., 1, 1], G[..., 1, 2], G[..., 2, 2]
    ca = d * f - e * e
    cb = c * e - b * f
    cc = b * e - c * d
    cd = a * f - c * c
    ce = b * c - a * e
    cf = a * d - b * b
    det = a * ca + b * cb + c * cc
    inv_det = torch.where(det.abs() > 1e-20, 1.0 / det, torch.zeros_like(det))
    x0 = ca * r[..., 0] + cb * r[..., 1] + cc * r[..., 2]
    x1 = cb * r[..., 0] + cd * r[..., 1] + ce * r[..., 2]
    x2 = cc * r[..., 0] + ce * r[..., 1] + cf * r[..., 2]
    return torch.stack([x0, x1, x2], dim=-1) * inv_det[..., None]


def _dlt_solve(yn, P, w):
    """Inhomogeneous DLT over a batch: rows x*P[2]-P[0], y*P[2]-P[1] give
    A [X; 1] = 0, solved as the weighted least squares M X = -b.

    yn: [G, V, J, 2]; P: [G, V, 3, 4]; w: [G, V, J] (0/1). -> [G, J, 3]."""
    p0, p1, p2 = (P[:, :, None, i, :] for i in range(3))  # [G, V, 1, 4]
    r0 = yn[..., 0:1] * p2 - p0  # [G, V, J, 4]
    r1 = yn[..., 1:2] * p2 - p1
    rows = torch.cat([r0, r1], dim=1)  # [G, 2V, J, 4]
    ww = torch.cat([w, w], dim=1)  # [G, 2V, J]
    m, b = rows[..., :3], rows[..., 3]
    G = torch.einsum("grji,grjk,grj->gjik", m, m, ww)
    r = -torch.einsum("grji,grj,grj->gji", m, b, ww)
    return _solve3(G, r)


def triangulate_points(poses2d, cams: CameraParams, joints_vis=None,
                       no_distortion: bool = False):
    """Triangulate [G, V, J, 2] pixel observations to [G, J, 3] world points.
    Joints with fewer than two visible views return zeros."""
    g, v, j, _ = poses2d.shape
    if joints_vis is None:
        joints_vis = torch.ones((g, v, j), device=poses2d.device)
    joints_vis = joints_vis.float()
    flat = cams.map(lambda x: x.reshape((g * v,) + x.shape[2:]))
    yn = pixels_to_normalized(poses2d.reshape(g * v, j, 2), flat,
                              no_distortion=no_distortion).reshape(g, v, j, 2)
    P = extrinsic_matrix(cams, t_scale=_T_SCALE)  # [G, V, 3, 4]
    pts = _dlt_solve(yn, P, joints_vis) * _T_SCALE  # [G, J, 3]
    enough = joints_vis.sum(dim=1) >= 2  # [G, J]
    return pts * enough[..., None].to(pts.dtype)
