"""Batched multi-view DLT triangulation, RANSAC filtering and reprojection.

The reference triangulates one point at a time through pymvg's per-point SVD
(lib/multiviews/triangulate.py:57-99), and its RANSAC filter re-triangulates
every view pair of every joint the same way (triangulate.py:102-166). Here
every group and joint solves at once: pixels -> undistorted normalised
coords, then the inhomogeneous DLT as a 3x3 weighted normal-equation solve
in metre-scaled coordinates (float32 stays well-conditioned), in closed
form. RANSAC evaluates all C(4,2) = 6 pair hypotheses densely, the pairs
folded into the group batch, with masks for the data-dependent inlier sets.

Group layout: ``[G, V, ...]`` with V = 4 views a group; the flat ``[G*V,
...]`` wrapper mirrors the reference's call signature.
"""

from __future__ import annotations

import itertools

import torch

from posetpu_torch.geometry.cameras import (
    CameraParams,
    extrinsic_matrix,
    pixels_to_normalized,
    project_points,
)
from posetpu_torch.utils.profiling import span

# World-unit rescale for DLT conditioning; H36M worlds are in mm.
_T_SCALE = 1000.0

# lexicographic, like the reference's itertools.combinations over the
# visible views (triangulate.py:142)
VIEW_PAIRS = tuple(itertools.combinations(range(4), 2))


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
    with span("geometry.triangulate"):
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


def triangulate_poses(poses2d, cams: CameraParams, joints_vis=None,
                      no_distortion: bool = False):
    """The reference's flat signature (triangulate_poses, triangulate.py:
    57-99): poses2d [N, J, 2] with N = G*4 view-major groups, cams leading
    [N] -> [G, J, 3]."""
    n, j, _ = poses2d.shape
    g = n // 4
    cams_g = cams.map(lambda x: x.reshape((g, 4) + x.shape[1:]))
    vis_g = None if joints_vis is None else joints_vis.reshape(g, 4, j)
    return triangulate_points(poses2d.reshape(g, 4, j, 2), cams_g, vis_g, no_distortion)


def ransac_filter(poses2d, cams: CameraParams, joints_vis, reproj_thre: float,
                  num_inliers: int, no_distortion: bool = False):
    """Dense-hypothesis RANSAC pseudo-label filter (triangulate.py:102-166).

    For every (group, joint): triangulate each of the 6 view pairs whose
    views are both visible, reproject to all 4 views, count the inliers
    (error < ``reproj_thre`` on every view, visible or not, as the reference
    checks all views), and keep the best pair's inlier set if it has >=
    ``num_inliers`` members. The best pair has the largest score ``n_in *
    1e6 - mean_err`` in float32, the first such pair on ties (mean errors
    closer than the score's float32 step tie), and pair 0 where no pair is
    admissible.

    poses2d [G, V, J, 2]; joints_vis [G, V, J] -> res_vis [G, V, J] float32.
    """
    g, v, j, _ = poses2d.shape
    dev = poses2d.device
    vis = joints_vis.float()
    pairs = torch.tensor(VIEW_PAIRS, device=dev)  # [6, 2]
    npairs = pairs.shape[0]
    pair_mask = torch.zeros(npairs, v, device=dev)
    pair_mask[torch.arange(npairs, device=dev)[:, None], pairs] = 1.0
    hyp_vis = vis[:, None] * pair_mask[None, :, :, None]  # [G, 6, V, J]

    # the six hypotheses as one batch of G*6 groups
    pts = triangulate_points(
        poses2d[:, None].expand(g, npairs, v, j, 2).reshape(g * npairs, v, j, 2),
        cams.map(lambda x: x[:, None].expand((g, npairs) + x.shape[1:])
                 .reshape((g * npairs,) + x.shape[1:])),
        hyp_vis.reshape(g * npairs, v, j), no_distortion)  # [G*6, J, 3]

    # every hypothesis point reprojected into every view
    proj = project_points(pts.reshape(g, 1, npairs * j, 3), cams, no_distortion)
    proj = proj.reshape(g, v, npairs, j, 2)
    err = torch.linalg.vector_norm(proj - poses2d[:, :, None], dim=-1)  # [G, V, 6, J]
    err = err.movedim(1, 2)  # [G, 6, V, J]
    inlier = (err < reproj_thre).float()
    n_in = inlier.sum(dim=2)  # [G, 6, J]
    mean_err = (err * inlier).sum(dim=2) / n_in.clamp(min=1.0)

    # admissible: both views visible and the inlier quota reached
    both_vis = vis[:, pairs[:, 0]] * vis[:, pairs[:, 1]]  # [G, 6, J]
    valid = both_vis * (n_in >= num_inliers).float() > 0
    score = torch.where(valid, n_in * 1e6 - mean_err,
                        torch.full_like(mean_err, float("-inf")))
    best = score.argmax(dim=1)  # [G, J], the first maximum
    best_inlier = inlier.gather(1, best[:, None, None, :].expand(g, 1, v, j))[:, 0]
    return best_inlier * valid.any(dim=1)[:, None, :].float()


def reproject_poses(poses2d, cams: CameraParams, joints_vis, no_distortion: bool = False):
    """Triangulate from the visible views and write the reprojection back
    into all views (reproject_poses, triangulate.py:169-213).

    poses2d [G, V, J, 2]; joints_vis [G, V, J] -> (proj_2d [G, V, J, 2],
    res_vis [G, V, J])."""
    g, v, j, _ = poses2d.shape
    vis = joints_vis.float()
    pts = triangulate_points(poses2d, cams, vis, no_distortion)  # [G, J, 3]
    proj = project_points(pts[:, None], cams, no_distortion)  # [G, V, J, 2]
    enough = (vis.sum(dim=1) >= 2).float()  # [G, J]
    res_vis = enough[:, None, :].expand(g, v, j)
    return proj * res_vis[..., None], res_vis
