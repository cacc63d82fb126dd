"""Batched affine crop transforms.

The reference derives its 2x3 crop matrix by handing three constructed points
to ``cv2.getAffineTransform`` (lib/utils/transforms.py:76-109). The transform
is always a similarity (uniform scale + rotation + shift), so it is derived
in closed form here, batched over any leading dims:

    A = (out_w / (scale_x*200)) * R(-rot),   t = out_center - A @ src_center.
"""

from __future__ import annotations

import math

import torch


def get_affine_transform(center, scale, rot, output_size, shift=None,
                         inv: bool = False):
    """[..., 2, 3] affine mapping the scaled/rotated person box (extent
    ``scale * 200`` px around ``center``) onto the ``output_size`` (w, h)
    frame; ``inv`` gives the map back to the source image.
    ``pts_dst = A[:, :2] @ pts_src + A[:, 2]``."""
    center = torch.as_tensor(center, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=center.device)
    if scale.dim() == center.dim() - 1:
        scale = torch.stack([scale, scale], dim=-1)
    rot = torch.as_tensor(rot, dtype=torch.float32, device=center.device)
    out_w, out_h = float(output_size[0]), float(output_size[1])

    box = scale * 200.0
    src_center = center if shift is None else center + box * torch.as_tensor(
        shift, dtype=torch.float32, device=center.device)
    dst = (out_w * 0.5, out_h * 0.5)
    rad = rot * (math.pi / 180.0)
    cs, sn = torch.cos(rad), torch.sin(rad)

    if not inv:
        s = out_w / box[..., 0]
        a00, a01, a10, a11 = s * cs, s * sn, -s * sn, s * cs
        tx = dst[0] - (a00 * src_center[..., 0] + a01 * src_center[..., 1])
        ty = dst[1] - (a10 * src_center[..., 0] + a11 * src_center[..., 1])
    else:
        s = box[..., 0] / out_w
        a00, a01, a10, a11 = s * cs, -s * sn, s * sn, s * cs
        tx = src_center[..., 0] - (a00 * dst[0] + a01 * dst[1])
        ty = src_center[..., 1] - (a10 * dst[0] + a11 * dst[1])
    a00, a01, a10, a11 = torch.broadcast_tensors(a00, a01, a10, a11)
    row0 = torch.stack([a00, a01, tx], dim=-1)
    row1 = torch.stack([a10, a11, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def affine_transform_points(points, trans):
    """Apply [..., 2, 3] affines to [..., K, 2] points."""
    lin = torch.einsum("...ij,...kj->...ki", trans[..., :2, :2], points[..., :2])
    return lin + trans[..., None, :2, 2]


def transform_preds(coords, center, scale, output_size):
    """Map heatmap-frame coords back to source-image pixels
    (reference: transform_preds, transforms.py:67-73). coords: [..., K, 2]."""
    trans = get_affine_transform(center, scale, 0.0, output_size, inv=True)
    return affine_transform_points(coords, trans)
