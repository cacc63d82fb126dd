"""The plain reference of what a served request returns after the model:
the decode of a heatmap to a joint, the crop's inverse affine, and the
triangulation of a group's joints, in plain PyTorch.

- Decode (``get_final_preds``, lib/core/inference.py): the first row-major
  maximum of each map, nudged a quarter pixel toward the larger neighbour
  along each axis where the peak lies in [2, w-2] x [2, h-2];
  a map whose maximum is <= 0 has no joint.
- Inverse affine (``transform_preds``, lib/utils/transforms.py): the crop
  box of ``scale_x * 200`` px around ``center`` onto the map, without
  rotation, inverted.
- Triangulation: OpenCV's pixel-to-normalised map (10 fixed-point steps of
  undistortion, as ``cv2.undistortPoints``), then the inhomogeneous DLT:
  the world point X minimising the sum over the views that see the joint of
  ``(x P3 - P1) . [X; 1]`` and ``(y P3 - P2) . [X; 1]`` squared, in
  float64; a joint seen by fewer than two views is (0, 0, 0).
"""

from __future__ import annotations

import torch

UNDISTORT_STEPS = 10


def decode(maps):
    """maps [..., J, h, w] -> (coords [..., J, 2] in map pixels (x, y),
    maxvals [..., J])."""
    h, w = maps.shape[-2:]
    flat = maps.reshape(maps.shape[:-2] + (h * w,))
    maxvals, idx = flat.max(dim=-1)  # the first maximum
    px, py = idx % w, idx // w
    coords = torch.stack([px, py], dim=-1).to(maps.dtype)

    def at(dy, dx):
        yy, xx = (py + dy).clamp(0, h - 1), (px + dx).clamp(0, w - 1)
        return torch.gather(flat, -1, (yy * w + xx)[..., None])[..., 0]

    inside = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    dx = torch.sign(at(0, 1) - at(0, -1)) * 0.25
    dy = torch.sign(at(1, 0) - at(-1, 0)) * 0.25
    nudge = torch.stack([dx, dy], dim=-1) * inside[..., None].to(maps.dtype)
    seen = (maxvals > 0)[..., None].to(maps.dtype)
    return (coords + nudge) * seen, maxvals


def map_to_image(coords, center, scale, map_w: int):
    """Map pixels -> source-image pixels; center, scale [..., 2] broadcast
    over the joints axis of ``coords`` [..., J, 2]."""
    s = (scale[..., 0] * 200.0 / map_w)[..., None, None]
    return coords * s + center[..., None, :] - s * (map_w / 2.0)


def image_to_map(pix, center, scale, map_w: int):
    """The inverse of :func:`map_to_image`."""
    s = (scale[..., 0] * 200.0 / map_w)[..., None, None]
    return (pix - center[..., None, :]) / s + map_w / 2.0


def _distortion(y, k, p):
    x0, x1 = y[..., 0], y[..., 1]
    r2 = x0 * x0 + x1 * x1
    radial = 1 + k[..., 0:1] * r2 + k[..., 1:2] * r2 ** 2 + k[..., 2:3] * r2 ** 3
    dx = 2 * p[..., 0:1] * x0 * x1 + p[..., 1:2] * (r2 + 2 * x0 * x0)
    dy = p[..., 0:1] * (r2 + 2 * x1 * x1) + 2 * p[..., 1:2] * x0 * x1
    return radial, dx, dy


def triangulate(pix, cams: dict, seen, dtype=torch.float64):
    """pix [G, V, J, 2] image pixels; cams {R [G, V, 3, 3], T [G, V, 3]
    (x_cam = R (x - T)), f, c [G, V, 2], k [G, V, 3], p [G, V, 2]}; seen
    [G, V, J] bool -> points [G, J, 3], world units, computed in ``dtype``
    (a 16-bit type forms the normal equations in it and solves them in
    float32)."""
    d = dtype
    pix = pix.to(d)
    c = {k: v.to(d) for k, v in cams.items()}
    yd = (pix - c["c"][:, :, None]) / c["f"][:, :, None]
    y = yd
    for _ in range(UNDISTORT_STEPS):
        radial, dx, dy = _distortion(y, c["k"], c["p"])
        y = torch.stack([(yd[..., 0] - dx) / radial, (yd[..., 1] - dy) / radial], dim=-1)
    t = -torch.einsum("gvij,gvj->gvi", c["R"], c["T"])
    P = torch.cat([c["R"], t[..., None]], dim=-1)[:, :, None]  # [G, V, 1, 3, 4]
    rows = torch.cat([y[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                      y[..., 1:2] * P[..., 2, :] - P[..., 1, :]], dim=1)  # [G, 2V, J, 4]
    wgt = torch.cat([seen, seen], dim=1).to(d)  # [G, 2V, J]
    a, b = rows[..., :3], rows[..., 3]
    lhs = torch.einsum("grji,grjk,grj->gjik", a, a, wgt)
    rhs = -torch.einsum("grji,grj,grj->gji", a, b, wgt)
    enough = seen.sum(dim=1) >= 2  # [G, J]
    if d.itemsize < 4:
        lhs, rhs = lhs.float(), rhs.float()
    eye = torch.eye(3, dtype=lhs.dtype, device=pix.device)
    lhs = torch.where(enough[..., None, None], lhs, eye)
    pts = torch.linalg.solve(lhs, rhs)
    return pts * enough[..., None].to(pts.dtype)
