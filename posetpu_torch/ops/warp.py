"""Bilinear affine warp of an image: the crop the reference takes with
``cv2.warpAffine`` (joints_dataset_compatible.py:161-165). cv2 maps each
destination pixel through the inverse affine and samples the source
bilinearly with a zero border; here the same as one gather and lerp."""

from __future__ import annotations

import torch


def bilinear_sample(image, x, y):
    """Sample ``image`` [H, W, C] bilinearly at float coords (x, y) [...],
    zero outside. Returns [..., C]."""
    h, w = image.shape[0], image.shape[1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx = (x - x0)[..., None].to(image.dtype)
    fy = (y - y0)[..., None].to(image.dtype)
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = image[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return v * valid.to(image.dtype)[..., None]

    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x0i + 1) * fx
    bot = tap(y0i + 1, x0i) * (1 - fx) + tap(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy


def affine_warp_image(image, inv_trans, output_size):
    """Warp one [H, W, C] image to [out_h, out_w, C]. ``inv_trans`` [2, 3]
    maps destination pixel coords to source coords
    (``ops/affine.get_affine_transform(..., inv=True)``), as cv2 inverts the
    forward matrix itself; ``output_size`` is (w, h)."""
    out_w, out_h = int(output_size[0]), int(output_size[1])
    inv = torch.as_tensor(inv_trans, dtype=torch.float32, device=image.device)
    dx = torch.arange(out_w, dtype=torch.float32, device=image.device)[None, :]
    dy = torch.arange(out_h, dtype=torch.float32, device=image.device)[:, None]
    sx = inv[0, 0] * dx + inv[0, 1] * dy + inv[0, 2]
    sy = inv[1, 0] * dx + inv[1, 1] * dy + inv[1, 2]
    return bilinear_sample(image, sx, sy)
