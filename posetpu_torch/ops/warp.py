"""Bilinear affine warp of an image: the crop the reference takes with
``cv2.warpAffine`` (joints_dataset_compatible.py:161-165). cv2 maps each
destination pixel through the inverse affine and samples the source
bilinearly with a zero border; here the same as one gather and lerp, over
one image or a batch of them, each with its own affine."""

from __future__ import annotations

import torch


def _sample(gather, h: int, w: int, dtype, x, y):
    """Bilinear samples at float coords (x, y) [...] of an [H, W] grid whose
    pixels ``gather(yi, xi)`` reads at integer coords [...] (-> [..., C]),
    zero outside."""
    x0, y0 = torch.floor(x), torch.floor(y)
    fx = (x - x0)[..., None].to(dtype)
    fy = (y - y0)[..., None].to(dtype)
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        return gather(yi.clamp(0, h - 1), xi.clamp(0, w - 1)) * valid.to(dtype)[..., None]

    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x0i + 1) * fx
    bot = tap(y0i + 1, x0i) * (1 - fx) + tap(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy


def bilinear_sample(image, x, y):
    """Sample ``image`` [H, W, C] bilinearly at float coords (x, y) [...],
    zero outside. Returns [..., C]."""
    return _sample(lambda yi, xi: image[yi, xi], image.shape[0], image.shape[1], image.dtype,
                   x, y)


def affine_warp_batch(images, inv_trans, output_size):
    """Warp each of ``images`` [B, H, W, C] by its own ``inv_trans`` [B, 2,
    3] to [B, out_h, out_w, C] (the JAX package's ``vmap`` of the single
    warp) as one gather and lerp, with no loop over B. ``inv_trans`` maps
    destination pixel coords to source coords
    (``ops/affine.get_affine_transform(..., inv=True)``), as cv2 inverts the
    forward matrix itself; ``output_size`` is (w, h)."""
    out_w, out_h = int(output_size[0]), int(output_size[1])
    dev = images.device
    inv = torch.as_tensor(inv_trans, dtype=torch.float32, device=dev)[..., None, None]
    dx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    dy = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    sx = inv[:, 0, 0] * dx + inv[:, 0, 1] * dy + inv[:, 0, 2]
    sy = inv[:, 1, 0] * dx + inv[:, 1, 1] * dy + inv[:, 1, 2]
    batch = torch.arange(images.shape[0], device=dev)[:, None, None]
    return _sample(lambda yi, xi: images[batch, yi, xi], images.shape[1], images.shape[2],
                   images.dtype, sx, sy)


def affine_warp_image(image, inv_trans, output_size):
    """Warp one [H, W, C] image to [out_h, out_w, C]: :func:`affine_warp_batch`
    of one."""
    inv = torch.as_tensor(inv_trans, dtype=torch.float32, device=image.device)
    return affine_warp_batch(image[None], inv[None], output_size)[0]
