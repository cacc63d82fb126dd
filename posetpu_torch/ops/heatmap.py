"""Heatmap targets, decoding and flip-test moves, row-major, S-minor and
phase-packed.

The int8 serving tail's heatmaps never exist in row-major order: the fused
tail writes them phase-packed (:func:`phase_index_tables`), and
:func:`decode_heatmaps_packed` decodes them there with the reference's
row-major first-occurrence argmax (lib/core/inference.py:19-75);
:func:`flip_back_packed` and :func:`shift_heatmap_right_packed` are the
flip test's W-reversal and right-shift as static moves in that order.

The float path keeps PyTorch's [..., J, H, W] maps: :func:`max_preds`,
:func:`decode_heatmaps` (the plain version of the B7 kernel,
ops/decode.py), :func:`flip_back`, :func:`shift_heatmap_right`; the JAX
package's channels-last and S-minor twins (``*_hwj``, ``*_jns``) are the
same moves on [..., H, W, J] and [J, ..., S] maps.

Training: :func:`render_gaussian_heatmaps` (the targets) and
:func:`soft_argmax_2d` (the differentiable decode of the fundamental loss).
"""

from __future__ import annotations

import numpy as np
import torch


def max_preds(heatmaps):
    """Argmax decode: coords (x, y) + max value, coords zeroed where
    max <= 0 (reference: get_max_preds, inference.py:19-47). heatmaps:
    [..., H, W]; the first row-major index wins among equal maxima."""
    h, w = heatmaps.shape[-2:]
    flat = heatmaps.reshape(heatmaps.shape[:-2] + (h * w,))
    maxvals = flat.amax(dim=-1)
    iota = torch.arange(h * w, device=flat.device)
    idx = torch.where(flat == maxvals[..., None], iota, h * w).amin(dim=-1)
    idx = torch.clamp(idx, max=h * w - 1)
    coords = torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)
    return coords * (maxvals > 0.0).float()[..., None], maxvals


def decode_heatmaps(heatmaps, post_process: bool = True):
    """Argmax + quarter-pixel offset decode in heatmap coordinates: where
    the peak is strictly inside [2, W-2) x [2, H-2), nudge 0.25 px toward the
    larger neighbour along each axis (get_final_preds, inference.py:57-66).

    heatmaps: [..., H, W]. Returns coords [..., 2] (x, y) and maxvals [...].
    """
    coords, maxvals = max_preds(heatmaps)
    if not post_process:
        return coords, maxvals
    h, w = heatmaps.shape[-2:]
    flat = heatmaps.reshape(heatmaps.shape[:-2] + (h * w,))
    px, py = coords[..., 0].long(), coords[..., 1].long()

    def at(dy, dx):
        yy = torch.clamp(py + dy, 0, h - 1)
        xx = torch.clamp(px + dx, 0, w - 1)
        return torch.gather(flat, -1, (yy * w + xx)[..., None])[..., 0]

    diff_x = at(0, 1) - at(0, -1)
    diff_y = at(1, 0) - at(-1, 0)
    ok = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    offs = 0.25 * torch.stack([torch.sign(diff_x), torch.sign(diff_y)], dim=-1)
    return coords + offs * ok.float()[..., None], maxvals


def _decode_rows(flat, w: int, post_process: bool):
    """The S-minor decode of the JAX package's ``decode_heatmaps_jns`` /
    ``_hwj`` over rows flat [..., S] of row-major maps w wide. Unlike
    :func:`decode_heatmaps` (and B7, and the reference), the quarter-pixel
    nudge is taken at the argmax itself, so a map whose maximum is <= 0
    decodes to (0, 0) plus that nudge; on every other map the two agree."""
    s = flat.shape[-1]
    h = s // w
    maxvals = flat.amax(dim=-1)
    iota = torch.arange(s, device=flat.device)
    idx = torch.clamp(torch.where(flat == maxvals[..., None], iota, s).amin(dim=-1), max=s - 1)
    px, py = idx % w, idx // w
    coords = torch.stack([px.float(), py.float()], dim=-1) * (maxvals > 0.0).float()[..., None]
    if not post_process:
        return coords, maxvals

    def at(dy, dx):
        yy = torch.clamp(py + dy, 0, h - 1)
        xx = torch.clamp(px + dx, 0, w - 1)
        return torch.gather(flat, -1, (yy * w + xx)[..., None])[..., 0]

    diff_x = at(0, 1) - at(0, -1)
    diff_y = at(1, 0) - at(-1, 0)
    ok = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    offs = 0.25 * torch.stack([torch.sign(diff_x), torch.sign(diff_y)], dim=-1)
    return coords + offs * ok.float()[..., None], maxvals


def decode_heatmaps_hwj(heatmaps, post_process: bool = True):
    """Decode of channels-last [..., H, W, J] maps (see :func:`_decode_rows`).
    Returns coords [..., J, 2] and maxvals [..., J]."""
    h, w, j = heatmaps.shape[-3:]
    rows = heatmaps.reshape(heatmaps.shape[:-3] + (h * w, j)).transpose(-1, -2)
    return _decode_rows(rows, w, post_process)


def decode_heatmaps_jns(heatmaps, hw, post_process: bool = True):
    """Decode of S-minor [J, ..., S] maps, S = h*w row-major, ``hw`` =
    (h, w) (see :func:`_decode_rows`). Returns coords [J, ..., 2] and
    maxvals [J, ...]."""
    return _decode_rows(heatmaps, int(hw[1]), post_process)


def _swapped(j: int, flip_pairs, device):
    order = list(range(j))
    for a, b in flip_pairs:
        order[a], order[b] = order[b], order[a]
    return torch.as_tensor(order, dtype=torch.int64, device=device)


def flip_back(heatmaps, flip_pairs):
    """Un-flip heatmaps from a horizontally flipped input: reverse the W axis
    and swap left/right joints (reference: flip_back_th, transforms.py:33-47).
    heatmaps: [..., J, H, W]; flip_pairs: (a, b) joint index pairs."""
    order = _swapped(heatmaps.shape[-3], flip_pairs, heatmaps.device)
    return heatmaps.flip(-1).index_select(-3, order)


def shift_heatmap_right(heatmaps):
    """Shift [..., H, W] maps one pixel right, duplicating the first column:
    the flip-test alignment trick (reference: function.py:575-580)."""
    return torch.cat([heatmaps[..., :, :1], heatmaps[..., :, :-1]], dim=-1)


def flip_back_jns(heatmaps, flip_pairs, hw):
    """:func:`flip_back` for S-minor [J, ..., S] maps: the joint swap on the
    leading axis, the W-reversal inside S."""
    h, w = int(hw[0]), int(hw[1])
    order = _swapped(heatmaps.shape[0], flip_pairs, heatmaps.device)
    x = heatmaps.reshape(heatmaps.shape[:-1] + (h, w)).flip(-1)
    return x.reshape(heatmaps.shape).index_select(0, order)


def shift_heatmap_right_jns(heatmaps, hw):
    """:func:`shift_heatmap_right` for S-minor [..., S] maps."""
    h, w = int(hw[0]), int(hw[1])
    x = heatmaps.reshape(heatmaps.shape[:-1] + (h, w))
    return shift_heatmap_right(x).reshape(heatmaps.shape)


def flip_back_packed(heatmaps, flip_pairs, hw, levels: int = 1):
    """:func:`flip_back` over phase-PACKED [J, ..., S] maps
    (:func:`phase_index_tables` order). The W-reversal decomposes into
    static moves: x = 2j+b maps to w-1-x = 2(bw-1-j) + (1-b), so phase
    column b swaps and the within-phase column reverses. ``levels=2``:
    x = 4j + 2be + b2 maps to 4(bw-1-j) + 2(1-be) + (1-b2), so b2, be and j
    all reverse."""
    h, w = int(hw[0]), int(hw[1])
    order = _swapped(heatmaps.shape[0], flip_pairs, heatmaps.device)
    lead = heatmaps.shape[:-1]
    n = len(lead)
    if levels == 1:
        x = heatmaps.reshape(lead + (2, 2, h // 2, w // 2)).flip(n + 1, n + 3)
    else:
        # dims (..., a2, b2, al, be, i, j): reverse b2, be, j
        x = heatmaps.reshape(lead + (2, 2, 2, 2, h // 4, w // 4)).flip(
            n + 1, n + 3, n + 5)
    return x.reshape(heatmaps.shape).index_select(0, order)


def shift_heatmap_right_packed(heatmaps, hw, levels: int = 1):
    """:func:`shift_heatmap_right` over phase-PACKED [..., S] maps. One pixel
    right sends phase b=0 -> b=1 at the same within-phase column and b=1 ->
    b=0 at column j+1 (first column duplicated). ``levels=2``: new(b2=1) =
    old(b2=0) in place, new(b2=0, be=1) = old(b2=1, be=0), new(b2=0, be=0) =
    old(b2=1, be=1) at column j-1."""
    h, w = int(hw[0]), int(hw[1])
    lead = heatmaps.shape[:-1]
    if levels == 1:
        x = heatmaps.reshape(lead + (2, 2, h // 2, w // 2))
        b0, b1 = x[..., 0, :, :], x[..., 1, :, :]  # [..., 2(a), bh, bw]
        new_b0 = torch.cat([b0[..., :1], b1[..., :-1]], dim=-1)
        return torch.stack([new_b0, b0], dim=-3).reshape(heatmaps.shape)
    # dims (..., a2, b2, al, be, i, j)
    x = heatmaps.reshape(lead + (2, 2, 2, 2, h // 4, w // 4))
    b20, b21 = x[..., 0, :, :, :, :], x[..., 1, :, :, :, :]
    # new(b2=0, be=0, j) = old(b2=1, be=1, j-1); j=0 duplicates pixel x=0
    nb00 = torch.cat([b20[..., 0:1, :, :1], b21[..., 1:2, :, :-1]], dim=-1)
    nb01 = b21[..., 0:1, :, :]  # new(b2=0, be=1, j) = old(b2=1, be=0, j)
    new_b20 = torch.cat([nb00, nb01], dim=-3)
    return torch.stack([new_b20, b20], dim=-5).reshape(heatmaps.shape)


def phase_index_tables(hw, levels: int = 1):
    """Static index tables tying the phase-packed heatmap layout to the
    row-major one.

    ``levels=1``: packed index p = (2a+b)*bh*bw + i*bw + j is the row-major
    pixel (y, x) = (2i+a, 2j+b) — the last deconv's phase groups.

    ``levels=2``: the two-level packing of the deconv1 + deconv2 fused tail:
    p = (((2*a2+b2)*4 + 2*al+be) * bh*bw) + i*bw + j (bh = h//4) is pixel
    (y, x) = (4i + 2*al + a2, 4j + 2*be + b2) — (a2, b2) indexes deconv2's
    phase, (al, be) the parity of deconv1's phase plane.

    Returns dict of [h*w] int32 numpy arrays: ``rowmajor`` (row-major index
    of packed position p) and ``packed`` (packed position of row-major
    index r), plus ``levels``.
    """
    h, w = int(hw[0]), int(hw[1])
    if levels == 1:
        bh, bw = h // 2, w // 2
        g, i, j = np.meshgrid(np.arange(4), np.arange(bh), np.arange(bw),
                              indexing="ij")
        a, b = g // 2, g % 2
        rowmajor = ((2 * i + a) * w + (2 * j + b)).reshape(-1)
    else:
        if levels != 2 or h % 4 or w % 4:
            raise ValueError(f"levels=2 packing needs h, w % 4 == 0, got {hw}")
        bh, bw = h // 4, w // 4
        g, p, i, j = np.meshgrid(np.arange(4), np.arange(4), np.arange(bh),
                                 np.arange(bw), indexing="ij")
        a2, b2 = g // 2, g % 2
        al, be = p // 2, p % 2
        rowmajor = ((4 * i + 2 * al + a2) * w
                    + (4 * j + 2 * be + b2)).reshape(-1)
    rowmajor = rowmajor.astype(np.int32)
    packed = np.empty(h * w, np.int32)
    packed[rowmajor] = np.arange(h * w, dtype=np.int32)
    return {"rowmajor": rowmajor, "packed": packed, "levels": levels}


def decode_heatmaps_packed(heatmaps, tables, hw, post_process: bool = True):
    """Argmax + quarter-pixel offset decode over PHASE-PACKED [J, ..., S]
    maps, with the exact row-major first-occurrence tie-break of the
    reference's argmax: the max is found over the packed axis, then the
    winning index is the MINIMUM row-major position among the hits.

    Returns coords [J, ..., 2] in row-major (x, y) pixels and maxvals.
    """
    h, w = int(hw[0]), int(hw[1])
    dev = heatmaps.device
    rtab = torch.as_tensor(tables["rowmajor"], dtype=torch.int64, device=dev)
    ptab = torch.as_tensor(tables["packed"], dtype=torch.int64, device=dev)
    maxvals = heatmaps.amax(dim=-1)
    hit = heatmaps == maxvals[..., None]
    r = torch.where(hit, rtab, h * w).amin(dim=-1)
    r = torch.clamp(r, max=h * w - 1)
    px, py = r % w, r // w
    coords = torch.stack([px.float(), py.float()], dim=-1)
    coords = coords * (maxvals > 0.0).float()[..., None]
    if not post_process:
        return coords, maxvals

    def at(dy, dx):
        yy = torch.clamp(py + dy, 0, h - 1)
        xx = torch.clamp(px + dx, 0, w - 1)
        p = ptab[yy * w + xx]
        return torch.gather(heatmaps, -1, p[..., None])[..., 0]

    diff_x = at(0, 1) - at(0, -1)
    diff_y = at(1, 0) - at(-1, 0)
    ok = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    offs = 0.25 * torch.stack([torch.sign(diff_x), torch.sign(diff_y)], dim=-1)
    return coords + offs * ok.float()[..., None], maxvals


def render_gaussian_heatmaps(joints, joints_vis, heatmap_size, image_size, sigma):
    """Gaussian target heatmaps with the reference's integer centres
    (joints_dataset_compatible.py:207-253): the centre is
    ``trunc(x / stride + 0.5)`` (``int()`` truncates toward 0), the Gaussian
    ``exp(-d^2 / (2 sigma^2))`` is cut to a +-3 sigma window, and a joint
    whose window misses the map gets weight 0.

    joints [..., J, 2] in input-image pixels, joints_vis [..., J] (0/1),
    heatmap_size and image_size (W, H), sigma in heatmap pixels. Returns
    target [..., J, H, W] f32 and weight [..., J] f32.
    """
    joints = torch.as_tensor(joints, dtype=torch.float32)
    vis = torch.as_tensor(joints_vis, dtype=torch.float32, device=joints.device)
    hw, hh = int(heatmap_size[0]), int(heatmap_size[1])
    iw, ih = float(image_size[0]), float(image_size[1])
    tmp = 3 * sigma
    stride = torch.tensor([iw / hw, ih / hh], dtype=torch.float32, device=joints.device)
    mu = torch.trunc(joints / stride + 0.5)
    mux, muy = mu[..., 0], mu[..., 1]
    inside = (mux - tmp < hw) & (muy - tmp < hh) & (mux + tmp + 1 >= 1) & (muy + tmp + 1 >= 1)
    weight = vis * inside.float()
    xs = torch.arange(hw, dtype=torch.float32, device=joints.device)
    ys = torch.arange(hh, dtype=torch.float32, device=joints.device)[:, None]
    dx = xs - mux[..., None, None]
    dy = ys - muy[..., None, None]
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    support = (dx.abs() <= tmp) & (dy.abs() <= tmp)
    target = g * support.float() * (weight[..., None, None] > 0.5).float()
    return target, weight


def soft_argmax_2d(heatmaps, temperature: float = 100.0):
    """Differentiable expected-coordinate decode (integral pose regression,
    generate_integral_preds_2d_th, lib/utils/transforms.py:149-171): the
    maps scaled by ``temperature``, softmaxed over H*W, and the (x, y)
    expectation taken. heatmaps [..., H, W] -> [..., 2]."""
    h, w = heatmaps.shape[-2:]
    flat = heatmaps.reshape(heatmaps.shape[:-2] + (h * w,)) * temperature
    p = torch.softmax(flat, dim=-1).reshape(heatmaps.shape)
    xs = torch.arange(w, dtype=p.dtype, device=p.device)
    ys = torch.arange(h, dtype=p.dtype, device=p.device)
    return torch.stack([(p.sum(-2) * xs).sum(-1), (p.sum(-1) * ys).sum(-1)], dim=-1)
