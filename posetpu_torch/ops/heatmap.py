"""Phase-packed heatmap indexing and decoding.

The serving tail's heatmaps never exist in row-major order: the fused tail
writes them phase-packed (:func:`phase_index_tables`), and
:func:`decode_heatmaps_packed` decodes them there with the reference's
row-major first-occurrence argmax (lib/core/inference.py:19-75).
"""

from __future__ import annotations

import numpy as np
import torch


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
