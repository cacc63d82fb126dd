"""Inference pieces of the serving tail: fuse routing and final predictions in
source-image coordinates, over the S-minor [J, N, V, S] heatmap layout.

The reference's ``fuse_routing`` mixes per sample in a Python loop
(function.py:33-45); here it is a masked lerp. ``get_final_preds``
(inference.py:50-75) is the packed decode + inverse affine, batched.
"""

from __future__ import annotations

from posetpu_torch.ops.affine import transform_preds
from posetpu_torch.ops.heatmap import decode_heatmaps_packed


def fuse_routing_jns(raw, fused, is_h36m_mask):
    """Blend ``3/5 * fused + 2/5 * raw`` for h36m samples, raw otherwise.
    raw/fused: [J, N, V, S]; is_h36m_mask: [N]."""
    if fused is None:
        return raw
    m = is_h36m_mask.to(raw.dtype)[None, :, None, None]
    return (0.6 * fused + 0.4 * raw) * m + raw * (1.0 - m)


def final_preds_packed(heatmaps, center, scale, hw, tables,
                       post_process: bool = True):
    """heatmaps: [J, N, V, S] phase-packed; center/scale: [N, V, 2]; hw:
    (h, w). Returns (preds [N, V, J, 2], maxvals [N, V, J])."""
    h, w = int(hw[0]), int(hw[1])
    coords, maxvals = decode_heatmaps_packed(heatmaps, tables, (h, w),
                                             post_process=post_process)
    coords = coords.movedim(0, 2)  # [N, V, J, 2]
    maxvals = maxvals.movedim(0, 2)
    preds = transform_preds(coords, center, scale, (w, h))
    return preds, maxvals
