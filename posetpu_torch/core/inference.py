"""Inference pieces: fuse routing, flip-test merge and final predictions in
source-image coordinates.

The reference's ``fuse_routing`` mixes per sample in a Python loop
(function.py:33-45); here it is a masked lerp. The flip-test block
(function.py:567-583) is a pure function over the second forward's
heatmaps. ``get_final_preds`` (inference.py:50-75) is the decode + inverse
affine, batched.

Two layouts: the int8 serving tail's S-minor [J, N, V, S], row-major
(``*_jns``) or phase-packed (``*_packed``), and the float path's
[..., J, h, w] — PyTorch's channels-first maps, where the JAX package's
same-named functions take [..., h, w, J]. :func:`fuse_routing` is
elementwise and takes either 5-D layout.
"""

from __future__ import annotations

from posetpu_torch.ops.affine import transform_preds
from posetpu_torch.ops import decode as _decode
from posetpu_torch.ops.heatmap import (
    decode_heatmaps_packed,
    flip_back,
    flip_back_jns,
    flip_back_packed,
    shift_heatmap_right,
    shift_heatmap_right_jns,
    shift_heatmap_right_packed,
)


def _route(raw, fused, m):
    return (0.6 * fused + 0.4 * raw) * m + raw * (1.0 - m)


def fuse_routing(raw, fused, is_h36m_mask, enabled: bool = True):
    """Blend ``3/5 * fused + 2/5 * raw`` for h36m samples, raw otherwise
    (function.py:33-45). raw/fused: [N, V, J, h, w]; is_h36m_mask: [N]."""
    if fused is None or not enabled:
        return raw
    return _route(raw, fused, is_h36m_mask.to(raw.dtype)[:, None, None, None, None])


def fuse_routing_jns(raw, fused, is_h36m_mask):
    """S-minor twin of :func:`fuse_routing`: raw/fused [J, N, V, S]."""
    if fused is None:
        return raw
    return _route(raw, fused, is_h36m_mask.to(raw.dtype)[None, :, None, None])


def flip_test_merge(output, output_flipped, flip_pairs, shift: bool = False):
    """Average the straight output with the un-flipped flipped-input output
    (function.py:567-583). Heatmaps [..., J, h, w]."""
    of = flip_back(output_flipped, flip_pairs)
    if shift:
        of = shift_heatmap_right(of)
    return 0.5 * (output + of)


def flip_test_merge_jns(output, output_flipped, flip_pairs, hw, shift: bool = False):
    """S-minor twin of :func:`flip_test_merge`: [J, ..., S] maps."""
    of = flip_back_jns(output_flipped, flip_pairs, hw)
    if shift:
        of = shift_heatmap_right_jns(of, hw)
    return 0.5 * (output + of)


def flip_test_merge_packed(output, output_flipped, flip_pairs, hw,
                           shift: bool = False, levels: int = 1):
    """Phase-PACKED twin of :func:`flip_test_merge`: [J, ..., S] maps stay in
    the ``phase_index_tables(levels)`` order; the W-flip and right-shift are
    static phase-group moves (ops/heatmap.flip_back_packed)."""
    of = flip_back_packed(output_flipped, flip_pairs, hw, levels=levels)
    if shift:
        of = shift_heatmap_right_packed(of, hw, levels=levels)
    return 0.5 * (output + of)


def final_preds(heatmaps, center, scale, post_process: bool = True):
    """Decode heatmaps and map to source-image pixels (get_final_preds).

    heatmaps: [..., J, h, w]; center/scale: [..., 2] matching the leading
    dims. Returns (preds [..., J, 2], maxvals [..., J]). A CUDA tensor is
    decoded by the B7 kernel, a CPU tensor by its plain version
    (ops/decode.py): as in the reference, a map whose maximum is <= 0
    decodes to (0, 0) with no quarter-pixel nudge."""
    h, w = heatmaps.shape[-2:]
    coords, maxvals = _decode.decode_heatmaps_kernel(heatmaps, post_process=post_process)
    return transform_preds(coords, center, scale, (w, h)), maxvals


def final_preds_jns(heatmaps, center, scale, hw, post_process: bool = True):
    """S-minor twin of :func:`final_preds`: heatmaps [J, N, V, S] row-major
    in S; center/scale [N, V, 2]; hw (h, w). Each row is one map already, so
    the decode reads them in place: the B7 kernel on a CUDA tensor, its plain
    version on a CPU one. As :func:`final_preds` (and the reference), a map
    whose maximum is <= 0 decodes to (0, 0) with no quarter-pixel nudge; the
    JAX package's ``final_preds_jns`` nudges it (ops/heatmap._decode_rows).
    Returns (preds [N, V, J, 2], maxvals [N, V, J])."""
    h, w = int(hw[0]), int(hw[1])
    coords, maxvals = _decode.decode_heatmaps_kernel(
        heatmaps.reshape(heatmaps.shape[:-1] + (h, w)), post_process=post_process)
    preds = transform_preds(coords.movedim(0, 2), center, scale, (w, h))
    return preds, maxvals.movedim(0, 2)


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
