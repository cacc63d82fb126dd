"""Fused heatmap decode (B7): a hand-written CUDA kernel (``csrc/decode.cu``)
with its plain PyTorch version (``ops/heatmap.decode_heatmaps``) beside it.

Ports posetpu/ops/pallas/decode.py's ``decode_heatmaps_pallas``: heatmaps
[..., H, W] -> coords [..., 2] (x, y) in heatmap pixels and maxvals [...].
Per map: the maximum, the first row-major index that attains it, coords
zeroed where the maximum is <= 0, and a quarter-pixel nudge toward the larger
neighbour for peaks strictly inside [2, W-2) x [2, H-2).

On a CUDA tensor the wrapper launches the kernel (counted in
``decode_heatmaps_kernel.launches``); on a CPU tensor it runs the plain
version. The kernel takes any leading shape of a contiguous float32
[..., H, W] tensor with H*W >= 1 (a non-contiguous or non-f32 tensor is
made so first, as the TPU wrapper's reshape + astype does).
"""

from __future__ import annotations

import torch

from posetpu_torch.ops import _build
from posetpu_torch.ops.heatmap import decode_heatmaps

_P, _I = _build.P, _build.I
_SIGNATURES = {"decode_heatmaps": [_P, _P, _P, _I, _I, _I, _I, _P]}


def decode_heatmaps_kernel(heatmaps, post_process: bool = True):
    """heatmaps [..., H, W] -> (coords [..., 2] f32, maxvals [...] f32)."""
    if heatmaps.dim() < 2 or heatmaps.shape[-1] * heatmaps.shape[-2] == 0:
        raise ValueError(f"decode_heatmaps_kernel: needs [..., H, W] maps with "
                         f"H*W >= 1, got {tuple(heatmaps.shape)}")
    if not heatmaps.is_cuda:
        return decode_heatmaps(heatmaps.float(), post_process=post_process)
    lead = heatmaps.shape[:-2]
    h, w = heatmaps.shape[-2:]
    flat = heatmaps.float().contiguous()
    maps = flat.numel() // (h * w)
    if maps >= 2 ** 31 or h * w >= 2 ** 29:
        raise ValueError(f"decode_heatmaps_kernel: {maps} maps of {h}x{w} "
                         f"exceed the kernel's 32-bit indices")
    coords = torch.empty(lead + (2,), dtype=torch.float32, device=flat.device)
    maxvals = torch.empty(lead, dtype=torch.float32, device=flat.device)
    if maps == 0:  # an empty leading shape: nothing to launch
        return coords, maxvals
    lib = _build.load("decode", _SIGNATURES)
    _build.check(lib.decode_heatmaps(
        flat.data_ptr(), coords.data_ptr(), maxvals.data_ptr(), maps, h, w,
        int(post_process), torch.cuda.current_stream(flat.device).cuda_stream),
        "decode_heatmaps")
    decode_heatmaps_kernel.launches += 1
    return coords, maxvals


decode_heatmaps_kernel.launches = 0
