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
made so first, as the TPU wrapper's reshape + astype does; one that already
is costs nothing). The kernel is a few microseconds on the card, so the
wrapper is kept as short as the kernel: one allocation [..., 3] that the
kernel fills with (x, y, max) and that comes back as two views, the bound C
function kept after its first use, the raw stream handle read without
building a stream object.
"""

from __future__ import annotations

import torch

from posetpu_torch.ops import _build
from posetpu_torch.ops.heatmap import decode_heatmaps
from posetpu_torch.ops.phase_tail import stream_of

_P, _I = _build.P, _build.I
_SIGNATURES = {"decode_heatmaps": [_P, _P, _I, _I, _I, _I, _P]}
_kernel = None  # the bound C function, fetched at the first launch


def split_decoded(out):
    """The kernel's one output [..., 3] (x, y, max per map) as the wrapper's
    two results: coords [..., 2] and maxvals [...], views of ``out`` (each
    keeps the storage alive on its own)."""
    return out.narrow(-1, 0, 2), out.select(-1, 2)


def decode_heatmaps_kernel(heatmaps, post_process: bool = True):
    """heatmaps [..., H, W] -> (coords [..., 2] f32, maxvals [...] f32)."""
    global _kernel
    shape = heatmaps.shape
    if len(shape) < 2 or shape[-1] * shape[-2] == 0:
        raise ValueError(f"decode_heatmaps_kernel: needs [..., H, W] maps with "
                         f"H*W >= 1, got {tuple(shape)}")
    if not heatmaps.is_cuda:
        return decode_heatmaps(heatmaps.float(), post_process=post_process)
    h, w = shape[-2], shape[-1]
    flat = heatmaps
    if flat.dtype is not torch.float32 or not flat.is_contiguous():
        flat = flat.float().contiguous()
    maps = flat.numel() // (h * w)
    if maps >= 2 ** 31 // 3 or h * w >= 2 ** 29:
        raise ValueError(f"decode_heatmaps_kernel: {maps} maps of {h}x{w} "
                         f"exceed the kernel's 32-bit indices")
    out = torch.empty(shape[:-2] + (3,), dtype=torch.float32, device=flat.device)
    if maps:  # an empty leading shape: nothing to launch
        if _kernel is None:
            _kernel = _build.load("decode", _SIGNATURES).decode_heatmaps
        rc = _kernel(flat.data_ptr(), out.data_ptr(), maps, h, w, int(post_process),
                     stream_of(flat))
        if rc:
            _build.check(rc, "decode_heatmaps")
        decode_heatmaps_kernel.launches += 1
    return split_decoded(out)


decode_heatmaps_kernel.launches = 0
