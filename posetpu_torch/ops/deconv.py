"""The fused int8 subpixel transposed conv with row-major output (B9a) and
the same with the 1x1 head (B9b): hand-written CUDA kernels, instances of
the phase-form kernel of ``csrc/tail2.cu`` (B1's), with their plain
PyTorch versions beside them.

Ports posetpu/ops/pallas/deconv.py with the same contracts:

- ``fused_subpixel_deconv(x [N, H*W, Cin] int8, args, h=, w=)`` (B9a) ->
  int8 [N, 4*H*W, Cout], the row-major 2H x 2W image: four 2x2 phase convs,
  ``clip(round(acc * v[0] + v[1]), 0, 127)``, depth-to-space;
- ``fused_subpixel_deconv_head`` (B9b): the same, then the 1x1 head on the
  interleaved int8 rows, ``acc * vh[0] + vh[1]`` -> f32 [N, 4*H*W, J].

(``ops/phase_tail.fused_subpixel_deconv`` is another function: B6, the
N-minor deconv of the phase tail, with the two-step requant.) With Wf
the flipped [4, 4, I, O] kernel, output y[2i+a, 2j+b] =
sum_{u,v in {0,1}} Wf[a+2u, b+2v] . x[i+a-1+u, j+b-1+v], x zero outside.

Scale and bias arrive pre-divided by the output scale
(:func:`build_deconv_args`, numpy, the JAX package's order of operations) and
the sum is rounded once; multiply and add round separately. On a CUDA tensor
a wrapper launches its kernel (counted in ``launches``) or raises; on a CPU
tensor it runs the plain version.

The design, picked by shape (:func:`deconv_design`): where the input tile's
halo fits a block's shared memory with the folded epilogue (Cin up to about
960, deconv1 and deconv2 + head at serving), the resident halo of B1's
kernel; otherwise (deconv0, Cin 2048) the input streamed through the ring,
:data:`STREAM_DESIGN` with :func:`stream_sets` (phase, n-half) pairs a block
and :data:`STREAM_STAGES` ring stages (ops/phase_tail's, B2's too).
:func:`deconv_device_args` tiles the
weights into that design's stage images (``wt``) beside the K-minor
[phase, tap, Cout, Cin] ``w`` the plain version reads, and pads the head
(``wht``). Shapes the kernels take: Cin % 32 == 0, Cout % 8 == 0, J <= 32, a head only after a deconv whose halo
fits; any batch and image size. A wrapper raises ``ValueError`` on anything
else.
"""

from __future__ import annotations

import numpy as np
import torch

from posetpu_torch.ops.int_mm import int_mm
from posetpu_torch.ops.phase_tail import (
    STREAM_DESIGN,
    STREAM_STAGES,
    _k_minor,
    _np,
    _to,
    halo_fits,
    launch_tail2,
    pad_head,
    phase_sums,
    sm_count,
    stream_sets,
    subpixel_interleave_packed_nmajor,
    tile_phase_weight,
)


# ------------------------------------------------------------ plain versions


def subpixel_deconv_plain(x, args, *, h: int, w: int):
    """Plain version of :func:`fused_subpixel_deconv`."""
    n, hw, cin = x.shape
    cout = args["w"].shape[2]
    v = args["v"].reshape(2, 4, cout)
    z = [torch.clamp(torch.round(acc.float() * v[0, g] + v[1, g]), 0.0, 127.0)
         .to(torch.int8).reshape(n, h, w, cout)
         for g, acc in enumerate(phase_sums(x.reshape(n, h, w, cin), args["w"]))]
    y = subpixel_interleave_packed_nmajor(torch.stack(z))  # [N, 2H, 2W, Cout]
    return y.reshape(n, 4 * hw, cout)


def subpixel_deconv_head_plain(x, args, *, h: int, w: int):
    """Plain version of :func:`fused_subpixel_deconv_head`."""
    yq = subpixel_deconv_plain(x, args, h=h, w=w)  # [N, 4*H*W, Cout] int8
    n, p, cout = yq.shape
    y = int_mm(yq.reshape(n * p, cout), args["wh"].t())
    return (y.float() * args["vh"][0] + args["vh"][1]).reshape(n, p, -1)


# ------------------------------------------------------------ the wrappers


def deconv_design(cin: int, cout: int, joints: int = 0) -> str:
    """The design the kernels take at these widths: ``"halo"`` where the
    resident halo fits with the folded epilogue (and the head's J), else
    :data:`STREAM_DESIGN`."""
    jt = 0 if not joints else (2 if joints <= 16 else 4)
    return "halo" if halo_fits(cin, cout, jt, folded=True) else STREAM_DESIGN


def _launch(x, args, h, w, head: bool, what):
    n, hw, cin = x.shape
    wk = args["w"]
    cout = wk.shape[2]
    if hw != h * w:
        raise ValueError(f"{what}: x has {hw} pixels per image, not {h}x{w}")
    if (x.dtype != torch.int8 or wk.dtype != torch.int8 or wk.shape != (4, 4, cout, cin)
            or (head and args["wh"].dtype != torch.int8)):
        raise ValueError(f"{what}: unsupported x {x.dtype} {tuple(x.shape)}, "
                         f"w {wk.dtype} {tuple(wk.shape)}")
    joints = args["wh"].shape[0] if head else 0
    design = deconv_design(cin, cout, joints)
    if head and design != "halo":
        raise ValueError(f"{what}: a head follows only a deconv whose input tile fits the "
                         f"resident halo; Cin {cin}, Cout {cout} does not")
    if head and (args["wh"].shape != (joints, cout) or args["vh"].shape != (2, joints)):
        raise ValueError(f"{what}: unsupported head wh {tuple(args['wh'].shape)}, "
                         f"vh {tuple(args['vh'].shape)}")
    stream = design != "halo"
    out = launch_tail2(x.reshape(n, h, w, cin), args["wt"], args["v"], None,
                       args["wht"] if head else None, args["vh"] if head else None,
                       epilogue="folded", design=design,
                       sets=stream_sets(n, h, w, cout, sm_count(x.device.index)) if stream
                       else None,
                       stages=STREAM_STAGES if stream else None, what=what)
    return out if head else out.reshape(n, 4 * hw, cout)


def fused_subpixel_deconv(x, args, *, h: int, w: int):
    """x: [N, H*W, Cin] int8 -> [N, 4*H*W, Cout] int8 (2x upsample, row-major).
    ``args`` from :func:`deconv_device_args`."""
    if not x.is_cuda:
        return subpixel_deconv_plain(x, args, h=h, w=w)
    out = _launch(x, args, h, w, False, "fused_subpixel_deconv")
    fused_subpixel_deconv.launches += 1
    return out


fused_subpixel_deconv.launches = 0


def fused_subpixel_deconv_head(x, args, *, h: int, w: int):
    """The last deconv fused with the 1x1 head: [N, H*W, Cin] int8 -> f32
    heatmaps [N, 4*H*W, J]. ``args`` from :func:`deconv_device_args`, with the
    head's ``wh``, ``vh``."""
    if not x.is_cuda:
        return subpixel_deconv_head_plain(x, args, h=h, w=w)
    out = _launch(x, args, h, w, True, "fused_subpixel_deconv_head")
    fused_subpixel_deconv_head.launches += 1
    return out


fused_subpixel_deconv_head.launches = 0


# ------------------------------------------------------------ argument packing


def build_deconv_args(qparams, name: str, s_in: float) -> dict:
    """Pack one deconv's phase-bank weights and folded requant vectors, as
    numpy in the JAX package's layout: w [4 tap, I, 4*O] int8 (phase groups
    (a, b) major in the last axis), v [2, 4*O] f32. The biases tile x4, the
    output scale folds into both."""
    from posetpu_torch.models.quant import subpixel_deconv_weights

    q = qparams
    w = _np(q["weights"][name])
    ws = np.asarray(_np(q["w_scales"][name]), np.float32)
    if w.shape[0] == 4:
        # stored un-decomposed [4, 4, I, O]: the phase split is an exact int8
        # rearrangement; the per-O scales tile across the 4 phase groups
        w = subpixel_deconv_weights(w)  # [2, 2, I, 4O]
        ws = np.tile(ws, 4)
    if w.shape[:2] != (2, 2):
        raise ValueError(f"{name}: a k4 deconv's [4, 4, I, O] or [2, 2, I, 4*O] weights "
                         f"are needed, got {w.shape}")
    b = np.asarray(_np(q["biases"][name]), np.float32)  # [O]
    s_out = float(q["act_scales"][f"{name}.out"])
    scale = s_in * ws / s_out
    bias = np.tile(b, 4) / s_out
    return {
        "w": w.reshape(4, w.shape[2], w.shape[3]),
        "v": np.stack([scale.astype(np.float32), bias.astype(np.float32)]),
    }


def build_head_args(qparams, s_in: float) -> dict:
    """The 1x1 final head folded for :func:`fused_subpixel_deconv_head`, as
    numpy in the JAX package's layout: wh [C, J] int8, vh [2, J] f32."""
    q = qparams
    ws = np.asarray(_np(q["w_scales"]["final"]), np.float32)
    b = np.asarray(_np(q["biases"]["final"]), np.float32)
    return {
        "wh": _np(q["weights"]["final"])[0, 0],
        "vh": np.stack([(s_in * ws).astype(np.float32), b.astype(np.float32)]),
    }


def deconv_device_args(args: dict, device) -> dict:
    """JAX-layout deconv (+ head) args (numpy or arrays) -> the kernels'
    tensors: w [4 phase, 4 tap, Cout, Cin] and wh [J, C] int8 (K-minor, what
    the plain versions read), v [2, 4*Cout] and vh [2, J] f32, and the
    kernel's stage images ``wt`` and padded head ``wht``
    (:func:`with_deconv_weights`)."""
    w = np.asarray(_np(args["w"]))  # [4 tap, I, 4*O]
    taps, cin, o4 = w.shape
    wk = w.reshape(taps, cin, 4, o4 // 4).transpose(2, 0, 3, 1)  # [phase, tap, O, I]
    out = {"w": _to(np.ascontiguousarray(wk), device), "v": _to(args["v"], device)}
    if "wh" in args:
        out["wh"] = _k_minor(args["wh"], device)
        out["vh"] = _to(args["vh"], device)
    return with_deconv_weights(out)


def with_deconv_weights(args: dict) -> dict:
    """``args`` (the K-minor tensors) with the kernel's weights beside them:
    ``wt`` the stage images in the order of the design :func:`deconv_design`
    picks for these widths (the streamed halo's chunked K order, or the
    taps'), and for a head ``wht`` (:func:`ops.phase_tail.pad_head`)."""
    _, _, cout, cin = args["w"].shape
    joints = args["wh"].shape[0] if "wh" in args else 0
    out = dict(args, wt=tile_phase_weight(
        args["w"], chunked=deconv_design(cin, cout, joints) == "stream"))
    if "wh" in args:
        out["wht"] = pad_head(args["wh"])
    return out
