"""The phase-domain deconvolution tail: deconv0 (B2) and deconv1 + deconv2 +
the 1x1 head (B1), each a hand-written CUDA kernel (``csrc/phase_tail.cu``)
with its plain PyTorch version beside it.

Ports posetpu/ops/pallas/phase_tail.py's ``fused_subpixel_deconv_batched``
(B2) and ``fused_phase_tail2`` (B1) with the same contracts:

- ``fused_subpixel_deconv_batched(x [N, H*W, Cin] int8)`` -> int8 phase maps
  [4, N, H, W, Cout], per-phase requant (+ReLU);
- ``fused_phase_tail2(x [N, H*W, Cin] int8)`` -> f32 heatmaps [J, N, 16*H*W]
  in the ``phase_index_tables(levels=2)`` order.

A k4/s2/p1 transposed conv in phase form: output phase g = (a, b), tap
t = (u, v) reads x[i + u - (1-a), j + v - (1-b)] (zero outside the image).
On a CUDA tensor the wrapper launches the kernel (and counts the launch in
its ``launches`` attribute); on a CPU tensor it runs the plain version,
which repeats the arithmetic with exact int8 x int8 -> int32 products
(``ops/int_mm.py``) and the same separately rounded f32 epilogue.

Weights feed the kernels K-minor ([..., Cout, Cin]: the operand form of the
int8 tensor-core instruction); :func:`subpixel_device_args` and
:func:`tail2_device_args` turn the builders' JAX-layout numpy args into that
form on a device.
"""

from __future__ import annotations

import numpy as np
import torch

from posetpu_torch.ops import _build
from posetpu_torch.ops.int_mm import int_mm

_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))
_P, _I = _build.P, _build.I
_SIGNATURES = {
    "phase_conv": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "phase_head": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ------------------------------------------------------------ plain versions


def _phase_conv_plain(x, w, sv, bv, so, interleave: bool):
    """x [N, H, W, Cin] int8; w [4, 4, Cout, Cin] int8; sv/bv [4, Cout] or
    [Cout] f32; so [1, 1] f32 -> int8 [4, N, H, W, Cout], or interleaved
    [N, 2H, 2W, Cout]."""
    n, h, wd, cin = x.shape
    cout = w.shape[2]
    xp = x.new_zeros(n, h + 2, wd + 2, cin)
    xp[:, 1:h + 1, 1:wd + 1] = x
    inv_so = 1.0 / so.reshape(())
    out = []
    for g, (a, b) in enumerate(_PHASES):
        acc = None
        for t, (u, v) in enumerate(_PHASES):
            sr, sc = u - (1 - a), v - (1 - b)
            xs = xp[:, 1 + sr:1 + sr + h, 1 + sc:1 + sc + wd].reshape(-1, cin)
            y = int_mm(xs, w[g, t].t())
            acc = y if acc is None else acc + y
        s_g = sv[g] if sv.dim() == 2 else sv
        b_g = bv[g] if bv.dim() == 2 else bv
        zf = torch.relu(acc.float() * s_g + b_g)
        out.append(torch.clamp(torch.round(zf * inv_so), -127, 127)
                   .to(torch.int8).reshape(n, h, wd, cout))
    z = torch.stack(out)  # [4, N, H, W, Cout]
    if interleave:
        return subpixel_interleave_packed_nmajor(z)
    return z


def _phase_head_plain(z, wh, vh):
    """z [4, N, H2, W2, C] int8; wh [J, C] int8; vh [2, J] f32 -> f32
    [J, N, 4*H2*W2] in the levels=2 packed order."""
    _, n, h2, w2, c = z.shape
    # [g2, n, i, al, j, be, c] -> [n, g2, al, be, i, j, c]: packed pixel order
    zp = z.reshape(4, n, h2 // 2, 2, w2 // 2, 2, c).permute(1, 0, 3, 5, 2, 4, 6)
    y = int_mm(zp.reshape(-1, c), wh.t())  # [N*P, J]
    y = y.float() * vh[0] + vh[1]
    return y.reshape(n, 4 * h2 * w2, -1).permute(2, 0, 1).contiguous()


def subpixel_deconv_plain(x, args, *, h: int, w: int):
    """Plain version of :func:`fused_subpixel_deconv_batched`."""
    n, hw, cin = x.shape
    return _phase_conv_plain(x.reshape(n, h, w, cin), args["w"], args["sv"],
                             args["bv"], args["so"], interleave=False)


def phase_tail2_plain(x, args, *, h: int, w: int):
    """Plain version of :func:`fused_phase_tail2`."""
    n, hw, cin = x.shape
    z1 = _phase_conv_plain(x.reshape(n, h, w, cin), args["w1"], args["s1"][0],
                           args["s1"][1], args["so1"], interleave=True)
    z2 = _phase_conv_plain(z1, args["w2"], args["s2"][0], args["s2"][1],
                           args["so2"], interleave=False)
    return _phase_head_plain(z2, args["wh"], args["vh"])


# ------------------------------------------------------------ CUDA launches


def _lib():
    return _build.load("phase_tail", _SIGNATURES)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name, **tensors):
    for k, t in tensors.items():
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be a contiguous CUDA tensor")


def _launch_phase_conv(x4, wk, sv, bv, phase_stride, so, interleave):
    n, h, w, cin = x4.shape
    cout = wk.shape[2]
    if x4.dtype != torch.int8 or wk.dtype != torch.int8:
        raise ValueError("phase_conv takes int8 activations and weights")
    if wk.shape != (4, 4, cout, cin) or cin % 32 or cout % 8:
        raise ValueError(f"phase_conv: unsupported shapes x {tuple(x4.shape)}, "
                         f"w {tuple(wk.shape)} (Cin % 32 == 0, Cout % 8 == 0)")
    _check_cuda("phase_conv", x=x4, w=wk, sv=sv, bv=bv, so=so)
    shape = (n, 2 * h, 2 * w, cout) if interleave else (4, n, h, w, cout)
    out = torch.empty(shape, dtype=torch.int8, device=x4.device)
    _build.check(_lib().phase_conv(
        x4.data_ptr(), wk.data_ptr(), sv.data_ptr(), bv.data_ptr(),
        phase_stride, so.data_ptr(), out.data_ptr(), n, h, w, cin, cout,
        int(interleave), _stream(x4)), "phase_conv")
    return out


def _launch_phase_head(z, wh, vh):
    _, n, h2, w2, c = z.shape
    joints = wh.shape[0]
    if z.dtype != torch.int8 or wh.shape != (joints, c) or c % 4 or h2 % 2 or w2 % 2:
        raise ValueError(f"phase_head: unsupported shapes z {tuple(z.shape)}, "
                         f"wh {tuple(wh.shape)}")
    _check_cuda("phase_head", z=z, wh=wh, vh=vh)
    out = torch.empty((joints, n, 4 * h2 * w2), dtype=torch.float32, device=z.device)
    _build.check(_lib().phase_head(
        z.data_ptr(), wh.data_ptr(), vh.data_ptr(), out.data_ptr(), n, h2, w2,
        c, joints, _stream(z)), "phase_head")
    return out


# ------------------------------------------------------------ the wrappers


def fused_subpixel_deconv_batched(x, args, *, h: int, w: int):
    """x: [N, H*W, Cin] int8 (deconv input, row-major) -> int8 phase maps
    [4, N, H, W, Cout] (phase (a, b) major), requantized with per-phase
    scales. ``args`` from :func:`subpixel_device_args`."""
    n, hw, cin = x.shape
    if hw != h * w:
        raise ValueError(f"x has {hw} pixels per image, not {h}x{w}")
    if not x.is_cuda:
        return subpixel_deconv_plain(x, args, h=h, w=w)
    cout = args["w"].shape[2]
    out = _launch_phase_conv(x.reshape(n, h, w, cin), args["w"], args["sv"],
                             args["bv"], cout, args["so"], interleave=False)
    fused_subpixel_deconv_batched.launches += 1
    return out


fused_subpixel_deconv_batched.launches = 0


def fused_phase_tail2(x, args, *, h: int, w: int):
    """x: [N, H*W, Cin] int8 (deconv1's input = deconv0's interleaved output)
    -> f32 two-level phase-packed heatmaps [J, N, 16*H*W]. ``args`` from
    :func:`tail2_device_args`."""
    n, hw, cin = x.shape
    if hw != h * w or h % 2 or w % 2:
        raise ValueError(f"x has {hw} pixels per image, not an even {h}x{w}")
    if not x.is_cuda:
        return phase_tail2_plain(x, args, h=h, w=w)
    s1, s2 = args["s1"], args["s2"]
    z1 = _launch_phase_conv(x.reshape(n, h, w, cin), args["w1"], s1[0], s1[1],
                            0, args["so1"], interleave=True)
    z2 = _launch_phase_conv(z1, args["w2"], s2[0], s2[1], 0, args["so2"],
                            interleave=False)
    out = _launch_phase_head(z2, args["wh"], args["vh"])
    fused_phase_tail2.launches += 1
    return out


fused_phase_tail2.launches = 0


def subpixel_interleave_packed_nmajor(z):
    """[4, N, H, W, Cout] phase maps ((a, b) major, image-major) ->
    [N, 2H, 2W, Cout] depth-to-space."""
    _, n, h, w, cout = z.shape
    y = z.reshape(2, 2, n, h, w, cout).permute(2, 3, 0, 4, 1, 5)
    return y.reshape(n, 2 * h, 2 * w, cout)


# ------------------------------------------------------------ argument packing


def _pack_phase_taps(wq):
    """[4, 4, I, O] deconv kernel -> [4 phase, 4 tap, I, O]: phase g=(a,b)
    tap t=(u,v) is wq[a::2, b::2][u, v]."""
    return np.stack([
        np.stack([wq[a::2, b::2][u, v] for u in range(2) for v in range(2)])
        for a in range(2) for b in range(2)
    ])


def build_phase_tail2_args(qparams, name1: str, name2: str, s_in: float) -> dict:
    """Pack deconv1 (``name1``), deconv2 (``name2``) and the head for
    :func:`fused_phase_tail2` as numpy, in the JAX package's layout
    (host-folded, single-rounded f32 scale products)."""
    q = qparams
    wq1 = _np(q["weights"][name1])
    wq2 = _np(q["weights"][name2])
    assert wq1.shape[:2] == (4, 4) and wq2.shape[:2] == (4, 4)
    ws1 = _np(q["w_scales"][name1]).astype(np.float32)
    ws2 = _np(q["w_scales"][name2]).astype(np.float32)
    b1 = _np(q["biases"][name1]).astype(np.float32)
    b2 = _np(q["biases"][name2]).astype(np.float32)
    so1 = np.float32(_np(q["act_scales"][f"{name1}.out"]))
    so2 = np.float32(_np(q["act_scales"][f"{name2}.out"]))
    wh = _np(q["weights"]["final"])[0, 0]
    ws_f = _np(q["w_scales"]["final"]).astype(np.float32)
    bias_f = _np(q["biases"]["final"]).astype(np.float32)
    return {
        "w1": _pack_phase_taps(wq1),
        "s1": np.stack([np.float32(s_in) * ws1, b1]),
        "so1": np.asarray([[so1]], dtype=np.float32),
        "w2": _pack_phase_taps(wq2),
        "s2": np.stack([so1 * ws2, b2]),
        "so2": np.asarray([[so2]], dtype=np.float32),
        "wh": wh,
        "vh": np.stack([so2 * ws_f, bias_f]),
    }


def build_subpixel_deconv_args(qparams, name: str, s_in: float) -> dict:
    """Pack an inner subpixel deconv's quantized weights for
    :func:`fused_subpixel_deconv_batched` as numpy, in the JAX package's
    layout. The layer's weights are the [2, 2, I, 4*O] subpixel form with
    per-(phase, out-channel) scales ws [4*O]; phase g reads taps
    wq[u, v, :, g*O:(g+1)*O]."""
    q = qparams
    wq = _np(q["weights"][name])  # [2, 2, I, 4*O] int8
    assert wq.shape[0] == 2 and wq.shape[1] == 2, wq.shape
    o4 = wq.shape[-1]
    assert o4 % 4 == 0
    o = o4 // 4
    ws = _np(q["w_scales"][name]).astype(np.float32)  # [4*O]
    b = _np(q["biases"][name]).astype(np.float32)  # [O]
    s_in32 = np.float32(s_in)
    s_out = np.float32(_np(q["act_scales"][f"{name}.out"]))
    wp = np.stack([
        np.stack([wq[u, v, :, g * o:(g + 1) * o]
                  for u in range(2) for v in range(2)])
        for g in range(4)
    ])
    sv = np.stack([s_in32 * ws[g * o:(g + 1) * o] for g in range(4)])
    return {
        "w": wp,
        "sv": sv,
        "bv": np.broadcast_to(b, (4, o)).copy(),
        "so": np.asarray([[s_out]], dtype=np.float32),
    }


def _to(a, device):
    return torch.from_numpy(np.array(_np(a))).to(device)


def _k_minor(a, device):
    """[..., K, N] weight -> contiguous [..., N, K] on ``device``."""
    return _to(a, device).transpose(-1, -2).contiguous()


def subpixel_device_args(args: dict, device) -> dict:
    """JAX-layout subpixel args (numpy or arrays) -> the kernel's tensors:
    w [4, 4, Cout, Cin] int8 (K-minor), sv/bv [4, Cout] f32, so [1, 1] f32."""
    return {"w": _k_minor(args["w"], device),
            **{k: _to(args[k], device) for k in ("sv", "bv", "so")}}


def tail2_device_args(args: dict, device) -> dict:
    """JAX-layout phase-tail2 args -> the kernels' tensors: w1/w2
    [4, 4, Cout, Cin] and wh [J, C] int8 (K-minor), the rest f32 as given."""
    out = {k: _k_minor(args[k], device) for k in ("w1", "w2", "wh")}
    out.update({k: _to(args[k], device) for k in ("s1", "so1", "s2", "so2", "vh")})
    return out
