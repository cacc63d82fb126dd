"""The phase-domain deconvolution tail: an inner deconv (B2, B6), the last
deconv + the 1x1 head (B5) and the last two deconvs + head (B1), each a
hand-written CUDA kernel (``csrc/phase_tail.cu``) with its plain PyTorch
version beside it.

Ports posetpu/ops/pallas/phase_tail.py's kernels with the same contracts:

- ``fused_subpixel_deconv_batched(x [N, H*W, Cin] int8)`` (B2) -> int8 phase
  maps [4, N, H, W, Cout], per-phase requant (+ReLU);
- ``fused_subpixel_deconv`` (B6): the same arithmetic with the per-pair
  kernel's N-minor output [4, H, W, N, Cout]; :data:`SUBPIX_BATCHED` picks
  which of the two the int8 forward (models/quant.py) calls;
- ``fused_phase_tail(x [N, H*W, Cin] int8)`` (B5) -> f32 heatmaps
  [J, N, 4*H*W] in the ``phase_index_tables(levels=1)`` order;
- ``fused_phase_tail2(x [N, H*W, Cin] int8)`` (B1) -> f32 heatmaps
  [J, N, 16*H*W] in the ``phase_index_tables(levels=2)`` order.

A k4/s2/p1 transposed conv in phase form: output phase g = (a, b), tap
t = (u, v) reads x[i + u - (1-a), j + v - (1-b)] (zero outside the image).
On a CUDA tensor the wrapper launches the kernel (and counts the launch in
its ``launches`` attribute); on a CPU tensor it runs the plain version,
which repeats the arithmetic with exact int8 x int8 -> int32 products
(``ops/int_mm.py``) and the same separately rounded f32 epilogue.

Weights feed the kernels K-minor ([..., Cout, Cin]: the operand form of the
int8 tensor-core instruction); :func:`subpixel_device_args`,
:func:`tail_device_args` and :func:`tail2_device_args` turn the ``build_*_args``
functions' JAX-layout numpy args into that form on a device.

Shapes the kernels take: Cin % 32 == 0 and Cout % 8 == 0 for the phase
convs, C % 4 == 0 for the head (and even H, W of its input at levels=2);
any batch and image size. A wrapper raises ``ValueError`` on anything else.
"""

from __future__ import annotations

import numpy as np
import torch

from posetpu_torch.ops import _build
from posetpu_torch.ops.int_mm import int_mm

# Route the int8 forward's inner subpixel deconvs through the batched kernel
# (B2). False routes them through the per-pair contract (B6, N-minor output
# + subpixel_interleave_packed). models/quant._forward reads this per call.
SUBPIX_BATCHED = True

_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))
_P, _I = _build.P, _build.I
_SIGNATURES = {
    "phase_conv": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "phase_head": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}
# phase_conv output modes (csrc/phase_tail.cu)
_PHASE_MAJOR, _INTERLEAVED, _N_MINOR = 0, 1, 2


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ------------------------------------------------------------ plain versions


def phase_sums(x, w):
    """The exact int32 sums of a k4/s2/p1 transposed conv in phase form:
    x [N, H, W, Cin] int8, w [4 phase, 4 tap, Cout, Cin] int8 -> four
    [N*H*W, Cout] int32, phase (a, b) major."""
    n, h, wd, cin = x.shape
    xp = x.new_zeros(n, h + 2, wd + 2, cin)
    xp[:, 1:h + 1, 1:wd + 1] = x
    sums = []
    for g, (a, b) in enumerate(_PHASES):
        acc = None
        for t, (u, v) in enumerate(_PHASES):
            sr, sc = u - (1 - a), v - (1 - b)
            xs = xp[:, 1 + sr:1 + sr + h, 1 + sc:1 + sc + wd].reshape(-1, cin)
            y = int_mm(xs, w[g, t].t())
            acc = y if acc is None else acc + y
        sums.append(acc)
    return sums


def _phase_conv_plain(x, w, sv, bv, so, interleave: bool):
    """x [N, H, W, Cin] int8; w [4, 4, Cout, Cin] int8; sv/bv [4, Cout] or
    [Cout] f32; so [1, 1] f32 -> int8 [4, N, H, W, Cout], or interleaved
    [N, 2H, 2W, Cout]."""
    n, h, wd, _ = x.shape
    cout = w.shape[2]
    inv_so = 1.0 / so.reshape(())
    out = []
    for g, acc in enumerate(phase_sums(x, w)):
        s_g = sv[g] if sv.dim() == 2 else sv
        b_g = bv[g] if bv.dim() == 2 else bv
        zf = torch.relu(acc.float() * s_g + b_g)
        out.append(torch.clamp(torch.round(zf * inv_so), -127, 127)
                   .to(torch.int8).reshape(n, h, wd, cout))
    z = torch.stack(out)  # [4, N, H, W, Cout]
    if interleave:
        return subpixel_interleave_packed_nmajor(z)
    return z


def _phase_head_plain(z, wh, vh, levels: int = 2):
    """z [4, N, H2, W2, C] int8; wh [J, C] int8; vh [2, J] f32 -> f32
    [J, N, 4*H2*W2] in the levels=2 packed order (levels=1: phase g, then
    row-major pixel)."""
    _, n, h2, w2, c = z.shape
    if levels == 1:
        zp = z.permute(1, 0, 2, 3, 4)  # [n, g, i, j, c]
    else:
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


def subpixel_deconv_pairs_plain(x, args, *, h: int, w: int):
    """Plain version of :func:`fused_subpixel_deconv`."""
    return subpixel_deconv_plain(x, args, h=h, w=w).permute(0, 2, 3, 1, 4).contiguous()


def phase_tail_plain(x, args, *, h: int, w: int):
    """Plain version of :func:`fused_phase_tail`."""
    n, hw, cin = x.shape
    z = _phase_conv_plain(x.reshape(n, h, w, cin), args["w"], args["sv"][0],
                          args["sv"][1], args["so"], interleave=False)
    return _phase_head_plain(z, args["wh"], args["vh"], levels=1)


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


# the current stream's raw handle without building a torch.cuda.Stream
# object around it (a third of a small wrapper's host time)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t):
    if _raw_stream is not None:
        return _raw_stream(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name, **tensors):
    for k, t in tensors.items():
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be a contiguous CUDA tensor")


def _launch_phase_conv(x4, wk, sv, bv, phase_stride, so, out_mode):
    n, h, w, cin = x4.shape
    cout = wk.shape[2]
    if x4.dtype != torch.int8 or wk.dtype != torch.int8:
        raise ValueError("phase_conv takes int8 activations and weights")
    if wk.shape != (4, 4, cout, cin) or cin % 32 or cout % 8:
        raise ValueError(f"phase_conv: unsupported shapes x {tuple(x4.shape)}, "
                         f"w {tuple(wk.shape)} (Cin % 32 == 0, Cout % 8 == 0)")
    check_cuda("phase_conv", x=x4, w=wk, sv=sv, bv=bv, so=so)
    shape = {_PHASE_MAJOR: (4, n, h, w, cout), _INTERLEAVED: (n, 2 * h, 2 * w, cout),
             _N_MINOR: (4, h, w, n, cout)}[out_mode]
    out = torch.empty(shape, dtype=torch.int8, device=x4.device)
    _build.check(_lib().phase_conv(
        x4.data_ptr(), wk.data_ptr(), sv.data_ptr(), bv.data_ptr(),
        phase_stride, so.data_ptr(), out.data_ptr(), n, h, w, cin, cout,
        out_mode, stream_of(x4)), "phase_conv")
    return out


def _launch_phase_head(z, wh, vh, levels: int = 2):
    _, n, h2, w2, c = z.shape
    joints = wh.shape[0]
    if z.dtype != torch.int8 or wh.shape != (joints, c) or c % 4 \
            or (levels == 2 and (h2 % 2 or w2 % 2)):
        raise ValueError(f"phase_head: unsupported shapes z {tuple(z.shape)}, "
                         f"wh {tuple(wh.shape)}")
    check_cuda("phase_head", z=z, wh=wh, vh=vh)
    out = torch.empty((joints, n, 4 * h2 * w2), dtype=torch.float32, device=z.device)
    _build.check(_lib().phase_head(
        z.data_ptr(), wh.data_ptr(), vh.data_ptr(), out.data_ptr(), n, h2, w2,
        c, joints, levels, stream_of(z)), "phase_head")
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
                             args["bv"], cout, args["so"], _PHASE_MAJOR)
    fused_subpixel_deconv_batched.launches += 1
    return out


fused_subpixel_deconv_batched.launches = 0


def fused_subpixel_deconv(x, args, *, h: int, w: int):
    """x: [N, H*W, Cin] int8 (deconv input, row-major) -> int8 phase maps
    [4, H, W, N, Cout] (phase (a, b) major, image-minor), requantized with
    per-phase scales: the per-pair kernel's contract, for
    :func:`subpixel_interleave_packed`. ``args`` from
    :func:`subpixel_device_args`."""
    n, hw, cin = x.shape
    if hw != h * w:
        raise ValueError(f"x has {hw} pixels per image, not {h}x{w}")
    if not x.is_cuda:
        return subpixel_deconv_pairs_plain(x, args, h=h, w=w)
    cout = args["w"].shape[2]
    out = _launch_phase_conv(x.reshape(n, h, w, cin), args["w"], args["sv"],
                             args["bv"], cout, args["so"], _N_MINOR)
    fused_subpixel_deconv.launches += 1
    return out


fused_subpixel_deconv.launches = 0


def fused_phase_tail(x, args, *, h: int, w: int):
    """x: [N, H*W, Cin] int8 (the last deconv's input, row-major) -> f32
    phase-packed heatmaps [J, N, 4*H*W] in the ``phase_index_tables
    (levels=1)`` order: column g*H*W + r is phase g, pixel r. ``args`` from
    :func:`tail_device_args`."""
    n, hw, cin = x.shape
    if hw != h * w:
        raise ValueError(f"x has {hw} pixels per image, not {h}x{w}")
    if not x.is_cuda:
        return phase_tail_plain(x, args, h=h, w=w)
    sv = args["sv"]
    z = _launch_phase_conv(x.reshape(n, h, w, cin), args["w"], sv[0], sv[1], 0,
                           args["so"], _PHASE_MAJOR)
    out = _launch_phase_head(z, args["wh"], args["vh"], levels=1)
    fused_phase_tail.launches += 1
    return out


fused_phase_tail.launches = 0


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
                            0, args["so1"], _INTERLEAVED)
    z2 = _launch_phase_conv(z1, args["w2"], s2[0], s2[1], 0, args["so2"],
                            _PHASE_MAJOR)
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


def subpixel_interleave_packed(z):
    """[4, H, W, N, Cout] phase maps ((a, b) major, image-minor) ->
    [N, 2H, 2W, Cout] depth-to-space."""
    _, h, w, n, cout = z.shape
    y = z.reshape(2, 2, h, w, n, cout).permute(4, 2, 0, 3, 1, 5)
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


def build_phase_tail_args(qparams, name: str, s_in: float) -> dict:
    """Pack the last deconv (``name``) and the head for
    :func:`fused_phase_tail` as numpy, in the JAX package's layout
    (host-folded, single-rounded f32 scale products). Phase g=(a,b) tap
    t=(u,v) is wq[a::2, b::2][u, v]."""
    q = qparams
    wq = _np(q["weights"][name])  # [4, 4, I, O] int8
    assert wq.shape[0] == 4 and wq.shape[1] == 4, wq.shape
    ws = _np(q["w_scales"][name]).astype(np.float32)
    b = _np(q["biases"][name]).astype(np.float32)
    s_out = np.float32(_np(q["act_scales"][f"{name}.out"]))
    ws_f = _np(q["w_scales"]["final"]).astype(np.float32)
    bias_f = _np(q["biases"]["final"]).astype(np.float32)
    return {
        "w": _pack_phase_taps(wq),
        "sv": np.stack([np.float32(s_in) * ws, b]),
        "so": np.asarray([[s_out]], dtype=np.float32),
        "wh": _np(q["weights"]["final"])[0, 0],
        "vh": np.stack([s_out * ws_f, bias_f]),
    }


def build_subpixel_deconv_args(qparams, name: str, s_in: float) -> dict:
    """Pack an inner subpixel deconv's quantized weights for
    :func:`fused_subpixel_deconv_batched` and :func:`fused_subpixel_deconv`
    as numpy, in the JAX package's layout. The layer's weights are the [2, 2, I, 4*O] subpixel form with
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


def tail_device_args(args: dict, device) -> dict:
    """JAX-layout phase-tail args -> the kernels' tensors: w [4, 4, Cout, Cin]
    and wh [J, C] int8 (K-minor), sv [2, Cout], so [1, 1], vh [2, J] f32."""
    return {**{k: _k_minor(args[k], device) for k in ("w", "wh")},
            **{k: _to(args[k], device) for k in ("sv", "so", "vh")}}


def tail2_device_args(args: dict, device) -> dict:
    """JAX-layout phase-tail2 args -> the kernels' tensors: w1/w2
    [4, 4, Cout, Cin] and wh [J, C] int8 (K-minor), the rest f32 as given."""
    out = {k: _k_minor(args[k], device) for k in ("w1", "w2", "wh")}
    out.update({k: _to(args[k], device) for k in ("s1", "so1", "s2", "so2", "vh")})
    return out
