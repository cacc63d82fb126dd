"""int8 post-training-quantized inference path for PoseResNet, in every
configuration of the JAX package's ``quantize_pose_resnet``:

- the input as normalised floats (quantised here) or as int8, row-major
  [N, H, W, 3] through the 7x7/s2 stem (``stem_s2d=False``), through the
  space-to-depth 4x4/s1 form packed here (``True``) or packed by the caller
  (``"pre"``, the serving contract);
- block boundaries named in ``act4`` stored at 4 bits, as int8 values in
  [-7, 7] (``act4_mode="s4"``) or two to a uint8 byte (``"packed"``);
- each deconv as the dilated int8 conv, the plain subpixel conv or a
  subpixel kernel (B2 batched, B6 per pair);
- the head as row-major [N, h, w, J] (``jns_head=False``), S-minor
  [J, N, h*w] in f32 or bf16 (``True``, ``"bf16"``), or phase-packed
  (``"phase"``): the last deconv + head in plain PyTorch, as the one-level
  kernel (B5) or, with the deconv before it, as the two-level kernel (B1).

:func:`make_fused_forward` is the row-major forward with every stride-1
bottleneck as one kernel (B8a, ops/resblock.py) and the deconvs + head as the
fused subpixel kernels (B9a, B9b, ops/deconv.py).

1. **fold** — BatchNorm folds into each conv's per-output-channel scale+bias;
2. **calibrate** — batches run through the folded float graph recording
   per-quantization-point absolute maxima;
3. **quantize** — weights become per-output-channel int8, activation scales
   come from calibration; the forward keeps activations int8 between layers
   (conv -> int32 -> f32 requantize(+ReLU) -> int8), residual adds
   dequantize-add-requantize.

The weight-side steps are numpy and copy the JAX package's arithmetic, so
the int8 weights match it bit for bit. The trunk convs are exact int8 GEMMs:
im2col on int8 NHWC (padding + strided slices) and ``torch._int_mm``
(int8 x int8 -> int32, ops/int_mm.py). Never an f32 conv: layer4's 3x3x512 contraction
reaches ~7.4e7 > 2^24, past f32's exact integers. The JAX package's
``conv_dtype_policy`` routes some sites (K <= 128, wide output) through bf16
on the TPU, exact by construction; here every site is an int8 GEMM, which is
no difference in results. The deconv tail's kernels are the hand-written CUDA
kernels of ops/phase_tail.py and ops/deconv.py.

Every scale is a float32 tensor, and products of scales are taken in f32 in
the JAX association, so each rounds as it does there.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from posetpu_torch import resolve_device
from posetpu_torch.models.multiview import SRC_VIEW, require_pose_resnet
from posetpu_torch.models.pose_resnet import RESNET_SPEC
from posetpu_torch.ops import deconv as _dc
from posetpu_torch.ops import phase_tail as _pt
from posetpu_torch.ops import requant as _rq
from posetpu_torch.ops import resblock as _rb
from posetpu_torch.ops.int_mm import int_mm
from posetpu_torch.utils.profiling import span


# --------------------------------------------------------------- BN folding


def _fold_conv_bn(kernel, bn_params, bn_stats, eps: float = 1e-5):
    """conv (no bias) followed by BN -> conv with per-out-channel scale/bias
    baked in. kernel: [kh, kw, i, o]."""
    gamma = bn_params["scale"]
    beta = bn_params["bias"]
    mean = bn_stats["mean"]
    var = bn_stats["var"]
    mult = gamma / np.sqrt(np.asarray(var) + eps)
    w = np.asarray(kernel) * np.asarray(mult)[None, None, None, :]
    b = np.asarray(beta) - np.asarray(mean) * np.asarray(mult)
    return w.astype(np.float32), b.astype(np.float32)


def _plan(num_layers: int, deconv_kernels):
    """Linear layer plan mirroring PoseResNet's structure; ``deconv_kernels``
    the deconvs' kernel sizes in order."""
    kind, stage_blocks = RESNET_SPEC[num_layers]
    expansion = 1 if kind == "basic" else 4
    plan = [("stem", {})]
    inplanes = 64
    for stage, (planes, nblocks) in enumerate(
            zip((64, 128, 256, 512), stage_blocks), start=1):
        for b in range(nblocks):
            stride = (1 if stage == 1 else 2) if b == 0 else 1
            need_ds = b == 0 and (stride != 1 or inplanes != planes * expansion)
            plan.append(("block", {"name": f"layer{stage}_{b}", "kind": kind,
                                   "stride": stride, "downsample": need_ds}))
            inplanes = planes * expansion
    for i, k in enumerate(deconv_kernels):
        plan.append(("deconv", {"name": f"deconv{i}", "kernel": int(k)}))
    plan.append(("final", {}))
    return plan


def fold_params(model) -> dict:
    """Float params of a PoseResNet module with BN folded, keyed by conv site
    name: {site: (HWIO kernel [kh, kw, i, o], bias [o])} as numpy f32. The
    deconv kernels come spatially flipped (the input-dilated-correlation
    form of ConvTranspose2d), as the JAX package stores them."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    hwio = lambda name: sd[f"{name}.weight"].transpose(2, 3, 1, 0)
    bn = lambda name: ({"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]},
                       {"mean": sd[f"{name}.running_mean"],
                        "var": sd[f"{name}.running_var"]})
    folded = {"stem": _fold_conv_bn(hwio("conv1"), *bn("bn1"))}
    for kind, info in _plan(model.num_layers, model.deconv_kernels):
        name = info.get("name")
        if kind == "block":
            convs = ["conv1", "conv2"] + (["conv3"] if info["kind"] == "bottleneck" else [])
            for c in convs:
                folded[f"{name}.{c}"] = _fold_conv_bn(
                    hwio(f"{name}.{c}"), *bn(f"{name}.bn{c[-1]}"))
            if info["downsample"]:
                folded[f"{name}.downsample"] = _fold_conv_bn(
                    hwio(f"{name}.downsample_conv"), *bn(f"{name}.downsample_bn"))
        elif kind == "deconv":
            # torch ConvTranspose2d [I, O, kh, kw] -> flipped HWIO
            k = sd[f"{name}_conv.weight"][:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
            folded[name] = _fold_conv_bn(k, *bn(f"{name}_bn"))
    folded["final"] = (hwio("final_layer").astype(np.float32),
                       sd["final_layer.bias"].astype(np.float32))
    return folded


# ----------------------------------------------------- weight transforms


def subpixel_deconv_weights(wf):
    """[4, 4, I, O] flipped transposed-conv kernel -> [2, 2, I, 4*O] phase
    bank, groups ordered (a, b) = (0,0), (0,1), (1,0), (1,1)."""
    w = np.asarray(wf)
    groups = [w[a::2, b::2] for a in range(2) for b in range(2)]
    return np.concatenate(groups, axis=-1)


def s2d_stem_weights(w):
    """[7, 7, C, O] stride-2 stem kernel -> [4, 4, 4*C, O] space-to-depth
    form: pad to 8x8 with a zero row/col at the FRONT (stride-2 padding 3 ->
    stride-1 padding (2, 1)), then fold the 2x2 input phases into channels,
    (a, b) major. Same weight set plus zeros, so the per-output-channel
    scales and int8 values are unchanged."""
    w = np.asarray(w)
    k, _, c, o = w.shape
    assert k == 7
    w8 = np.zeros((8, 8, c, o), w.dtype)
    w8[1:8, 1:8] = w
    out = np.zeros((4, 4, 4 * c, o), w.dtype)
    for a in range(2):
        for b in range(2):
            out[:, :, (a * 2 + b) * c:(a * 2 + b + 1) * c] = w8[a::2, b::2]
    return out


def _s2d(x):
    """[N, H, W, C] -> [N, H/2, W/2, 4*C] space-to-depth, phase (a, b) major
    in channels (matches :func:`s2d_stem_weights`)."""
    n, h, w, c = x.shape
    xd = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return xd.reshape(n, h // 2, w // 2, 4 * c)


def _mirror_perm(c4: int, device):
    """The s2d channel order of the mirrored image: the b-phase groups of
    each a-phase swap."""
    c = c4 // 4
    perm = torch.cat([torch.arange(c, 2 * c), torch.arange(0, c),      # a=0: b=1 <-> b=0
                      torch.arange(3 * c, 4 * c), torch.arange(2 * c, 3 * c)])  # a=1
    return perm.to(device)


def mirror_s2d(x):
    """Horizontal mirror of an s2d-packed image [..., H/2, W/2, 4*C] without
    unpacking: virtual column j = 2*jj + b mirrors to W-1-j =
    2*(W/2-1-jj) + (1-b), so reverse the packed column axis and swap the
    b-phase channel groups. Equals :func:`_s2d` of the W-reversed image
    (the flip test's input flip, lib/core/function.py:557-562)."""
    return x.flip(-2).index_select(-1, _mirror_perm(x.shape[-1], x.device))


def mirror_s2d_hwcn(x):
    """:func:`mirror_s2d` on the batch-minor serving contract: x
    [H/2, W/2, 4*C, N] uint8; the packed column axis is axis 1 and the
    channels axis 2."""
    return x.flip(1).index_select(2, _mirror_perm(x.shape[2], x.device))


def _subpixel_wants(subpixel_deconvs, name) -> bool:
    """``subpixel_deconvs`` is a bool (all k4 deconvs) or a collection of
    deconv names (per-site policy)."""
    if isinstance(subpixel_deconvs, bool):
        return subpixel_deconvs
    return name in subpixel_deconvs


def _subpixel_interleave(z, h: int, wd: int):
    """z [N, H+1, W+1, 4*O] phase maps of the padded [2, 2, I, 4*O] conv ->
    y [N, 2H, 2W, O] depth-to-space: phase (a, b) is valid on the window
    starting at (a, b)."""
    n, o = z.shape[0], z.shape[-1] // 4
    rows = [torch.stack([z[:, a:h + a, b:wd + b, (2 * a + b) * o:(2 * a + b + 1) * o]
                         for b in range(2)], dim=3) for a in range(2)]
    y = torch.stack(rows, dim=3)  # [N, H, W, 2(a), 2(b), O]
    return y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * wd, o)


# ------------------------------------------------------- 4-bit boundaries


def pack_nibbles(q8):
    """int8 values in [-8, 7], even channel count -> uint8 with channel c in
    the low nibble and channel c + C/2 in the high nibble of byte c (the JAX
    package's order; ops/aggregation.pack_nibbles_k packs the s4 bank in
    another). Halves the bytes of a boundary tensor."""
    c = q8.shape[-1]
    lo = q8[..., : c // 2].to(torch.int32) & 0xF
    hi = q8[..., c // 2:].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_nibbles(p):
    """Inverse of :func:`pack_nibbles`: uint8 -> int8 in [-8, 7] with the
    channel order restored; sign extension by (x ^ 8) - 8."""
    pi = p.to(torch.int32)
    lo = ((pi & 0xF) ^ 8) - 8
    hi = (((pi >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


# ------------------------------------------------------------- convolutions


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv_f32(x, w_hwio, stride=1, padding=None):
    """Float NHWC conv with an HWIO kernel; symmetric (k-1)//2 padding."""
    if padding is None:
        padding = (w_hwio.shape[0] - 1) // 2
    w = w_hwio.permute(3, 2, 0, 1)
    return _nhwc(F.conv2d(_nchw(x), w, stride=stride, padding=padding))


# stride-2 deconv kernel size -> (padding, output_padding), as PoseResNet
_DECONV_PAD = {4: (1, 0), 3: (1, 1), 2: (0, 0)}


def _deconv_f32(x, w_flipped_hwio):
    """Float NHWC stride-2 ConvTranspose2d from the flipped HWIO kernel the
    folded params carry."""
    pad, opad = _DECONV_PAD[w_flipped_hwio.shape[0]]
    w = w_flipped_hwio.flip(0, 1).permute(2, 3, 0, 1)  # [I, O, kh, kw]
    return _nhwc(F.conv_transpose2d(_nchw(x), w, stride=2, padding=pad,
                                    output_padding=opad))


def _dilate2(x):
    """int8 NHWC [N, H, W, C] -> [N, 2H-1, 2W-1, C] with a zero between
    neighbours (the input dilation of a stride-2 transposed conv)."""
    n, h, w, c = x.shape
    xd = x.new_zeros(n, 2 * h - 1, 2 * w - 1, c)
    xd[:, ::2, ::2] = x
    return xd


def _im2col(x, kh, kw, stride, pad):
    """int8 NHWC [N, H, W, C] -> ([N*Ho*Wo, kh*kw*C], (N, Ho, Wo)), columns
    in HWIO order so an HWIO kernel reshaped to [kh*kw*C, O] is the other
    GEMM operand. ``pad`` = ((top, bottom), (left, right)), zeros. Its span
    counts the bytes it writes: the padded input, and the columns unless
    they are a view of the (contiguous) input (1x1, stride 1)."""
    n, h, w, c = x.shape
    (pt, pb), (pl, pr) = pad
    padded = bool(pt or pb or pl or pr)
    hp, wp = h + pt + pb, w + pl + pr
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    copied = kh * kw > 1 or stride > 1
    with span("quant.im2col", bytes=(n * hp * wp * c if padded else 0)
              + (n * ho * wo * kh * kw * c if copied else 0)):
        if padded:
            xp = x.new_zeros(n, hp, wp, c)
            xp[:, pt:pt + h, pl:pl + w] = x
            x = xp
        if kh == kw == 1:
            cols = x[:, ::stride, ::stride] if stride > 1 else x
            return cols.reshape(n * ho * wo, c), (n, ho, wo)
        cols = [x[:, dy:dy + stride * (ho - 1) + 1:stride,
                  dx:dx + stride * (wo - 1) + 1:stride]
                for dy in range(kh) for dx in range(kw)]
        return torch.stack(cols, dim=3).reshape(n * ho * wo, kh * kw * c), (n, ho, wo)


def _conv_int8(x, wq, stride=1, padding=None):
    """Exact int8 conv: int8 NHWC x HWIO int8 kernel -> (int32 sums
    [N*Ho*Wo, O], (N, Ho, Wo)). The sums may be a column slice of a padded
    GEMM output (ops/int_mm.py), which :func:`_requant` reads in place."""
    kh, kw, cin, cout = wq.shape
    if padding is None:
        p = (kh - 1) // 2
        padding = ((p, p), (p, p))
    cols, shape = _im2col(x, kh, kw, stride, padding)
    with span("quant.int_mm", macs=cols.shape[0] * cols.shape[1] * cout):
        return int_mm(cols, wq.reshape(kh * kw * cin, cout)), shape


def _requant(acc, s_h, ws, bias, scale, hi=127, relu=True, residual=None, r_scale=None):
    """One requantize site: int32 sums acc [M, C] -> int8 [M, C] at
    ``scale`` (``hi`` 7 at a 4-bit boundary), with the block's int8
    ``residual`` [M, C] at ``r_scale`` at a block's tail (ops/requant.py:
    one kernel launch on the card). Its span counts the bytes the site reads
    (the sums, the residual) and writes."""
    m, c = acc.shape
    with span("quant.requant", bytes=m * c * (6 if residual is not None else 5)):
        # PyTorch's 1.0 / scale is reciprocal(scale) * 1.0: the same f32, one launch fewer
        return _rq.requant(acc, s_h * ws, bias, torch.reciprocal(scale), hi, relu,
                           residual=residual, r_scale=r_scale)


def _max_pool_3x3_s2(x, fill):
    """3x3/s2/p1 max pool on NHWC, padding with ``fill`` (-inf for floats,
    -128 for int8: the max never picks it). Exact on int8, which CUDA's
    pooling kernels may refuse."""
    n, h, w, c = x.shape
    xp = x.new_full((n, h + 2, w + 2, c), fill)
    xp[:, 1:h + 1, 1:w + 1] = x
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out = None
    for dy in range(3):
        for dx in range(3):
            s = xp[:, dy:dy + 2 * (ho - 1) + 1:2, dx:dx + 2 * (wo - 1) + 1:2]
            out = s if out is None else torch.maximum(out, s)
    return out.contiguous()


# ----------------------------------------------------------- the executors


class _Recorder:
    """Calibration-mode executor: float math over the folded params,
    recording the post-activation absolute maxima at every point that will
    carry an int8 tensor in the quantized graph."""

    def __init__(self, folded, device):
        self.folded = {k: (torch.as_tensor(w, device=device),
                           torch.as_tensor(b, device=device))
                       for k, (w, b) in folded.items()}
        self.amax: dict[str, torch.Tensor] = {}

    def _record(self, x, name):
        a = x.abs().amax()
        self.amax[name] = a if name not in self.amax else torch.maximum(self.amax[name], a)

    def input(self, x):
        self._record(x, "input")
        return x, None

    def qchain(self, h, s_h, name, stride=1, relu=True, deconv=False):
        w, b = self.folded[name]
        if deconv:
            y = _deconv_f32(h, w) + b
        else:
            y = _conv_f32(h, w, stride=stride) + b
        if relu:
            y = torch.relu(y)
        self._record(y, f"{name}.out")
        return y, None

    def conv_f32(self, h, s_h, name, stride=1):
        w, b = self.folded[name]
        return _conv_f32(h, w, stride=stride) + b

    def block_out(self, m, s_m, conv, r, r_s, name):
        """A block's last conv ``conv`` on m, the residual r added, ReLU,
        recorded at the block's boundary ``name``."""
        return self.requant(torch.relu(self.conv_f32(m, s_m, conv) + self.dequant(r, r_s)), name)

    def max_pool(self, h):
        return _max_pool_3x3_s2(h, float("-inf"))

    def dequant(self, h, s_h):
        return h

    def requant(self, y, name):
        self._record(y, name)
        return y, None

    def unwrap(self, h, s_h):
        return h, s_h


def conv_dtype_policy(qparams) -> dict:
    """The JAX package's per-site conv compute dtype: {site: "bf16"} for
    every site whose contraction K = kh*kw*cin is <= 128 with >= 256
    output channels, the sites its TPU runs faster in bf16 than in int8.
    bf16 is exact there (every product is an integer <= 127^2 and
    |acc| <= 128*127^2 < 2^23, inside the f32 accumulator's exact range),
    so the policy changes speed, not results. :class:`_Int8Runner` takes no
    policy: every site is an exact int8 GEMM (ops/int_mm.py), which gives
    the same numbers."""
    policy = {}
    for name, wq in qparams["weights"].items():
        kh, kw, cin, cout = wq.shape
        if kh * kw * cin <= 128 and cout >= 256:
            policy[name] = "bf16"
    return policy


class _Int8Runner:
    """int8-mode executor. Every tensor between convs (block outputs,
    intra-block activations, branch outputs) is int8 with a calibrated
    scale; dequantize -> affine -> ReLU -> requantize happen in f32 on each
    conv's int32 output, with a block's residual add at its last conv
    (:func:`_requant`: one kernel launch a site on the card). Every site runs
    as an exact int8 GEMM, so the runner takes no :func:`conv_dtype_policy`.

    ``act4``: boundary names (e.g. "layer1_0.out") stored at 4 bits: the
    same calibrated amax over 7 steps instead of 127. ``act4_mode="s4"``
    holds them as int8 values in [-7, 7] (numerically the JAX package's
    native int4); ``"packed"`` carries two to a uint8 byte between blocks
    (:func:`pack_nibbles`), unpacked by each consumer (:meth:`unwrap`). Both
    give the same heatmaps bit for bit."""

    def __init__(self, qparams, act4=(), act4_mode="s4"):
        self.q = qparams
        self.act4 = frozenset(act4)
        self.act4_mode = act4_mode

    @staticmethod
    def _quant(x, scale):
        # multiply by the reciprocal (f32), not divide, as the JAX epilogue
        return torch.clamp(torch.round(x * (1.0 / scale)), -127, 127).to(torch.int8)

    def input(self, x):
        s = self.q["act_scales"]["input"]
        if x.dtype == torch.int8:  # pre-quantized (make_u8_quant's output)
            return x, s
        if not x.is_floating_point():
            raise ValueError(f"the int8 forward takes normalised floats or the int8 "
                             f"input of make_u8_quant, not {x.dtype}")
        return self._quant(x, s), s

    def qchain(self, h_q, s_h, name, stride=1, relu=True, s2d=False,
               subpixel=False, dilated=False):
        wq = self.q["weights"][name]
        ws = self.q["w_scales"][name]
        b = self.q["biases"][name]
        s_out = self.q["act_scales"][f"{name}.out"]
        padding = None
        if s2d:
            # space-to-depth stem, the 4x4/s1 form of the 7x7/s2 conv. With
            # s2d="pre" the input already arrives s2d-packed (the serving
            # input contract); otherwise it is packed here
            if s2d != "pre":
                h_q = _s2d(h_q)
            stride, padding = 1, ((2, 1), (2, 1))
        if subpixel:
            # the padded [2, 2, I, 4*O] phase conv; requantize BEFORE the
            # depth-to-space, so the interleave moves int8 bytes
            z, shape = _conv_int8(h_q, wq, 1, ((1, 1), (1, 1)))  # [N*(H+1)*(W+1), 4*O]
            zq = _requant(z, s_h, ws, b.repeat(4), s_out, relu=relu).reshape(*shape, -1)
            return _subpixel_interleave(zq, h_q.shape[1], h_q.shape[2]), s_out
        if dilated:
            # a stride-2 deconv as the input-dilated stride-1 conv with the
            # flipped kernel (lhs_dilation=(2, 2) in the JAX package)
            k = wq.shape[0]
            p, opad = _DECONV_PAD[k]
            pad = k - 1 - p
            h_q, padding = _dilate2(h_q), ((pad, pad + opad), (pad, pad + opad))
        y, shape = _conv_int8(h_q, wq, stride, padding)
        # an intra-block 4-bit boundary stays int8 values in either act4 mode
        # (nibble packing is not plumbed through conv consumers, as in the JAX
        # package)
        s_out, hi = self._boundary(f"{name}.out")
        return _requant(y, s_h, ws, b, s_out, hi, relu).reshape(*shape, -1), s_out

    def _boundary(self, name):
        """(scale, hi) of the boundary ``name``: its calibrated scale and
        127 steps, or at a 4-bit boundary the same amax over 7."""
        s = self.q["act_scales"][name]
        if name in self.act4:
            return s * (127.0 / 7.0), 7
        return s, 127

    def conv_f32(self, h_q, s_h, name, stride=1):
        """The row-major head: int8 -> f32 [N, h, w, J], a plain epilogue."""
        ws = self.q["w_scales"][name]
        b = self.q["biases"][name]
        y, shape = _conv_int8(h_q, self.q["weights"][name], stride)
        with span("quant.requant", bytes=y.numel() * 8):
            return y.reshape(*shape, -1).float() * (s_h * ws) + b

    def block_out(self, m_q, s_m, conv, r_q, r_s, name):
        """A block's last conv ``conv`` on m_q, the residual r_q at r_s
        added, ReLU, requantized to the boundary ``name``: one site."""
        acc, shape = _conv_int8(m_q, self.q["weights"][conv])
        s, hi = self._boundary(name)
        q = _requant(acc, s_m, self.q["w_scales"][conv], self.q["biases"][conv], s, hi,
                     residual=r_q.reshape(acc.shape), r_scale=r_s).reshape(*shape, -1)
        if hi == 7 and self.act4_mode == "packed":
            q = pack_nibbles(q)
        return q, s

    def final_jns(self, h_q, s_h, dtype=torch.float32):
        """The 1x1 head in the S-minor layout: h_q [N, H, W, C] int8 ->
        [J, N, H*W] (row-major pixels). ``dtype=torch.bfloat16`` rounds the
        f32 result to nearest even, as ``astype(jnp.bfloat16)`` does."""
        wq = self.q["weights"]["final"]  # [1, 1, C, J]
        ws = self.q["w_scales"]["final"]
        b = self.q["biases"]["final"]
        n, hh, ww, c = h_q.shape
        y = int_mm(h_q.reshape(-1, c), wq.reshape(c, -1)).reshape(n, hh * ww, -1)
        y = y.permute(2, 0, 1).float() * (s_h * ws)[:, None, None] + b[:, None, None]
        return y.to(dtype)

    def subpixel_phases(self, h_q, s_h, name):
        """The last k4 deconv as four stride-1 2x2 phase convs, KEEPING the
        phase groups (no depth-to-space): [N, H, W, I] int8 -> four
        [N, H, W, O] int8 maps, (a, b) major. The padding per group,
        ((1-a, a), (1-b, b)), selects the group's valid window."""
        wq = self.q["weights"][name]  # [4, 4, I, O] int8
        ws = self.q["w_scales"][name]
        b = self.q["biases"][name]
        s_out = self.q["act_scales"][f"{name}.out"]
        zs = []
        for a in range(2):
            for bb in range(2):
                z, shape = _conv_int8(h_q, wq[a::2, bb::2], 1, ((1 - a, a), (1 - bb, bb)))
                zs.append(_requant(z, s_h, ws, b, s_out).reshape(*shape, -1))
        return tuple(zs), s_out

    def final_phase(self, zs, s_z):
        """The 1x1 head over the four phase maps of :meth:`subpixel_phases`
        -> f32 [J, N, 4*H*W] in the ``phase_index_tables(levels=1)`` order:
        one exact int8 GEMM per group, then one f32 epilogue."""
        wq = self.q["weights"]["final"]  # [1, 1, C, J]
        ws = self.q["w_scales"]["final"]
        bias = self.q["biases"]["final"]
        c, j = wq.shape[2], wq.shape[3]
        n, hh, ww, _ = zs[0].shape
        w2 = wq.reshape(c, j)
        y = torch.stack([int_mm(z.reshape(-1, c), w2).reshape(n, hh * ww, j)
                         for z in zs], dim=1)  # [N, 4, H*W, J] int32
        y = y.permute(3, 0, 1, 2).float() * (s_z * ws)[:, None, None, None] \
            + bias[:, None, None, None]
        return y.reshape(j, n, 4 * hh * ww)

    def max_pool(self, h_q):
        return _max_pool_3x3_s2(h_q, -128)

    def unwrap(self, h_q, s_h):
        """Undo a nibble-packed boundary at its consumer; int8 passes through."""
        if h_q.dtype == torch.uint8:
            return unpack_nibbles(h_q), s_h
        return h_q, s_h


def _run_block(runner, h_q, s_h, info):
    """One residual block on either executor: (h_q, s_h) -> (h_q, s_h)."""
    name = info["name"]
    if info["kind"] == "bottleneck":
        m, s_m = runner.qchain(h_q, s_h, f"{name}.conv1")
        m, s_m = runner.qchain(m, s_m, f"{name}.conv2", stride=info["stride"])
        last = f"{name}.conv3"
    else:
        m, s_m = runner.qchain(h_q, s_h, f"{name}.conv1", stride=info["stride"])
        last = f"{name}.conv2"
    if info["downsample"]:
        r_q, r_s = runner.qchain(h_q, s_h, f"{name}.downsample",
                                 stride=info["stride"], relu=False)
    else:
        r_q, r_s = h_q, s_h
    return runner.block_out(m, s_m, last, r_q, r_s, f"{name}.out")


def _forward(runner, x, num_layers, deconv_kernels, subpixel_deconvs=False,
             jns_head=False, stem_s2d=False, phase_kernel=False):
    """Shared calibration/int8 forward over the layer plan. The calibration
    recorder runs the 7x7/s2 stem on [N, H, W, 3], every deconv as a float
    ConvTranspose2d and the 1x1 head, returning [N, h, w, J]. The int8
    runner returns f32 heatmaps [N, h, w, J], or [J, N, h*w] with
    ``jns_head`` (row-major pixels; phase-packed with ``"phase"``).

    With ``jns_head="phase"`` and ``phase_tail2`` in the params the last two
    deconvs + head are the B1 kernel (``phase_index_tables(levels=2)``
    order); otherwise the last deconv + head are the B5 kernel
    (``phase_tail`` in the params) or plain PyTorch (levels=1 order). Any
    other k4 deconv named in ``subpixel_deconvs`` runs the subpixel kernel
    where the params hold its arguments (B2, or B6 under
    ``SUBPIX_BATCHED = False``), else the plain subpixel conv; every other
    deconv is the dilated int8 conv."""
    plan = _plan(num_layers, deconv_kernels)
    num_deconvs = len(deconv_kernels)
    q = getattr(runner, "q", None)  # None: the calibration recorder
    h_q, s_h = runner.input(x)
    # each stage of the trunk in one span: the stem, layer1-4, the deconvs
    # before the tail, and the tail (from the deconv where a phase tail
    # starts, else the head alone)
    tail_from = num_deconvs
    if q is not None and jns_head == "phase":
        tail_from = num_deconvs - (2 if "phase_tail2" in q else 1)

    def stage(entry):
        kind, info = entry
        if kind == "block":
            return info["name"].split("_")[0]
        if kind == "deconv" and int(info["name"][len("deconv"):]) < tail_from:
            return info["name"]
        return "stem" if kind == "stem" else "tail"

    for stage_name, entries in itertools.groupby(plan, key=stage):
        with span(f"trunk.{stage_name}"):
            for kind, info in entries:
                if kind == "stem":
                    if q is not None and stem_s2d:
                        h_q, s_h = runner.qchain(h_q, s_h, "stem", s2d=stem_s2d)
                    else:
                        h_q, s_h = runner.qchain(h_q, s_h, "stem", stride=2)
                    # max-pool commutes with the (positive-scale) quantization
                    h_q = runner.max_pool(h_q)
                elif kind == "block":
                    # a nibble-packed boundary unpacks here, at its consumers
                    h_q, s_h = runner.unwrap(h_q, s_h)
                    h_q, s_h = _run_block(runner, h_q, s_h, info)
                elif kind == "deconv":
                    h_q, s_h = runner.unwrap(h_q, s_h)
                    name, k = info["name"], info["kernel"]
                    if q is None:
                        h_q, s_h = runner.qchain(h_q, s_h, name, deconv=True)
                        continue
                    n, hh, ww, c = h_q.shape
                    is_last = name == f"deconv{num_deconvs - 1}"
                    if (jns_head == "phase" and k == 4
                            and name == f"deconv{num_deconvs - 2}" and "phase_tail2" in q):
                        # deconv1 + deconv2 + head: the B1 kernel; heatmaps come out
                        # in the levels=2 packing
                        return _pt.fused_phase_tail2(h_q.reshape(n, hh * ww, c),
                                                     q["phase_tail2"], h=hh, w=ww)
                    if jns_head == "phase" and is_last and k == 4:
                        if phase_kernel:
                            # last deconv + head: the B5 kernel, levels=1 packing
                            return _pt.fused_phase_tail(h_q.reshape(n, hh * ww, c),
                                                        q["phase_tail"], h=hh, w=ww)
                        # the same in plain PyTorch: four phase convs whose groups
                        # flow straight into the head (no depth-to-space)
                        h_q, s_h = runner.subpixel_phases(h_q, s_h, name)
                    elif k == 4 and _subpixel_wants(subpixel_deconvs, name):
                        if phase_kernel and f"subpix_{name}" in q:
                            x3 = h_q.reshape(n, hh * ww, c)
                            if _pt.SUBPIX_BATCHED:
                                z = _pt.fused_subpixel_deconv_batched(
                                    x3, q[f"subpix_{name}"], h=hh, w=ww)
                                h_q = _pt.subpixel_interleave_packed_nmajor(z).contiguous()
                            else:
                                z = _pt.fused_subpixel_deconv(
                                    x3, q[f"subpix_{name}"], h=hh, w=ww)
                                h_q = _pt.subpixel_interleave_packed(z).contiguous()
                            s_h = q["act_scales"][f"{name}.out"]
                        else:
                            h_q, s_h = runner.qchain(h_q, s_h, name, subpixel=True)
                    else:
                        h_q, s_h = runner.qchain(h_q, s_h, name, dilated=True)
                elif q is None or not jns_head:  # final 1x1 head, row-major [N, h, w, J]
                    h_q = runner.conv_f32(h_q, s_h, "final")
                elif jns_head == "phase":  # over subpixel_phases' groups
                    h_q = runner.final_phase(h_q, s_h)
                else:
                    h_q = runner.final_jns(
                        h_q, s_h, torch.bfloat16 if jns_head == "bf16" else torch.float32)
    return h_q


@contextlib.contextmanager
def _full_fp32():
    """f32 convolutions and matmuls in full f32 on CUDA (cuDNN defaults to
    TF32 for convolutions, which would shift the calibrated scales)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@torch.no_grad()
def calibrate(model, batches, device=None) -> tuple[dict, dict]:
    """Run calibration batches ([N, H, W, 3] normalised floats) through the
    folded float graph on ``device`` (CUDA unless given); returns
    (folded_params, activation_scales)."""
    folded = fold_params(model)
    dev = resolve_device(device)
    amax: dict[str, float] = {}
    with _full_fp32():
        for x in batches:
            rec = _Recorder(folded, dev)
            _forward(rec, torch.as_tensor(x, dtype=torch.float32, device=dev),
                     model.num_layers, model.deconv_kernels)
            for k, v in rec.amax.items():
                amax[k] = max(amax.get(k, 0.0), float(v))
    scales = {k: max(v, 1e-8) / 127.0 for k, v in amax.items()}
    return folded, scales


def quantize_weights(folded: dict, act_scales: dict, subpixel_deconvs=False,
                     stem_s2d: bool = False, device=None) -> dict:
    """Per-output-channel int8 weight quantization of the folded params
    (numpy, as the JAX package), returned as tensors on ``device`` (CUDA
    unless given)."""
    device = resolve_device(device)
    weights, w_scales, biases = {}, {}, {}
    for name, (w, b) in folded.items():
        if stem_s2d and name == "stem":
            w = s2d_stem_weights(w)  # [4, 4, 4*C, O]
        if (_subpixel_wants(subpixel_deconvs, name)
                and name.startswith("deconv") and w.shape[0] == 4):
            w = subpixel_deconv_weights(w)  # [2, 2, I, 4*O]
        s = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-8) / 127.0
        wq = np.clip(np.round(w / s[None, None, None, :]), -127, 127).astype(np.int8)
        weights[name] = torch.as_tensor(np.ascontiguousarray(wq), device=device)
        w_scales[name] = torch.as_tensor(s.astype(np.float32), device=device)
        biases[name] = torch.as_tensor(b, device=device)
    return {
        "weights": weights,
        "w_scales": w_scales,
        "biases": biases,
        "act_scales": {k: torch.tensor(v, dtype=torch.float32, device=device)
                       for k, v in act_scales.items()},
    }


def quantize_pose_resnet(model, calib_batches, *, subpixel_deconvs=False, jns_head=False,
                         stem_s2d=False, phase_kernel=False, act4=(),
                         act4_mode: str = "packed", device=None) -> tuple[dict, Any]:
    """One-call PTQ of a PoseResNet module. Returns (qparams, forward) with
    ``forward(qparams, x)`` -> f32 heatmaps. ``device``: CUDA unless given.
    The defaults are the JAX package's: x [N, H, W, 3] -> heatmaps
    [N, h, w, J], every deconv the dilated int8 conv, no kernel. The serving
    pipeline passes ``subpixel_deconvs={"deconv0"}, jns_head="phase",
    stem_s2d="pre", phase_kernel=2, act4_mode="s4"``: x the s2d-packed int8
    input [N, H/2, W/2, 12] from :func:`make_u8_quant` -> phase-packed
    [J, N, h*w].

    ``stem_s2d``: ``False`` — x is [N, H, W, 3], normalised floats (quantised
    here) or int8, through the 7x7/s2 stem; ``True`` — the same x, packed
    space-to-depth here for the 4x4/s1 stem; ``"pre"`` — x arrives packed.
    All three give the same int8 activations.

    ``jns_head``: ``False`` — heatmaps [N, h, w, J]; ``True`` / ``"bf16"`` —
    [J, N, h*w] row-major in f32 / bf16; ``"phase"`` — [J, N, h*w]
    phase-packed, where ``phase_kernel`` picks the tail: ``2`` — the last two
    deconvs + head as the two-level kernel (B1), heatmaps in the
    ``phase_index_tables(levels=2)`` order; ``1`` — the last deconv + head as
    the one-level kernel (B5), levels=1 order; ``False`` — the same tail in
    plain PyTorch, levels=1 order, and no kernel anywhere.

    ``subpixel_deconvs``: a bool or a collection of deconv names quantized in
    the per-phase subpixel form (finer per-phase weight scales); one outside
    the phase tail runs the subpixel kernel (B2 / B6) when ``phase_kernel``
    is set and it is not the last deconv, the plain subpixel conv otherwise.
    The phase tail's own deconvs keep the [4, 4, I, O] form, so they must not
    be named (``True`` names them and is refused, as in the JAX package).
    Every other deconv runs the dilated int8 conv.

    ``act4``: boundary names stored at 4 bits, ``act4_mode`` their carrier
    (see _Int8Runner)."""
    require_pose_resnet(model, "quantize_pose_resnet")
    dks = tuple(int(k) for k in model.deconv_kernels)
    if phase_kernel not in (False, 1, 2):
        raise ValueError(f"phase_kernel must be False, 1 or 2; got {phase_kernel!r}")
    if jns_head not in (False, True, "bf16", "phase"):
        raise ValueError(f"jns_head must be False, True, 'bf16' or 'phase'; got {jns_head!r}")
    if stem_s2d not in (False, True, "pre"):
        raise ValueError(f"stem_s2d must be False, True or 'pre'; got {stem_s2d!r}")
    if act4_mode not in ("s4", "packed"):
        raise ValueError(f"act4_mode must be 's4' or 'packed'; got {act4_mode!r}")
    tail = []
    if jns_head == "phase":
        n_tail = 2 if phase_kernel == 2 else 1
        if len(dks) < n_tail + (1 if phase_kernel else 0) or any(k != 4 for k in dks[-n_tail:]):
            raise ValueError(f"phase_kernel={phase_kernel!r} needs at least "
                             f"{n_tail + (1 if phase_kernel else 0)} deconvs, the last "
                             f"{n_tail} with kernel 4; got kernels {dks}")
        tail = [f"deconv{len(dks) - 1 - i}" for i in range(n_tail)]
        named = [t for t in tail if _subpixel_wants(subpixel_deconvs, t)]
        if named:
            raise ValueError(f"subpixel_deconvs names {named}, which the phase tail "
                             f"runs in the [4, 4, I, O] form (phase_kernel={phase_kernel!r})")
    dev = resolve_device(device)
    folded, act_scales = calibrate(model, calib_batches, dev)
    qparams = quantize_weights(folded, act_scales, subpixel_deconvs,
                               stem_s2d=bool(stem_s2d), device=dev)
    if jns_head == "phase" and phase_kernel == 2:
        qparams["phase_tail2"] = _pt.tail2_device_args(_pt.build_phase_tail2_args(
            qparams, tail[1], tail[0],
            float(act_scales[f"deconv{len(dks) - 3}.out"])), dev)
    elif jns_head == "phase" and phase_kernel:
        qparams["phase_tail"] = _pt.tail_device_args(_pt.build_phase_tail_args(
            qparams, tail[0], float(act_scales[f"deconv{len(dks) - 2}.out"])), dev)
    if phase_kernel:
        # kernels for the INNER subpixel deconvs too: walk the plan to
        # recover each deconv's input scale
        prev_key = "input"
        for kind, info in _plan(model.num_layers, dks):
            if kind == "stem":
                prev_key = "stem.out"
            elif kind == "block":
                prev_key = f"{info['name']}.out"
            elif kind == "deconv":
                name = info["name"]
                if (name != f"deconv{len(dks) - 1}" and info["kernel"] == 4
                        and _subpixel_wants(subpixel_deconvs, name)):
                    qparams[f"subpix_{name}"] = _pt.subpixel_device_args(
                        _pt.build_subpixel_deconv_args(
                            qparams, name, float(act_scales[prev_key])), dev)
                prev_key = f"{name}.out"
    num_layers = model.num_layers

    @torch.no_grad()
    def forward(qparams, x):
        runner = _Int8Runner(qparams, act4=act4, act4_mode=act4_mode)
        return _forward(runner, x, num_layers, dks,
                        subpixel_deconvs=subpixel_deconvs, jns_head=jns_head,
                        stem_s2d=stem_s2d, phase_kernel=phase_kernel)

    return qparams, forward


# --------------------------------------------- kernel-fused block forward


def make_fused_forward(model, qparams, subpixel_deconvs=False, pallas_deconvs: bool = True,
                       pallas_blocks: bool = False, device=None):
    """The row-major int8 forward with its blocks and deconvs as fused
    kernels: with ``pallas_blocks`` every stride-1 bottleneck runs as ONE
    kernel (B8a, ops/resblock.py: one read of the block input, one write of
    its output), and with ``pallas_deconvs`` (all deconvs k4/s2) the
    upsampling runs as the fused subpixel kernels (B9a) with the 1x1 head
    folded into the last one (B9b, ops/deconv.py). Stride-2 blocks and the
    stem stay on the runner's path. The argument names are the JAX
    package's, whose kernels are Pallas kernels.

    ``qparams``: from ``quantize_pose_resnet(model, calib)`` at its defaults
    (``subpixel_deconvs`` as there, for the deconvs that run on the runner's
    path). Returns (params, forward) with params = {"q", "fused", "deconv"},
    the kernels' arguments on ``device`` (CUDA unless given);
    ``forward(params, x)``: x [N, H, W, 3] normalised floats or int8 -> f32
    heatmaps [N, h, w, J]. The kernels' folded, once-rounded epilogues are
    not the runner's, so a heatmap may differ from the runner's forward by
    the effect of one int8 step on rare elements."""
    dks = tuple(int(k) for k in model.deconv_kernels)
    plan = _plan(model.num_layers, dks)
    dev = resolve_device(device)
    s_act = {k: float(v) for k, v in qparams["act_scales"].items()}

    # the fused blocks' arguments, tracking each block's input scale
    fargs = {}
    s_h = s_act["stem.out"]
    for kind, info in plan:
        if kind != "block":
            continue
        name = info["name"]
        if pallas_blocks and info["kind"] == "bottleneck" and info["stride"] == 1:
            fargs[name] = _rb.bottleneck_device_args(
                _rb.build_bottleneck_args(qparams, name, s_h), dev)
        s_h = s_act[f"{name}.out"]

    use_fused_deconvs = pallas_deconvs and all(k == 4 for k in dks)
    dargs = []
    if use_fused_deconvs:
        s_d = s_h  # the scale after the last residual block
        for i in range(len(dks)):
            dargs.append(_dc.build_deconv_args(qparams, f"deconv{i}", s_d))
            s_d = s_act[f"deconv{i}.out"]
        dargs[-1].update(_dc.build_head_args(qparams, s_d))
        dargs = [_dc.deconv_device_args(a, dev) for a in dargs]

    params = {"q": qparams, "fused": fargs, "deconv": dargs}

    @torch.no_grad()
    def forward(params, x):
        runner = _Int8Runner(params["q"])
        f = params["fused"]
        h_q, s_h = runner.input(x)
        for kind, info in plan:
            if kind == "stem":
                h_q, s_h = runner.qchain(h_q, s_h, "stem", stride=2)
                h_q = runner.max_pool(h_q)
            elif kind == "block":
                name = info["name"]
                if name in f:
                    n, hh, ww, c = h_q.shape
                    x3 = _rb.fused_bottleneck(h_q.reshape(n, hh * ww, c), f[name],
                                              h=hh, w=ww)
                    h_q = x3.reshape(n, hh, ww, x3.shape[-1])
                    s_h = params["q"]["act_scales"][f"{name}.out"]
                else:
                    h_q, s_h = _run_block(runner, h_q, s_h, info)
            elif kind == "deconv":
                if use_fused_deconvs:
                    # every deconv and the head run here, once
                    n, hh, ww, c = h_q.shape
                    x3 = h_q.reshape(n, hh * ww, c)
                    for da in params["deconv"]:
                        fused = (_dc.fused_subpixel_deconv_head if "wh" in da
                                 else _dc.fused_subpixel_deconv)
                        x3 = fused(x3, da, h=hh, w=ww)
                        hh, ww = hh * 2, ww * 2
                    return x3.reshape(n, hh, ww, x3.shape[-1])
                if info["kernel"] == 4 and subpixel_deconvs:
                    h_q, s_h = runner.qchain(h_q, s_h, info["name"], subpixel=True)
                else:
                    h_q, s_h = runner.qchain(h_q, s_h, info["name"], dilated=True)
            else:
                h_q = runner.conv_f32(h_q, s_h, "final")
        return h_q

    return params, forward


# ------------------------------------------------------------ uint8 input


def make_u8_quant(qparams, mean, std):
    """Serving front end: raw uint8 images -> int8 quantized input.

    Folds the reference's (x/255 - mean)/std normalisation and the input
    quantisation into ONE per-channel affine on the uint8 pixels:
        q = clip(round(u * a_c + b_c)),  a_c = 1/(255*std_c*s_in),
                                         b_c = -mean_c/(std_c*s_in)
    computed in f32 from the params' own input scale (the JAX package's
    numpy arithmetic, op for op). Returns fn: uint8 [..., 3 or 12] -> int8.
    """
    s_in = qparams["act_scales"]["input"]
    dev = s_in.device
    mean = torch.as_tensor(np.asarray(mean, np.float32), device=dev)
    std = torch.as_tensor(np.asarray(std, np.float32), device=dev)
    a = 1.0 / (255.0 * std * s_in)
    b = -mean / (std * s_in)

    def fn(u8):
        av, bv = a, b
        if u8.shape[-1] != a.shape[-1] and u8.shape[-1] % a.shape[-1] == 0:
            # s2d-packed input: channels are (a, b)-major x RGB
            reps = u8.shape[-1] // a.shape[-1]
            av, bv = a.repeat(reps), b.repeat(reps)
        x = u8.float() * av + bv
        return torch.clamp(torch.round(x), -127, 127).to(torch.int8)

    return fn


# ------------------------------------------------------- quantized fusion


def quantize_aggregation(bank, calib_heatmaps=None, device=None):
    """The [12, S, S] ChannelWiseFC bank -> int8 with per-(pair, output
    column) weight scales; the heatmaps' scale from calibration maxima
    (default 1.2). Numpy arithmetic, as the JAX package; returned as
    tensors on ``device`` (CUDA unless given): {"wq" [12, S, S] int8,
    "w_scale" [12, 1, S] f32, "x_scale" 0-d f32}, for
    :func:`aggregation_int8_apply` and :func:`aggregation_int8_apply_jns`."""
    dev = resolve_device(device)
    bank = bank.detach().cpu().numpy() if isinstance(bank, torch.Tensor) else bank
    w = np.asarray(bank, np.float32)
    s_w = np.maximum(np.abs(w).max(axis=1, keepdims=True), 1e-8) / 127.0  # [12,1,S]
    wq = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)
    amax = 1.2
    if calib_heatmaps is not None:
        amax = max(float(np.abs(np.asarray(calib_heatmaps)).max()), 1e-6)
    t = lambda a: torch.as_tensor(a, device=dev)
    return {"wq": t(wq), "w_scale": t(s_w.astype(np.float32)),
            "x_scale": t(np.float32(amax / 127.0))}


def _quantize_maps(qagg, hm):
    """clip(round(hm * (1 / x_scale))) as int8, the product in f32 whatever
    hm's dtype (a bf16 map times the f32 scale is f32 in JAX too)."""
    return torch.clamp(torch.round(hm.float() * (1.0 / qagg["x_scale"])), -127, 127
                       ).to(torch.int8)


def _per_pair(qagg, g):
    """g [12, M, S] int8 -> [12, M, S] f32: per pair the exact int32 product
    with the bank (``ops/int_mm.py``), times ``x_scale * w_scale`` rounded
    once."""
    y = torch.stack([int_mm(g[p], qagg["wq"][p]) for p in range(12)])
    return y.float() * (qagg["x_scale"] * qagg["w_scale"])


def _mean3(y, dim: int):
    """The mean over a size-3 axis as XLA computes jnp.mean: the f32 sum in
    order, times f32(1/3) (XLA turns the division by a constant into that
    multiply)."""
    a, b, c = y.float().unbind(dim)
    return (a + b + c) * (1.0 / 3.0)


def aggregation_int8_apply(qagg, heatmaps):
    """int8 twin of :class:`~posetpu_torch.models.multiview.Aggregation`:
    heatmaps [N, 4, h, w, J] -> fused [N, 4, h, w, J] f32, ``qagg`` from
    :func:`quantize_aggregation`. The maps are quantized first, so every
    gather moves int8 bytes."""
    n, v, h, w_, j = heatmaps.shape
    s = h * w_
    x = _quantize_maps(qagg, heatmaps).reshape(n, v, s, j).transpose(2, 3)  # [N, V, J, S]
    g = x[:, list(SRC_VIEW)].transpose(0, 1).reshape(12, n * j, s)
    y = _per_pair(qagg, g).reshape(4, 3, n, j, s)
    fused = _mean3(y, 1)  # [V, N, J, S]
    return fused.permute(1, 0, 3, 2).reshape(n, v, h, w_, j)


def aggregation_int8_apply_jns(qagg, hm):
    """S-minor twin of :func:`aggregation_int8_apply`: hm [J, N, V, S] ->
    fused [J, N, V, S] in hm's dtype. Each pair's scaled product is rounded
    to that dtype before the mean (a bf16 tail stays bf16), as the JAX
    package does."""
    j, n, v, s = hm.shape
    g = _quantize_maps(qagg, hm)[:, :, list(SRC_VIEW)]  # [J, N, 12, S]
    g = g.movedim(2, 0).reshape(12, j * n, s)
    y = _per_pair(qagg, g).to(hm.dtype).reshape(v, 3, j, n, s)
    return _mean3(y, 1).to(hm.dtype).movedim(0, 2)  # [J, N, V, S]


def quantize_aggregation_grouped(bank, calib_heatmaps=None):
    """The [12, S, S] ChannelWiseFC bank -> int8 with ONE weight scale per
    (target view, output column) shared by the target's 3 source pairs, so
    the 3-pair mean folds into the matmul contraction. Numpy, as the JAX
    package: {"wq" [4, 3, S, S] int8, "w_scale" [4, 1, S] f32, "x_scale"}."""
    bank = bank.detach().cpu().numpy() if isinstance(bank, torch.Tensor) else bank
    w = np.asarray(bank, np.float32).reshape(4, 3, bank.shape[1], bank.shape[2])
    s_w = np.maximum(np.abs(w).max(axis=(1, 2), keepdims=True), 1e-8) / 127.0
    wq = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)  # [4,3,S,S]
    amax = 1.2
    if calib_heatmaps is not None:
        amax = max(float(np.abs(np.asarray(calib_heatmaps)).max()), 1e-6)
    return {
        "wq": wq,
        "w_scale": s_w[:, 0].astype(np.float32),  # [4,1,S]
        "x_scale": np.float32(amax / 127.0),
    }


def permute_aggregation_packed(qagg, tables):
    """Offline, exact re-index of the int8 bank into the phase-packed S order
    (ops/heatmap.phase_index_tables): only the summation order changes."""
    r = np.asarray(tables["rowmajor"])
    return {
        "wq": np.asarray(qagg["wq"])[..., r, :][..., :, r],
        "w_scale": np.asarray(qagg["w_scale"])[..., r],
        "x_scale": qagg["x_scale"],
    }


def quantize_aggregation_grouped_s4(bank, calib_heatmaps=None):
    """Diagonal-split 4-bit variant of :func:`quantize_aggregation_grouped`:
    the bank streams from device memory every request, so storing it at 4
    bits halves that stream. A straight 4-bit bank would crush the small
    off-diagonal couplings of an identity-dominated trained bank, so split

      w = diag(d) + R,   d exact in f32 (applied in the epilogue),
                         R quantized at 4 bits against ITS OWN amax.

    Numpy, as the JAX package: {"wq4" [4, 3, S, S] int8 carrier with values
    in [-7, 7], "w_scale" [4, 1, S] f32 (the residual's), "dv" [4, 3, S] f32
    (the diagonal pre-folded with x_scale / 3), "x_scale"}."""
    bank = bank.detach().cpu().numpy() if isinstance(bank, torch.Tensor) else bank
    s = int(bank.shape[-1])
    w = np.asarray(bank, np.float32).reshape(4, 3, s, s)
    idx = np.arange(s)
    diag = w[:, :, idx, idx].copy()  # [4, 3, S]
    r = w.copy()
    r[:, :, idx, idx] = 0.0
    s_w = np.maximum(np.abs(r).max(axis=(1, 2), keepdims=True), 1e-8) / 7.0
    wq4 = np.clip(np.round(r / s_w), -7, 7).astype(np.int8)
    amax = 1.2
    if calib_heatmaps is not None:
        amax = max(float(np.abs(np.asarray(calib_heatmaps)).max()), 1e-6)
    x_scale = np.float32(amax / 127.0)
    return {
        "wq4": wq4,
        "w_scale": s_w[:, 0].astype(np.float32),  # [4,1,S]
        "dv": (diag * (x_scale / 3.0)).astype(np.float32),  # [4,3,S]
        "x_scale": x_scale,
    }


def permute_aggregation_packed_s4(qagg, tables):
    """:func:`permute_aggregation_packed` for the s4 diag-split bank: row and
    column permute of the residual, column permute of its scale and of the
    diagonal vector. Rows and columns move by the same map, so diagonal
    entries stay on the diagonal and the split survives unchanged."""
    r = np.asarray(tables["rowmajor"])
    return {
        "wq4": np.asarray(qagg["wq4"])[..., r, :][..., :, r],
        "w_scale": np.asarray(qagg["w_scale"])[..., r],
        "dv": np.asarray(qagg["dv"])[..., r],
        "x_scale": qagg["x_scale"],
    }
