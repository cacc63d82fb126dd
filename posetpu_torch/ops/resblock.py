"""The fused int8 ResNet bottleneck block (B8a, B8b): hand-written CUDA
kernels (``csrc/resblock.cu``) with their plain PyTorch versions beside them.

Ports posetpu/ops/pallas/resblock.py with the same contracts:

- ``fused_bottleneck(x [N, H*W, Cin] int8, args, h=, w=)`` (B8a) -> int8
  [N, H*W, Cout]: conv1 1x1 -> requant -> conv2 3x3 -> requant -> conv3 1x1
  + residual -> ReLU -> requant. The residual is x itself (Cin == Cout), or,
  with ``wd`` in the args, a 1x1 projection of x requantised to int8 with no
  ReLU before it is dequantised into the add;
- ``fused_bottleneck_v2(..., imgs=2)`` (B8b): the same function for the
  identity residual, ``imgs`` images per block and the 3x3 conv as one
  K = 9*Cm product over im2col patches. Its output equals B8a's.

Every requant is ``clip(round(acc * scale + bias))`` in f32 with the scales
folded beforehand (:func:`build_bottleneck_args`, numpy, the JAX package's
order of operations term for term), multiply and add rounded separately.
These folded epilogues are not the int8 runner's (models/quant.py), so a
fused block may differ from the runner's block by one int8 step on rare
elements.

On a CUDA tensor a wrapper launches its kernel (counted in its ``launches``
attribute) or raises; on a CPU tensor it runs the plain version. Weights
feed the kernels K-minor (:func:`bottleneck_device_args`). Shapes the
kernels take: Cin % 32 == 0, Cm % 32 == 0, Cout % 8 == 0, Cin == Cout for
the identity residual, a tile of one image row that fits a block's shared
memory; N % imgs == 0 for B8b.
"""

from __future__ import annotations

import numpy as np
import torch

from posetpu_torch.ops import _build
from posetpu_torch.ops.int_mm import int_mm
from posetpu_torch.ops.phase_tail import _k_minor, _np, _to, check_cuda, stream_of

# 3x3 taps in (dy, dx) row-major order, matching the HWIO kernel's rows
_TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

_P, _I = _build.P, _build.I
_SIGNATURES = {"bottleneck": [_P] * 11 + [_I] * 10 + [_P],
               "bottleneck_static_smem": []}
_SMEM_PER_BLOCK = 232448  # bytes a block can use on sm_90
_BM = 128                 # the kernels' tile rows (csrc/int8_mma.cuh)


# ------------------------------------------------------------ plain versions


def _requant(acc, v, lo: float = 0.0):
    """int32 sums -> int8, ``clip(round(acc * v[0] + v[1]), lo, 127)``; the
    ReLU is the clip floor 0."""
    return torch.clamp(torch.round(acc.float() * v[0] + v[1]), lo, 127.0).to(torch.int8)


def _taps(h1):
    """h1 [N, H, W, C] -> the nine shifted [N*H*W, C] tap operands of a 3x3
    stride-1 conv, zero beyond the border."""
    n, h, w, c = h1.shape
    hp = h1.new_zeros(n, h + 2, w + 2, c)
    hp[:, 1:h + 1, 1:w + 1] = h1
    return [hp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w].reshape(-1, c) for dy, dx in _TAPS]


def _block_tail(x2, h2, args):
    """conv3 + residual + ReLU + requant on flat rows: x2 [M, Cin], h2 [M, Cm]."""
    y = int_mm(h2, args["w3"].t()).float() * args["v3"][0] + args["v3"][1]
    if "wd" in args:  # int8 round-trip with no ReLU
        res = _requant(int_mm(x2, args["wd"].t()), args["vd"], lo=-127.0)
    else:
        res = x2
    r = res.float() * args["vr"][0] + args["vr"][1]
    return torch.clamp(torch.round(y + r), 0.0, 127.0).to(torch.int8)


def bottleneck_plain(x, args, *, h: int, w: int):
    """Plain version of :func:`fused_bottleneck`: the 3x3 conv as nine shifted
    [N*H*W, Cm] x [Cm, Cm] products."""
    n, hw, cin = x.shape
    cm = args["w1"].shape[0]
    x2 = x.reshape(n * hw, cin)
    h1 = _requant(int_mm(x2, args["w1"].t()), args["v1"])
    w2 = args["w2"].reshape(cm, 9, cm)
    acc2 = None
    for t, tap in enumerate(_taps(h1.reshape(n, h, w, cm))):
        y = int_mm(tap, w2[:, t].t())
        acc2 = y if acc2 is None else acc2 + y
    h2 = _requant(acc2, args["v2"])
    return _block_tail(x2, h2, args).reshape(n, hw, -1)


def bottleneck_v2_plain(x, args, *, h: int, w: int, imgs: int = 2):
    """Plain version of :func:`fused_bottleneck_v2`: ``imgs`` images at a
    time, the 3x3 conv as one product over their [imgs*H*W, 9*Cm] im2col
    patches."""
    n, hw, cin = x.shape
    cm = args["w1"].shape[0]
    out = []
    for i in range(0, n, imgs):
        x2 = x[i:i + imgs].reshape(imgs * hw, cin)
        h1 = _requant(int_mm(x2, args["w1"].t()), args["v1"])
        patches = torch.cat(_taps(h1.reshape(imgs, h, w, cm)), dim=1)
        h2 = _requant(int_mm(patches, args["w2"].t()), args["v2"])
        out.append(_block_tail(x2, h2, args).reshape(imgs, hw, -1))
    return torch.cat(out)


# ------------------------------------------------------------ CUDA launches


def _lib():
    return _build.load("resblock", _SIGNATURES)


def _tile_bytes(rows: int, imgs: int, w: int, cm: int, kch: int = 0) -> int:
    """Dynamic shared memory of a block of ``rows`` output rows of ``imgs``
    images: the conv1 halo tile, the conv2 output tile, and B8b's im2col
    chunk (csrc/resblock.cu)."""
    ld = cm + 16
    return imgs * (2 * rows + 2) * w * ld + (_BM * (kch + 16) if kch else 0)


def _launch(x, args, h, w, imgs, im2col, what):
    n, hw, cin = x.shape
    w1, w2, w3, wd = args["w1"], args["w2"], args["w3"], args.get("wd")
    cm, cout = w1.shape[0], w3.shape[0]
    if hw != h * w:
        raise ValueError(f"{what}: x has {hw} pixels per image, not {h}x{w}")
    if (x.dtype != torch.int8 or w1.shape != (cm, cin) or w2.shape != (cm, 9 * cm)
            or w3.shape != (cout, cm) or cin % 32 or cm % 32 or cout % 8
            or (wd is None and cin != cout)
            or (wd is not None and wd.shape != (cout, cin))):
        raise ValueError(
            f"{what}: unsupported shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
            f"w2 {tuple(w2.shape)}, w3 {tuple(w3.shape)} (Cin % 32 == 0, Cm % 32 == 0, "
            f"Cout % 8 == 0, Cin == Cout for the identity residual)")
    vecs = {k: args[k] for k in ("v1", "v2", "v3", "vr")}
    if wd is not None:
        vecs["vd"] = args["vd"]
    check_cuda(what, x=x, w1=w1, w2=w2, w3=w3, **vecs,
               **({} if wd is None else {"wd": wd}))
    lib = _lib()
    budget = _SMEM_PER_BLOCK - lib.bottleneck_static_smem()
    # rows per block: about 256 (B8b: 128) tile pixels, fewer where the tiles
    # would not fit; B8b's im2col chunk takes the largest depth that fits
    rows = max(1, min(h, (128 if im2col else 256) // (imgs * w)))
    while rows > 1 and _tile_bytes(rows, imgs, w, cm, 32 if im2col else 0) > budget:
        rows -= 1
    kch = 0
    if im2col:
        kch = max((d for d in range(32, 9 * cm + 1, 32)
                   if (9 * cm) % d == 0 and _tile_bytes(rows, imgs, w, cm, d) <= budget),
                  default=0)
    if _tile_bytes(rows, imgs, w, cm, kch) > budget or (im2col and not kch):
        raise ValueError(f"{what}: one row of {imgs} image(s) of width {w} at Cm {cm} "
                         f"does not fit a block's shared memory")
    out = torch.empty((n, hw, cout), dtype=torch.int8, device=x.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    _build.check(lib.bottleneck(
        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(), ptr(wd),
        args["v1"].data_ptr(), args["v2"].data_ptr(), args["v3"].data_ptr(),
        ptr(args.get("vd")), args["vr"].data_ptr(), out.data_ptr(), n, h, w, cin,
        cm, cout, rows, imgs, kch, int(im2col), stream_of(x)), what)
    return out


# ------------------------------------------------------------ the wrappers


def fused_bottleneck(x, args, *, h: int, w: int):
    """Run one fused stride-1 int8 bottleneck block. x: [N, H*W, Cin] int8;
    ``args`` from :func:`bottleneck_device_args`. Returns [N, H*W, Cout] int8."""
    if not x.is_cuda:
        return bottleneck_plain(x, args, h=h, w=w)
    out = _launch(x, args, h, w, 1, False, "fused_bottleneck")
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0


def fused_bottleneck_v2(x, args, *, h: int, w: int, imgs: int = 2):
    """The fused block with the identity residual, ``imgs`` images per block
    and the 3x3 conv over im2col patches. x: [N, H*W, Cin] int8, N a multiple
    of ``imgs`` -> [N, H*W, Cout] int8."""
    if x.shape[0] % imgs or "wd" in args:
        raise ValueError(f"fused_bottleneck_v2: identity residual only, and "
                         f"{x.shape[0]} images do not split into groups of {imgs}")
    if not x.is_cuda:
        return bottleneck_v2_plain(x, args, h=h, w=w, imgs=imgs)
    out = _launch(x, args, h, w, imgs, True, "fused_bottleneck_v2")
    fused_bottleneck_v2.launches += 1
    return out


fused_bottleneck_v2.launches = 0


# ------------------------------------------------------------ argument packing


def build_bottleneck_args(qparams, name: str, s_in: float) -> dict:
    """Fold the per-site scales of block ``name`` (e.g. "layer1_1") into
    kernel arguments, as numpy in the JAX package's layout: w1 [Cin, Cm], w2
    [9, Cm, Cm], w3 [Cm, Cout] (and wd [Cin, Cout]) int8, v* [2, C] f32 (scale,
    bias). ``s_in``: the block input's activation scale. Each step of
    ``s_in * ws / s1`` rounds to f32, as in the JAX package."""
    q = qparams
    ws, b, aw = q["w_scales"], q["biases"], q["weights"]
    s_act = q["act_scales"]

    def f32(a):
        return np.asarray(_np(a), np.float32)

    s1 = float(s_act[f"{name}.conv1.out"])
    s2 = float(s_act[f"{name}.conv2.out"])
    s_out = float(s_act[f"{name}.out"])

    w2 = _np(aw[f"{name}.conv2"])  # [3, 3, Cm, Cm]
    args = {
        "w1": _np(aw[f"{name}.conv1"])[0, 0],  # [Cin, Cm]
        "w2": w2.reshape((9,) + w2.shape[2:]),
        "w3": _np(aw[f"{name}.conv3"])[0, 0],
        "v1": np.stack([s_in * f32(ws[f"{name}.conv1"]) / s1, f32(b[f"{name}.conv1"]) / s1]),
        "v2": np.stack([s1 * f32(ws[f"{name}.conv2"]) / s2, f32(b[f"{name}.conv2"]) / s2]),
        # conv3's result stays f32 until the add: 1/s_out folds in here and into vr
        "v3": np.stack([s2 * f32(ws[f"{name}.conv3"]) / s_out,
                        f32(b[f"{name}.conv3"]) / s_out]),
    }
    cout = args["w3"].shape[1]
    if f"{name}.downsample" in aw:
        sd = float(s_act[f"{name}.downsample.out"])
        args["wd"] = _np(aw[f"{name}.downsample"])[0, 0]
        args["vd"] = np.stack([s_in * f32(ws[f"{name}.downsample"]) / sd,
                               f32(b[f"{name}.downsample"]) / sd])
        r_scale = sd / s_out
    else:
        r_scale = s_in / s_out
    args["vr"] = np.stack([np.full((cout,), r_scale, np.float32),
                           np.zeros((cout,), np.float32)])
    return args


def bottleneck_device_args(args: dict, device) -> dict:
    """JAX-layout bottleneck args (numpy or arrays) -> the kernels' tensors:
    w1 [Cm, Cin], w2 [Cm, 9*Cm] (tap-major depth), w3 [Cout, Cm], wd
    [Cout, Cin] int8 (K-minor); v* [2, C] f32 as given."""
    cm = args["w1"].shape[1]
    out = {k: _k_minor(args[k], device) for k in ("w1", "w3", "wd") if k in args}
    out["w2"] = _k_minor(np.asarray(_np(args["w2"])).reshape(9 * cm, cm), device)
    out.update({k: _to(args[k], device) for k in ("v1", "v2", "v3", "vd", "vr")
                if k in args})
    return out
