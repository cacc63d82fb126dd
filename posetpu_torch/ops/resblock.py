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
feed B8b and the plain versions K-minor and B8a as stage images of its
shared-memory ring (:func:`bottleneck_device_args`, :func:`tile_weight`).
Shapes the kernels take: Cin % 32 == 0, Cm % 32 == 0, Cout % 8 == 0, Cin ==
Cout for the identity residual, a tile of one image row that fits a block's
shared memory; N % imgs == 0 for B8b.

A launch costs the host little: the block shape is planned once per layer
shape by a pure, cached function (:func:`plan_rows`, :func:`plan_im2col`),
the C side sets a kernel's shared-memory attribute only when a launch asks
for more than any before it, and the library and its static share are
fetched once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from posetpu_torch.ops import _build
from posetpu_torch.ops.int_mm import int_mm
from posetpu_torch.ops.phase_tail import _k_minor, _np, _to, check_cuda, stream_of

# 3x3 taps in (dy, dx) row-major order, matching the HWIO kernel's rows
_TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

_P, _I = _build.P, _build.I
_SIGNATURES = {"bottleneck_rows": [_P] * 11 + [_I] * 14 + [_P],
               "bottleneck_rows_blocks_per_sm": [_I, _I],
               "bottleneck_im2col": [_P] * 9 + [_I] * 10 + [_P],
               "bottleneck_static_smem": []}
_SMEM_PER_BLOCK = 232448  # bytes a block can use on sm_90
_SMEM_PER_SM = 233472     # bytes of shared memory the blocks of one SM share
_SMEM_BLOCK_RESERVED = 1024  # taken from the SM's share for every resident block
_BM = 128                 # the kernels' tile rows (csrc/int8_mma.cuh)
# csrc/resblock.cu: bytes of K per ring stage, the two rings, a staging tile
_KB = RING_K = 64
RING_STAGES = 3
_RING = RING_STAGES * _BM * _KB  # a ring: STAGES stages of 128 rows
_S_BYTES = _BM * (128 + 16) + 6 * 128 * 4  # a staging tile and its columns' scale slices
_TILE_PIXELS = 256        # output pixels per block at most: two 128-row tiles


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


# ------------------------------------------------------------ block shapes


class RowsPlan(NamedTuple):
    """B8a's block shape: ``th`` output rows per block and where the regions
    of its dynamic shared memory start (csrc/resblock.cu, RowsLayout)."""
    th: int
    off_h2: int
    off_ring_a: int
    off_ring_b: int
    off_pv: int
    off_bar: int
    ns: int    # staging tiles for the residual and the output
    smem: int  # bytes of dynamic shared memory
    blocks_per_sm: int  # as far as shared memory decides


def _up(nbytes: int, to: int = 128) -> int:
    return -(-nbytes // to) * to


def _rows_layout(th: int, w: int, cin: int, cm: int, has_wd: bool, ns: int) -> RowsPlan:
    ld = cm + 16
    h1 = (th + 2) * (w + 2) * ld  # one zero column left and right of every row
    h2 = th * w * ld
    off_h2 = _up(max(h1, ns * _S_BYTES), 1024)  # the staging tiles lie over h1
    if has_wd:  # the projection streams x while h2 is in use
        off_ring_a = off_h2 + _up(h2, 1024)
        off_ring_b = off_ring_a + _RING
    else:       # only conv1 streams x: its ring lies over h2
        off_ring_a = off_h2
        off_ring_b = off_h2 + _up(max(h2, _RING), 1024)
    off_pv = off_ring_b + _RING      # v1 and v2, [2, cm] f32 each
    off_bar = off_pv + 16 * cm       # the ring's mbarriers
    smem = off_bar + 64
    return RowsPlan(th, off_h2, off_ring_a, off_ring_b, off_pv, off_bar, ns, smem,
                    _SMEM_PER_SM // (smem + _SMEM_BLOCK_RESERVED))


@functools.lru_cache(maxsize=None)
def plan_rows(h: int, w: int, cin: int, cm: int, cout: int, has_wd: bool,
              th: int | None = None) -> RowsPlan:
    """The block shape of B8a for one layer, a pure function of its shapes
    (cached: a launch looks it up). ``th`` rows per block, among the heights
    whose output tile is at most ``_TILE_PIXELS`` pixels and whose regions
    fit a block: one that divides h, fills the 128-row product tile, leaves
    room for a second block on the SM, and then the largest, in that order
    of weight. Three staging tiles (a conv3 tile's inputs asked for two
    tiles ahead) where a conv3 tile is a single k-step and the shape is
    otherwise as good, else two. ``th`` given: that height, or an error."""
    one_step = -(-cm // _KB) + (-(-cin // _KB) if has_wd else 0) < 2
    heights = [th] if th is not None else range(1, max(1, min(h, _TILE_PIXELS // w)) + 1)
    plans = [_rows_layout(t, w, cin, cm, has_wd, ns)
             for t in heights for ns in ((2, 3) if one_step else (2,))]
    if th is not None and not 1 <= th <= h:
        plans = []
    plans = [pl for pl in plans if pl.smem <= _SMEM_PER_BLOCK]
    if not plans:
        raise ValueError(f"fused_bottleneck: {'one image row' if th is None else f'{th} rows'} "
                         f"of width {w} at Cm {cm} do not fit a block's shared memory")
    # measured on the H100 at ResNet-50's shapes (tools/torch_kernel_sweep.py
    # sweep): heights that divide h, then tiles that fill the 128-row product
    # tile, then a second block on the SM, then the most rows (least halo)
    return max(plans, key=lambda pl: (h % pl.th == 0, min(pl.th * w, _BM),
                                      min(pl.blocks_per_sm, 2), pl.th, pl.ns))


class Im2colPlan(NamedTuple):
    """B8b's block shape: rows per block, im2col depth per chunk, bytes."""
    th: int
    kch: int
    smem: int


def _im2col_bytes(rows: int, imgs: int, w: int, cm: int, kch: int) -> int:
    """Dynamic shared memory of a B8b block of ``rows`` output rows of
    ``imgs`` images: the conv1 halo tile, the conv2 output tile, and the
    im2col chunk (csrc/resblock.cu)."""
    return imgs * (2 * rows + 2) * w * (cm + 16) + _BM * (kch + 16)


@functools.lru_cache(maxsize=None)
def plan_im2col(h: int, w: int, cm: int, imgs: int, static_smem: int) -> Im2colPlan:
    """B8b: about 128 tile pixels per block, fewer where the tiles would not
    fit beside ``static_smem`` bytes of the kernel's own; the im2col chunk
    takes the largest divisor of 9*Cm that fits."""
    budget = _SMEM_PER_BLOCK - static_smem
    rows = max(1, min(h, 128 // (imgs * w)))
    while rows > 1 and _im2col_bytes(rows, imgs, w, cm, 32) > budget:
        rows -= 1
    kch = max((d for d in range(32, 9 * cm + 1, 32)
               if (9 * cm) % d == 0 and _im2col_bytes(rows, imgs, w, cm, d) <= budget),
              default=0)
    if not kch:
        raise ValueError(f"fused_bottleneck_v2: one row of {imgs} image(s) of width {w} "
                         f"at Cm {cm} does not fit a block's shared memory")
    return Im2colPlan(rows, kch, _im2col_bytes(rows, imgs, w, cm, kch))


# ------------------------------------------------------------ CUDA launches


@functools.lru_cache(maxsize=None)
def _lib():
    return _build.load("resblock", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def _static_smem() -> int:
    return _lib().bottleneck_static_smem()


def _checked(x, args, h, w, what):
    """Shapes, types and placement the kernels take, or an error."""
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
        vecs["wd"] = wd
    check_cuda(what, x=x, w1=w1, w2=w2, w3=w3, **vecs)
    return n, cin, cm, cout


def _tiled_weights(args, cin, cm, cout):
    """B8a's stage images out of ``args``, each of the shape its weight and
    tile height give (:func:`with_tiled_weights`), or an error."""
    bn12 = 64 if cm <= 64 else _BM
    want = {"w1t": (cm, cin, bn12), "w2t": (cm, 9 * cm, bn12), "w3t": (cout, cm, _BM)}
    if "wd" in args:
        want["wdt"] = (cout, cin, _BM)
    tiled = {}
    for key, (n, k, bn) in want.items():
        t = args.get(key)
        if (t is None or t.dtype != torch.int8
                or tuple(t.shape) != (-(-n // bn), -(-k // _KB), bn, _KB)):
            raise ValueError(f"fused_bottleneck: args lack the tiled weight {key} that "
                             f"bottleneck_device_args makes (with_tiled_weights)")
        tiled[key] = t
    check_cuda("fused_bottleneck", **tiled)
    return tiled


def _launch_rows(x, args, h, w, th=None):
    n, cin, cm, cout = _checked(x, args, h, w, "fused_bottleneck")
    tiled = _tiled_weights(args, cin, cm, cout)
    has_wd = "wd" in args
    plan = plan_rows(h, w, cin, cm, cout, has_wd, th)
    out = torch.empty((n, h * w, cout), dtype=torch.int8, device=x.device)
    _build.check(_lib().bottleneck_rows(
        x.data_ptr(), tiled["w1t"].data_ptr(), tiled["w2t"].data_ptr(),
        tiled["w3t"].data_ptr(), tiled["wdt"].data_ptr() if has_wd else 0,
        args["v1"].data_ptr(), args["v2"].data_ptr(), args["v3"].data_ptr(),
        args["vd"].data_ptr() if has_wd else 0, args["vr"].data_ptr(), out.data_ptr(),
        n, h, w, cin, cm, cout, plan.th, plan.off_h2, plan.off_ring_a, plan.off_ring_b,
        plan.off_pv, plan.off_bar, plan.ns, plan.smem, stream_of(x)), "fused_bottleneck")
    return out


def _launch_im2col(x, args, h, w, imgs):
    n, cin, cm, cout = _checked(x, args, h, w, "fused_bottleneck_v2")
    plan = plan_im2col(h, w, cm, imgs, _static_smem())
    out = torch.empty((n, h * w, cout), dtype=torch.int8, device=x.device)
    _build.check(_lib().bottleneck_im2col(
        x.data_ptr(), args["w1"].data_ptr(), args["w2"].data_ptr(), args["w3"].data_ptr(),
        args["v1"].data_ptr(), args["v2"].data_ptr(), args["v3"].data_ptr(),
        args["vr"].data_ptr(), out.data_ptr(), n, h, w, cin, cm, cout, plan.th, imgs,
        plan.kch, plan.smem, stream_of(x)), "fused_bottleneck_v2")
    return out


def rows_blocks_per_sm(cm: int, smem: int) -> int:
    """Blocks of B8a's kernel the card puts on one SM at ``smem`` bytes of
    dynamic shared memory (registers and shared memory together)."""
    blocks = _lib().bottleneck_rows_blocks_per_sm(cm, smem)
    if blocks < 0:
        raise RuntimeError(f"bottleneck_rows_blocks_per_sm: CUDA error {-blocks}")
    return blocks


# ------------------------------------------------------------ the wrappers


def fused_bottleneck(x, args, *, h: int, w: int):
    """Run one fused stride-1 int8 bottleneck block. x: [N, H*W, Cin] int8;
    ``args`` from :func:`bottleneck_device_args`. Returns [N, H*W, Cout] int8."""
    if not x.is_cuda:
        return bottleneck_plain(x, args, h=h, w=w)
    out = _launch_rows(x, args, h, w)
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
    out = _launch_im2col(x, args, h, w, imgs)
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


def tile_weight(wk, bn: int):
    """A K-minor weight [N, K] int8 -> B8a's stage images [ceil(N / bn),
    ceil(K / 64), bn, 64]: image (nt, ks) holds rows nt*bn.. of depth
    ks*64.., zero beyond the matrix, exactly as a ring stage holds it: row r's
    four 16-byte chunks sit XOR-swizzled by (r >> 1) & 3 (wgmma's 64-byte
    swizzle), so one bulk copy brings a stage and no thread computes an
    address."""
    n, k = wk.shape
    nt, ks = -(-n // bn), -(-k // _KB)
    pad = wk.new_zeros((nt * bn, ks * _KB))
    pad[:n, :k] = wk
    img = pad.reshape(nt, bn, ks, _KB // 16, 16).permute(0, 2, 1, 3, 4)
    rows = torch.arange(bn, device=wk.device)
    src = torch.arange(_KB // 16, device=wk.device)[None, :] ^ ((rows[:, None] >> 1) & 3)
    return img[:, :, rows[:, None], src].reshape(nt, ks, bn, _KB).contiguous()


def untile_weight(img, n: int, k: int):
    """The K-minor weight [n, k] that :func:`tile_weight` made ``img`` from."""
    nt, ks, bn, _ = img.shape
    rows = torch.arange(bn, device=img.device)
    src = torch.arange(_KB // 16, device=img.device)[None, :] ^ ((rows[:, None] >> 1) & 3)
    flat = img.reshape(nt, ks, bn, _KB // 16, 16)[:, :, rows[:, None], src]
    return flat.permute(0, 2, 1, 3, 4).reshape(nt * bn, ks * _KB)[:n, :k].contiguous()


def with_tiled_weights(args: dict) -> dict:
    """``args`` (the kernels' K-minor tensors) with B8a's stage images beside
    them: conv1 and conv2 in 64-row tiles at Cm <= 64 (the kernel's narrow
    instance), the rest in 128-row tiles."""
    bn12 = 64 if args["w1"].shape[0] <= 64 else _BM
    out = dict(args, w1t=tile_weight(args["w1"], bn12), w2t=tile_weight(args["w2"], bn12),
               w3t=tile_weight(args["w3"], _BM))
    if "wd" in args:
        out["wdt"] = tile_weight(args["wd"], _BM)
    return out


def bottleneck_device_args(args: dict, device) -> dict:
    """JAX-layout bottleneck args (numpy or arrays) -> the kernels' tensors:
    w1 [Cm, Cin], w2 [Cm, 9*Cm] (tap-major depth), w3 [Cout, Cm], wd
    [Cout, Cin] int8 (K-minor, what the plain versions and B8b read); w1t,
    w2t, w3t, wdt the same as B8a's stage images (:func:`tile_weight`); v*
    [2, C] f32 as given."""
    cm = args["w1"].shape[1]
    out = {k: _k_minor(args[k], device) for k in ("w1", "w3", "wd") if k in args}
    out["w2"] = _k_minor(np.asarray(_np(args["w2"])).reshape(9 * cm, cm), device)
    out.update({k: _to(args[k], device) for k in ("v1", "v2", "v3", "vd", "vr")
                if k in args})
    return with_tiled_weights(out)
