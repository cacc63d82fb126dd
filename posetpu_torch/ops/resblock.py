"""The fused int8 ResNet bottleneck block (B8a, B8b): hand-written CUDA
kernels (``csrc/resblock.cu``) with their plain PyTorch versions beside them.

Ports posetpu/ops/pallas/resblock.py with the same contracts:

- ``fused_bottleneck(x [N, H*W, Cin] int8, args, h=, w=)`` (B8a) -> int8
  [N, H*W, Cout]: conv1 1x1 -> requant -> conv2 3x3 -> requant -> conv3 1x1
  + residual -> ReLU -> requant. The residual is x itself (Cin == Cout), or,
  with ``wd`` in the args, a 1x1 projection of x requantised to int8 with no
  ReLU before it is dequantised into the add;
- ``fused_bottleneck_v2(..., imgs=2)`` (B8b): the same function for the
  identity residual (the TPU kernel: ``imgs`` images a grid step, the 3x3
  conv as one K = 9*Cm product over im2col patches). Its kernel is three
  chained wgmma GEMMs on an h1 halo kept in shared memory, 128 output pixels
  a block (:func:`plan_v2`); its output equals B8a's.

Every requant is ``clip(round(acc * scale + bias))`` in f32 with the scales
folded beforehand (:func:`build_bottleneck_args`, numpy, the JAX package's
order of operations term for term), multiply and add rounded separately.
These folded epilogues are not the int8 runner's (models/quant.py), so a
fused block may differ from the runner's block by one int8 step on rare
elements.

On a CUDA tensor a wrapper launches its kernel (counted in its ``launches``
attribute) or raises; on a CPU tensor it runs the plain version. Weights
feed the plain versions K-minor and the kernels as stage images of their
shared-memory rings (:func:`bottleneck_device_args`, :func:`tile_weight`).
Shapes the kernels take: Cin % 32 == 0, Cm % 32 == 0, Cout % 8 == 0, Cin ==
Cout for the identity residual, a block that fits shared memory (B8a: one
image row; B8b: its h1 halo and h2); N % imgs == 0 for B8b.

A launch costs the host little: the block shape is planned once per layer
shape by a pure, cached function (:func:`plan_rows`, :func:`plan_v2`),
the C side sets a kernel's shared-memory attribute only when a launch asks
for more than any before it, and the library is loaded once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from posetpu_torch.ops import _build
from posetpu_torch.ops.int_mm import int_mm
from posetpu_torch.ops.phase_tail import _k_minor, _np, _to, check_cuda, sm_count, stream_of

# 3x3 taps in (dy, dx) row-major order, matching the HWIO kernel's rows
_TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

_P, _I = _build.P, _build.I
_SIGNATURES = {"bottleneck_rows": [_P] * 11 + [_I] * 14 + [_P],
               "bottleneck_rows_blocks_per_sm": [_I, _I],
               "bottleneck_v2": [_P] * 9 + [_I] * 19 + [_P],
               "bottleneck_v2_clocked": [_P] * 10 + [_I] * 19 + [_P],
               "bottleneck_v2_blocks_per_sm": [_I] * 4}
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


# B8b (csrc/resblock.cu, bottleneck_v2_kernel): a job is one image's tile,
# 16 x 8 output pixels ("tile") or 8 x 8 whose warpgroups split every conv's
# columns ("split"); the tile rows of each
V2_FORMS = {"tile": 16, "split": 8}
# the ring: (weight images a stage, stages), the first that fits a block
# (measured on the H100 at ResNet-50's identity blocks within 2-3 % of the
# best ring each: tools/torch_kernel_sweep.py v2, PERF.md)
V2_RINGS = ((2, 4), (2, 3), (1, 4), (1, 3), (1, 2), (2, 2))
_V2_HW = 10              # halo pixels a row
_V2_OVERREAD = 2048      # conv1's last slice reads past the last halo image
_V2_STAGING = _BM * (128 + 16) + 4 * 128 * 4  # a staging tile: the residual, v3 / vr slices
# the clock64 counters of csrc/resblock.cu's timed instances (a measurement:
# _launch_v2(clocks=)): cycles a warpgroup's first thread spent in each part,
# summed over threads
V2_CLOCK_SLOTS = ("total", "full wait", "wgmma issue + wait", "conv1 epilogue",
                  "conv2 epilogue", "conv3 stores", "prologue", "steps",
                  "producer empty wait", "jobs", "conv1 full wait", "conv3 drain",
                  "conv3 residual wait", "conv3 epilogue", "conv1 drain", "conv2 drain")


class V2Plan(NamedTuple):
    """B8b's block for one layer (csrc/resblock.cu, V2Args and V2Layout): the
    form (:data:`V2_FORMS`), its tiles across and down the image, the ring
    (``stages`` of ``ips`` 64-byte weight images, and in conv1 beside each
    the same 64 channels of x's halo, ``a_img`` bytes: [halo pixel][64
    bytes], 1024-byte aligned), and where the regions of dynamic shared
    memory start: h1 at 0 (and over it, from conv3 on, conv3's two staging
    tiles), the ring's weight images, its halo planes, h2, a zero weight
    image (two images a stage: the B of a step past an n-tile's last image),
    v1 and v2, the mbarriers."""
    form: str
    tile_h: int
    tiles_x: int
    tiles_y: int
    stages: int
    ips: int
    a_img: int
    h1: int     # bytes of h1 [Cm / 16][halo pixels][16]
    h2: int     # bytes of h2 [Cm / 16][output pixels][16]
    off_ring_b: int
    off_ring_a: int
    off_h2: int
    off_zero: int
    off_pv: int
    off_bar: int
    smem: int


def _v2_layout(form: str, h: int, w: int, cm: int, ips: int, stages: int) -> V2Plan:
    tile_h = V2_FORMS[form]
    hp = (tile_h + 2) * _V2_HW
    a_img = _up(hp * 64, 1024)
    h1, h2 = cm * hp, cm * (64 if form == "split" else _BM)
    off_ring_b = _up(max(h1, 2 * _V2_STAGING), 1024)
    off_ring_a = off_ring_b + stages * ips * _BM * _KB
    off_h2 = off_ring_a + _up(stages * ips * a_img + _V2_OVERREAD)
    off_zero = _up(off_h2 + h2, 1024)
    off_pv = off_zero + (_BM * _KB if ips == 2 else 0)
    off_bar = _up(off_pv + 16 * cm, 16)
    return V2Plan(form, tile_h, -(-w // 8), -(-h // tile_h), stages, ips, a_img, h1, h2,
                  off_ring_b, off_ring_a, off_h2, off_zero, off_pv, off_bar,
                  off_bar + 16 * stages)


@functools.lru_cache(maxsize=None)
def plan_v2(h: int, w: int, cin: int, cm: int, cout: int, *, form: str | None = None,
            stages: int | None = None, ips: int | None = None) -> V2Plan:
    """B8b's block for one layer, a pure function of its shapes (cached: a
    launch looks it up). ``form`` defaults to "split" for an image of at
    most 8 x 8 pixels and "tile" otherwise (at 8 x 8 the split form
    measured faster than a tile of two images, one a warpgroup: PERF.md).
    The ring defaults to the first of :data:`V2_RINGS` that fits; ``ips``
    (1 or 2) and ``stages`` (>= 2) pin it. A shape that does not fit is an
    error that names it."""
    if form is None:
        form = "split" if h <= 8 and w <= 8 else "tile"
    if form not in V2_FORMS:
        raise ValueError(f"fused_bottleneck_v2: no form {form!r}")
    if ips not in (None, 1, 2) or (stages is not None and stages < 2):
        raise ValueError(f"fused_bottleneck_v2: a ring of {stages} stages of {ips} images")
    if stages is not None:
        rings = [(i, stages) for i in ((2, 1) if ips is None else (ips,))]
    else:
        rings = [(i, s) for i, s in V2_RINGS if ips in (None, i)]
    plans = [_v2_layout(form, h, w, cm, i, s) for i, s in rings]
    plans = [pl for pl in plans if pl.smem <= _SMEM_PER_BLOCK]
    if not plans:
        raise ValueError(f"fused_bottleneck_v2: a {form} block of {h}x{w} images at Cin {cin}, "
                         f"Cm {cm}, Cout {cout} with a ring of "
                         f"{'any' if stages is None else stages} stage(s) of "
                         f"{'any' if ips is None else ips} image(s) does not fit a block's "
                         f"shared memory")
    return plans[0]


# ------------------------------------------------------------ CUDA launches


@functools.lru_cache(maxsize=None)
def _lib():
    return _build.load("resblock", _SIGNATURES)


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


def _tiled_weights(args, cin, cm, cout, what="fused_bottleneck"):
    """The stage images out of ``args`` (B8a's and B8b's), each of the shape
    its weight and tile height give (:func:`with_tiled_weights`), or an
    error."""
    bn12 = 64 if cm <= 64 else _BM
    want = {"w1t": (cm, cin, bn12), "w2t": (cm, 9 * cm, bn12), "w3t": (cout, cm, _BM)}
    if "wd" in args:
        want["wdt"] = (cout, cin, _BM)
    tiled = {}
    for key, (n, k, bn) in want.items():
        t = args.get(key)
        if (t is None or t.dtype != torch.int8
                or tuple(t.shape) != (-(-n // bn), -(-k // _KB), bn, _KB)):
            raise ValueError(f"{what}: args lack the tiled weight {key} that "
                             f"bottleneck_device_args makes (with_tiled_weights)")
        tiled[key] = t
    check_cuda(what, **tiled)
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


def _launch_v2(x, args, h, w, form=None, stages=None, ips=None, clocks=None):
    """One launch of B8b's kernel at the planned block (or the one pinned by
    ``form``, ``stages``, ``ips``); ``clocks`` (a measurement): an int64 CUDA
    tensor of len(:data:`V2_CLOCK_SLOTS`) that the kernel's timed instance
    adds its cycle counts to."""
    n, cin, cm, cout = _checked(x, args, h, w, "fused_bottleneck_v2")
    tiled = _tiled_weights(args, cin, cm, cout, "fused_bottleneck_v2")
    plan = plan_v2(h, w, cin, cm, cout, form=form, stages=stages, ips=ips)
    out = torch.empty((n, h * w, cout), dtype=torch.int8, device=x.device)
    head = [x.data_ptr(), tiled["w1t"].data_ptr(), tiled["w2t"].data_ptr(),
            tiled["w3t"].data_ptr(), args["v1"].data_ptr(), args["v2"].data_ptr(),
            args["v3"].data_ptr(), args["vr"].data_ptr(), out.data_ptr()]
    tail = [n, h, w, cin, cm, cout, plan.tile_h, int(plan.form == "split"), plan.stages,
            plan.ips, plan.a_img, plan.off_ring_b, plan.off_ring_a, plan.off_h2, plan.off_zero,
            plan.off_pv, plan.off_bar, plan.smem, sm_count(x.device.index), stream_of(x)]
    if clocks is None:
        rc = _lib().bottleneck_v2(*head, *tail)
    else:
        rc = _lib().bottleneck_v2_clocked(*head, clocks.data_ptr(), *tail)
    _build.check(rc, "fused_bottleneck_v2")
    return out


def rows_blocks_per_sm(cm: int, smem: int) -> int:
    """Blocks of B8a's kernel the card puts on one SM at ``smem`` bytes of
    dynamic shared memory (registers and shared memory together)."""
    blocks = _lib().bottleneck_rows_blocks_per_sm(cm, smem)
    if blocks < 0:
        raise RuntimeError(f"bottleneck_rows_blocks_per_sm: CUDA error {-blocks}")
    return blocks


def v2_blocks_per_sm(plan: V2Plan, cm: int) -> int:
    """Blocks of B8b's instance for ``plan`` the card puts on one SM."""
    blocks = _lib().bottleneck_v2_blocks_per_sm(cm, int(plan.form == "split"), plan.ips,
                                                 plan.smem)
    if blocks < 0:
        raise RuntimeError(f"bottleneck_v2_blocks_per_sm: CUDA error {-blocks}")
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
    """The fused block with the identity residual. x: [N, H*W, Cin] int8, N a
    multiple of ``imgs`` -> [N, H*W, Cout] int8, equal to
    :func:`fused_bottleneck`'s. The result does not depend on ``imgs`` (the
    TPU kernel's images a grid step): the plain version takes the images
    ``imgs`` at a time, and the kernel's planner (:func:`plan_v2`) does not
    use it: a job is one image's tile whatever ``imgs`` is."""
    if x.shape[0] % imgs or "wd" in args:
        raise ValueError(f"fused_bottleneck_v2: identity residual only, and "
                         f"{x.shape[0]} images do not split into groups of {imgs}")
    if not x.is_cuda:
        return bottleneck_v2_plain(x, args, h=h, w=w, imgs=imgs)
    out = _launch_v2(x, args, h, w)
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
    [Cout, Cin] int8 (K-minor, what the plain versions read); w1t, w2t, w3t,
    wdt the same as the kernels' stage images (:func:`tile_weight`); v*
    [2, C] f32 as given."""
    cm = args["w1"].shape[1]
    out = {k: _k_minor(args[k], device) for k in ("w1", "w3", "wd") if k in args}
    out["w2"] = _k_minor(np.asarray(_np(args["w2"])).reshape(9 * cm, cm), device)
    out.update({k: _to(args[k], device) for k in ("v1", "v2", "v3", "vd", "vr")
                if k in args})
    return with_tiled_weights(out)
