"""The phase-domain deconvolution tail: an inner deconv (B2, B6), the last
deconv + the 1x1 head (B5) and the last two deconvs + head (B1), each an
instance of one hand-written CUDA kernel (``csrc/tail2.cu``) with its plain
PyTorch version beside it.

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

The kernel (``csrc/tail2.cu``): a block takes a 16 x 8 tile of the input
grid and its halo once and runs wgmma with A read from the halo; its shared
memory is planned per shape by the pure :func:`plan_tail2`, and the weights
arrive as the stage images :func:`tile_phase_weight` makes. Its instances
are named by the epilogue (:data:`EPILOGUES`), the design (:data:`DESIGNS`)
and the store (:data:`STORES`), and :func:`launch_tail2` launches each. B1
is two launches, deconv1 into an interleaved z1, then deconv2 with the head,
z2 kept in shared memory (``tail2_device_args``); B5 is B1's second launch
with the levels=1 store (``tail_device_args``). The same kernel, with B9's
folded per-phase epilogue and row-major head, and with the input streamed
where its halo does not fit, is B9a and B9b (ops/deconv.py); with B1's
requant on per-phase vectors and the streamed halo (:data:`STREAM_DESIGN`,
:func:`stream_sets`, :data:`STREAM_STAGES`) it is B2 (the phase-major store)
and B6 (the N-minor store), whose arguments :func:`subpixel_device_args`
makes (the streamed halo's stage images ``wt`` and the vectors ``svb``
beside the K-minor ``w`` the plain version reads).

On a CUDA tensor the wrapper launches the kernel (and counts the launch in
its ``launches`` attribute); on a CPU tensor it runs the plain version,
which repeats the arithmetic with exact int8 x int8 -> int32 products
(``ops/int_mm.py``) and the same separately rounded f32 epilogue.

Weights feed the kernels K-minor ([..., Cout, Cin]: the operand form of the
int8 tensor-core instruction); :func:`subpixel_device_args`,
:func:`tail_device_args` and :func:`tail2_device_args` turn the ``build_*_args``
functions' JAX-layout numpy args into that form on a device.

Shapes the kernels take: Cin % 32 == 0, Cout % 8 == 0, at most 32 joints,
even H and W of the levels=2 head's input; any batch and image size. A
wrapper raises ``ValueError`` on anything else.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from posetpu_torch.ops import _build
from posetpu_torch.ops.int_mm import int_mm

# Route the int8 forward's inner subpixel deconvs through the batched kernel
# (B2). False routes them through the per-pair contract (B6, N-minor output
# + subpixel_interleave_packed). models/quant._forward reads this per call.
SUBPIX_BATCHED = True

_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))

# deconv0's design (Cin 2048: the resident halo does not fit), B9a's, B2's
# and B6's: the streamed halo with a ring of 7 stages (one block an SM) and
# the (phase, n-half) pairs a block of stream_sets, measured on the H100 at
# 32, 128 and 256 images of 8x8 (tools/torch_kernel_sweep.py deconv; PERF.md)
STREAM_DESIGN, STREAM_STAGES = "stream", 7
_P, _I = _build.P, _build.I
_TAIL2_SIGNATURES = {"tail2": [_P] * 7 + [_I] * 18 + [_P],
                     "tail2_blocks_per_sm": [_I] * 5}


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


# ------------------------------------------------------------ the kernel's block shape

# csrc/tail2.cu: the resident halo's input tile (two warpgroups of 8 rows of 8
# pixels), bytes of K a weight stage image, channels an n-half, a row of the
# requantised half
TAIL2_TILE = (16, 8)
_T2_KB, _T2_BN = 64, 128
_T2_LDZ = _T2_BN + 16
_SMEM_PER_BLOCK = 232448  # bytes a block can use on sm_90
# the ring, measured on the H100 at the serving shapes (tools/torch_kernel_sweep.py
# tail2): two stages of two stage images (128 bytes of K) keep two blocks on
# an SM and beat deeper or shallower rings by 3-25 %
TAIL2_STAGES, _T2_IPS = 2, 2
# the A operand's designs (csrc/tail2.cu, ASource): the halo tile resident in
# shared memory; its planes streamed through the ring by TMA, an 8 x 8 tile
# of one image a warpgroup (two planes of two images' halos a ring stage)
DESIGNS = ("halo", "stream")
# the epilogues (csrc/tail2.cu, Epilogue, in its order): B1's and B5's relu
# requant on shared vectors, B9's folded per-phase one, B2's and B6's relu
# requant on per-phase rows
EPILOGUES = ("relu", "folded", "relu_phase")
# the stores (csrc/tail2.cu, Store, in its order): the deconv's int8
# [N, 2H, 2W, Cout] interleaved (B1's deconv1, B9a), [4, N, H, W, Cout]
# phase-major (B2), [4, H, W, N, Cout] N-minor (B6); the head's f32
# [J, N, 4 H W] in the levels=2 (B1) or levels=1 (B5) packed order, and
# [N, 4 H W, J] row-major (B9b)
STORES = ("interleaved", "phase_major", "n_minor", "head_packed2", "head_packed1",
          "head_row_major")
_HEAD_STORES = STORES[3:]
_ASRC = {d: i for i, d in enumerate(DESIGNS)}
_A_BYTES = {"halo": 0, "stream": 2 * 2 * 10 * 10 * 16}


def tail2_tile(design: str) -> tuple:
    """A block's tile of the input grid: 16 x 8 of one image (the resident
    halo), 8 x 8 of two images, one a warpgroup (the streamed halo)."""
    return TAIL2_TILE if design == "halo" else (8, 8)


class Tail2Plan(NamedTuple):
    """One launch of the phase-form kernel (csrc/tail2.cu): the tiles across
    and down the input grid (:func:`tail2_tile`), the ring's stages (two
    weight stage images, 128 bytes of K, each, and in the streamed design the
    step's two halo planes), where the regions of the block's dynamic shared
    memory start (Tail2Layout), the design and the (phase, n-half) pairs a
    block takes."""
    tiles_x: int
    tiles_y: int
    stages: int
    off_ring: int
    off_z: int
    off_wh: int
    off_sc: int
    off_bar: int
    smem: int
    design: str
    sets: int


def _up(nbytes: int, to: int = 128) -> int:
    return -(-nbytes // to) * to


def _regions(cin: int, cout: int, jt: int, stages: int, design: str, folded: bool):
    """(off_ring, off_z, off_wh, off_sc, off_bar, smem) in bytes."""
    cpad = -(-cout // _T2_BN) * _T2_BN
    th, tw = TAIL2_TILE
    off_ring = _up((th + 2) * (tw + 2) * cin, 1024) if design == "halo" else 0
    stage = _T2_IPS * _T2_BN * _T2_KB + _up(_A_BYTES[design], 1024)
    off_z = off_ring + stages * stage
    off_wh = off_z + th * tw * _T2_LDZ
    off_sc = off_wh + jt * 8 * (cpad + 16)
    nvec = 8 if folded else 2  # (scale, bias), per phase when folded
    off_bar = _up(off_sc + 4 * (nvec * cpad + 2 * jt * 8), 16)
    return off_ring, off_z, off_wh, off_sc, off_bar, off_bar + 8 * stages


def halo_fits(cin: int, cout: int, jt: int, folded: bool = False,
              stages: int | None = None) -> bool:
    """Whether the resident halo's block fits an SM's shared memory."""
    stages = TAIL2_STAGES if stages is None else stages
    return _regions(cin, cout, jt, stages, "halo", folded)[-1] <= _SMEM_PER_BLOCK


@functools.lru_cache(maxsize=None)
def plan_tail2(h: int, w: int, cin: int, cout: int, jt: int,
               stages: int | None = None, *, design: str = "halo", folded: bool = False,
               sets: int | None = None) -> Tail2Plan:
    """The block shape for one launch over an h x w input grid (``jt`` 0: a
    deconv alone; 2 or 4: a deconv with a head of <= 8 jt joints; ``folded``:
    per-phase vectors, as B9's and B2's epilogues read them), a pure function of the shapes (cached: a launch
    looks it up): the design's tiles, the last row and column of them
    overhanging the grid, and the regions of shared memory in order: the halo
    tile (16-channel planes; none when streamed), the ring, the requantised
    half, the head, the scales, the ring's mbarriers. ``stages`` defaults to
    :data:`TAIL2_STAGES`, ``sets`` (the (phase, n-half) pairs a block takes,
    a divisor of their 4 NH) to all of them; a shape that does not fit a
    block is an error."""
    th, tw = tail2_tile(design)
    stages = TAIL2_STAGES if stages is None else stages
    pairs = 4 * -(-cout // _T2_BN)
    sets = pairs if sets is None else sets
    if stages < 2 or jt not in (0, 2, 4) or design not in DESIGNS:
        raise ValueError(f"plan_tail2: {stages} ring stages, jt {jt}, design {design!r}")
    if sets < 1 or pairs % sets or (jt and sets % (pairs // 4)):
        raise ValueError(f"plan_tail2: {sets} (phase, n-half) pairs a block of {pairs}"
                         + (", whole phases with a head" if jt else ""))
    if design != "halo" and jt:
        raise ValueError("plan_tail2: a head follows only the resident halo")
    plan = Tail2Plan(-(-w // tw), -(-h // th), stages,
                     *_regions(cin, cout, jt, stages, design, folded), design, sets)
    if plan.smem > _SMEM_PER_BLOCK:
        raise ValueError(f"plan_tail2: a {th} x {tw} tile ({design}) at Cin {cin}, Cout {cout} "
                         f"and {stages} ring stages needs {plan.smem} bytes of shared memory, "
                         f"more than a block has")
    return plan


@functools.lru_cache(maxsize=None)
def stream_sets(n: int, h: int, w: int, cout: int, sms: int) -> int:
    """The (phase, n-half) pairs a block of the streamed halo takes: the
    fewest whose grid is one wave on a card of ``sms`` SMs (a block an SM),
    else all of them. At deconv0's 8x8, 2048 -> 256: 4 at 128 images and 8
    at 256, each 128 blocks; the sweeps found one wave best at both (one
    block an SM that also walks more pairs beats two waves)."""
    pairs = 4 * -(-cout // _T2_BN)
    tiles = -(-h // 8) * -(-w // 8) * -(-n // 2)
    return next((sets for sets in range(1, pairs + 1)
                 if pairs % sets == 0 and tiles * (pairs // sets) <= sms), pairs)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def tail2_tiles(plan: Tail2Plan):
    """The (y0, x0) corner of every block's tile, in the grid's order."""
    th, tw = tail2_tile(plan.design)
    return [((t // plan.tiles_x) * th, (t % plan.tiles_x) * tw)
            for t in range(plan.tiles_x * plan.tiles_y)]


@functools.lru_cache(maxsize=None)
def _tail2_lib():
    return _build.load("tail2", _TAIL2_SIGNATURES)


def default_store(epilogue: str, head: bool) -> str:
    """The store an epilogue's wrapper has always taken: with a head, B1's
    levels=2 order (``"relu"``) or B9b's row-major one; without, B2's
    phase-major maps (``"relu_phase"``) or the interleaved image."""
    if head:
        return "head_row_major" if epilogue == "folded" else "head_packed2"
    return "phase_major" if epilogue == "relu_phase" else "interleaved"


def tail2_blocks_per_sm(plan: Tail2Plan, jt: int, epilogue: str = "relu") -> int:
    """Blocks of the kernel the card puts on one SM for ``plan`` and the
    instance of ``epilogue`` (one of :data:`EPILOGUES`) with its default
    store (:func:`default_store`)."""
    store = STORES.index(default_store(epilogue, jt > 0))
    blocks = _tail2_lib().tail2_blocks_per_sm(jt, EPILOGUES.index(epilogue),
                                               _ASRC[plan.design], store, plan.smem)
    if blocks < 0:
        raise RuntimeError(f"tail2_blocks_per_sm: CUDA error {-blocks}")
    return blocks


def launch_tail2(x4, wt, sc, so, wh=None, vh=None, *, epilogue="relu", store=None,
                 stages=None, design="halo", sets=None, what="launch_tail2"):
    """One launch of the phase-form kernel over x4 [N, H, W, Cin] int8 with
    the stage images ``wt`` [4, NH, 4 Cin / 64, 128, 64]
    (:func:`tile_phase_weight`, ``chunked`` for the ``"stream"`` design).
    ``epilogue`` (:data:`EPILOGUES`): ``"relu"``, B1's and B5's, ``sc``
    [2, Cout] and ``so`` [1, 1]; ``"folded"``, B9's, ``sc`` the per-phase v
    [2, 4 Cout] and no ``so``; ``"relu_phase"``, B2's and B6's (the streamed
    halo, no head), B1's arithmetic on per-phase ``sc`` [8, Cout] (the four
    phases' scales, then their biases) and ``so``. ``store`` (:data:`STORES`,
    by default :func:`default_store`'s): without a head, int8 [N, 2H, 2W,
    Cout] (``"interleaved"``), [4, N, H, W, Cout] (``"phase_major"``) or
    [4, H, W, N, Cout] (``"n_minor"``); with the padded head ``wh`` [8 jt,
    NH * 128] and ``vh`` [2, J], f32 [J, N, 4 H W] in the levels=2
    (``"head_packed2"``, even H and W) or levels=1 (``"head_packed1"``) order
    of the 2H x 2W output, or [N, 4 H W, J] (``"head_row_major"``). ``what``
    names the caller in errors."""
    n, h, w, cin = x4.shape
    nh = wt.shape[1]
    head = wh is not None
    store = default_store(epilogue, head) if store is None else store
    cout = sc.shape[-1] // 4 if epilogue == "folded" else sc.shape[-1]
    sc_shape = {"relu": (2, cout), "folded": (2, 4 * cout), "relu_phase": (8, cout)}[epilogue]
    joints = vh.shape[-1] if head else 0
    jt = (2 if joints <= 16 else 4) if head else 0
    if (x4.dtype != torch.int8 or wt.dtype != torch.int8 or cin % 32 or cout % 8
            or tuple(wt.shape) != (4, -(-cout // _T2_BN), 4 * cin // _T2_KB, _T2_BN, _T2_KB)
            or joints > 32 or (head and tuple(wh.shape) != (8 * jt, nh * _T2_BN))
            or tuple(sc.shape) != sc_shape or store not in STORES
            or head != (store in _HEAD_STORES)
            or (store == "head_packed2" and (h % 2 or w % 2))
            or (epilogue == "relu_phase" and (head or design != STREAM_DESIGN))):
        raise ValueError(f"{what}: unsupported shapes x {tuple(x4.shape)}, "
                         f"w {tuple(wt.shape)}, Cout {cout}, {joints} joints, store {store!r} "
                         f"(Cin % 32 == 0, Cout % 8 == 0, J <= 32, tiled weights)")
    tensors = {"x": x4, "w": wt, "s": sc}
    if epilogue != "folded":
        tensors["so"] = so
    if head:
        tensors.update(wh=wh, vh=vh)
    check_cuda(what, **tensors)
    plan = plan_tail2(h, w, cin, cout, jt, stages, design=design,
                      folded=epilogue != "relu", sets=sets)
    shape = {"interleaved": (n, 2 * h, 2 * w, cout), "phase_major": (4, n, h, w, cout),
             "n_minor": (4, h, w, n, cout), "head_packed2": (joints, n, 4 * h * w),
             "head_packed1": (joints, n, 4 * h * w),
             "head_row_major": (n, 4 * h * w, joints)}[store]
    out = torch.empty(shape, dtype=torch.float32 if head else torch.int8, device=x4.device)
    _build.check(_tail2_lib().tail2(
        x4.data_ptr(), wt.data_ptr(), sc.data_ptr(),
        0 if epilogue == "folded" else so.data_ptr(),
        wh.data_ptr() if head else 0, vh.data_ptr() if head else 0,
        out.data_ptr(), n, h, w, cin, cout, joints, jt, EPILOGUES.index(epilogue),
        _ASRC[design], STORES.index(store), plan.sets,
        plan.stages, plan.off_ring, plan.off_z, plan.off_wh, plan.off_sc, plan.off_bar,
        plan.smem, stream_of(x4)), what)
    return out


# ------------------------------------------------------------ the wrappers


def _subpixel_launch(x, args, h, w, store, what):
    """B2's and B6's launch: deconv0's relu requant on per-phase rows on the
    streamed halo, into ``store``'s layout."""
    n, hw, cin = x.shape
    if "wt" not in args or "svb" not in args:
        raise ValueError(f"{what}: args need the stage images and vectors of "
                         f"subpixel_device_args (wt, svb)")
    cout = args["svb"].shape[-1]
    return launch_tail2(x.reshape(n, h, w, cin), args["wt"], args["svb"], args["so"],
                        epilogue="relu_phase", store=store, design=STREAM_DESIGN,
                        stages=STREAM_STAGES,
                        sets=stream_sets(n, h, w, cout, sm_count(x.device.index)), what=what)


def fused_subpixel_deconv_batched(x, args, *, h: int, w: int):
    """x: [N, H*W, Cin] int8 (deconv input, row-major) -> int8 phase maps
    [4, N, H, W, Cout] (phase (a, b) major), requantized with per-phase
    scales. ``args`` from :func:`subpixel_device_args`. On the card: B2's
    instance of ``csrc/tail2.cu`` on the streamed halo."""
    n, hw, cin = x.shape
    if hw != h * w:
        raise ValueError(f"x has {hw} pixels per image, not {h}x{w}")
    if not x.is_cuda:
        return subpixel_deconv_plain(x, args, h=h, w=w)
    out = _subpixel_launch(x, args, h, w, "phase_major", "fused_subpixel_deconv_batched")
    fused_subpixel_deconv_batched.launches += 1
    return out


fused_subpixel_deconv_batched.launches = 0


def fused_subpixel_deconv(x, args, *, h: int, w: int):
    """x: [N, H*W, Cin] int8 (deconv input, row-major) -> int8 phase maps
    [4, H, W, N, Cout] (phase (a, b) major, image-minor), requantized with
    per-phase scales: the per-pair kernel's contract, for
    :func:`subpixel_interleave_packed`. ``args`` from
    :func:`subpixel_device_args`. On the card: B2's launch with the N-minor
    store."""
    n, hw, cin = x.shape
    if hw != h * w:
        raise ValueError(f"x has {hw} pixels per image, not {h}x{w}")
    if not x.is_cuda:
        return subpixel_deconv_pairs_plain(x, args, h=h, w=w)
    out = _subpixel_launch(x, args, h, w, "n_minor", "fused_subpixel_deconv")
    fused_subpixel_deconv.launches += 1
    return out


fused_subpixel_deconv.launches = 0


def fused_phase_tail(x, args, *, h: int, w: int):
    """x: [N, H*W, Cin] int8 (the last deconv's input, row-major) -> f32
    phase-packed heatmaps [J, N, 4*H*W] in the ``phase_index_tables
    (levels=1)`` order: column g*H*W + r is phase g, pixel r. ``args`` from
    :func:`tail_device_args`. On the card: one launch of ``csrc/tail2.cu``,
    B1's deconv2 + head with the levels=1 store."""
    n, hw, cin = x.shape
    if hw != h * w:
        raise ValueError(f"x has {hw} pixels per image, not {h}x{w}")
    if not x.is_cuda:
        return phase_tail_plain(x, args, h=h, w=w)
    if "wt" not in args or "wht" not in args:
        raise ValueError("fused_phase_tail: args need the stage images and padded head of "
                         "tail_device_args (wt, wht)")
    out = launch_tail2(x.reshape(n, h, w, cin), args["wt"], args["sv"], args["so"],
                       args["wht"], args["vh"], store="head_packed1", what="fused_phase_tail")
    fused_phase_tail.launches += 1
    return out


fused_phase_tail.launches = 0


def fused_phase_tail2(x, args, *, h: int, w: int):
    """x: [N, H*W, Cin] int8 (deconv1's input = deconv0's interleaved output)
    -> f32 two-level phase-packed heatmaps [J, N, 16*H*W]. ``args`` from
    :func:`tail2_device_args`. On the card: deconv1 into z1, then deconv2 +
    the head (``csrc/tail2.cu``)."""
    n, hw, cin = x.shape
    if hw != h * w or h % 2 or w % 2:
        raise ValueError(f"x has {hw} pixels per image, not an even {h}x{w}")
    if not x.is_cuda:
        return phase_tail2_plain(x, args, h=h, w=w)
    z1 = launch_tail2(x.reshape(n, h, w, cin), args["w1t"], args["s1"], args["so1"],
                      what="fused_phase_tail2")
    out = launch_tail2(z1, args["w2t"], args["s2"], args["so2"], args["wht"], args["vh"],
                       what="fused_phase_tail2")
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
    """JAX-layout subpixel args (numpy or arrays) -> the kernels' tensors:
    w [4, 4, Cout, Cin] int8 (K-minor, what the plain versions read), sv/bv
    [4, Cout] f32, so [1, 1] f32, and the kernel's (:func:`with_subpixel_weights`),
    which B2 and B6 both read."""
    return with_subpixel_weights(
        {"w": _k_minor(args["w"], device),
         **{k: _to(args[k], device) for k in ("sv", "bv", "so")}})


def with_subpixel_weights(args: dict) -> dict:
    """``args`` (the K-minor tensors) with B2's and B6's beside them: ``wt``
    the streamed halo's stage images (:func:`tile_phase_weight`, chunked; 8.4
    MB at deconv0's 2048 -> 256) and ``svb`` [8, Cout], sv's rows then bv's."""
    return dict(args, wt=tile_phase_weight(args["w"], chunked=True),
                svb=torch.cat([args["sv"], args["bv"]]).contiguous())


def tail_device_args(args: dict, device) -> dict:
    """JAX-layout phase-tail args -> the kernels' tensors: w [4, 4, Cout, Cin]
    and wh [J, C] int8 (K-minor, what the plain version reads), sv [2, Cout],
    so [1, 1], vh [2, J] f32, and B5's (:func:`with_tail_weights`)."""
    return with_tail_weights(
        {**{k: _k_minor(args[k], device) for k in ("w", "wh")},
         **{k: _to(args[k], device) for k in ("sv", "so", "vh")}})


def with_tail_weights(args: dict) -> dict:
    """``args`` (the K-minor tensors) with B5's stage images ``wt`` and padded
    head ``wht`` beside them, as :func:`with_tail2_weights` gives B1."""
    return dict(args, wt=tile_phase_weight(args["w"]), wht=pad_head(args["wh"]))


def tile_phase_weight(wk, chunked: bool = False):
    """Phase weights [4 phase, 4 tap, Cout, Cin] int8 (K-minor) -> the stage
    images [4, ceil(Cout / 128), 4 Cin / 64, 128, 64] of csrc/tail2.cu: phase
    g's [Cout, 4 Cin] matrix tiled as B8a tiles a weight
    (ops/resblock.tile_weight), so the kernel's flat list of k-steps (phase,
    n-half, k) reads the images in their own order. Depth k = tap * Cin + c;
    ``chunked`` (the streamed halo's order): k = (c // 32) * 128 + tap * 32 +
    c % 32, so each 128-byte step is one 32-channel chunk under all four
    taps."""
    from posetpu_torch.ops.resblock import tile_weight

    _, _, cout, cin = wk.shape
    mats = []
    for g in range(4):
        m = wk[g].permute(1, 0, 2)  # [Cout, tap, Cin]
        if chunked:
            m = m.reshape(cout, 4, cin // 32, 32).permute(0, 2, 1, 3)
        mats.append(tile_weight(m.reshape(cout, 4 * cin), _T2_BN))
    return torch.stack(mats).contiguous()


def pad_head(wh):
    """Head [J, C] int8 (K-minor) -> [8 jt, ceil(C / 128) * 128] zero padded,
    jt = 2 for J <= 16, else 4: the rows and columns B1's head reads."""
    joints, c = wh.shape
    if joints > 32:
        raise ValueError(f"pad_head: the kernels' heads take J <= 32, not {joints}")
    rows = 16 if joints <= 16 else 32
    out = wh.new_zeros((rows, -(-c // _T2_BN) * _T2_BN))
    out[:joints, :c] = wh
    return out


def tail2_device_args(args: dict, device) -> dict:
    """JAX-layout phase-tail2 args -> the kernels' tensors: w1/w2
    [4, 4, Cout, Cin] and wh [J, C] int8 (K-minor, what the plain version
    reads), w1t/w2t their stage images (:func:`tile_phase_weight`) and wht
    the padded head (:func:`pad_head`) for B1's kernel, the rest f32 as
    given."""
    out = {k: _k_minor(args[k], device) for k in ("w1", "w2", "wh")}
    out.update({k: _to(args[k], device) for k in ("s1", "so1", "s2", "so2", "vh")})
    return with_tail2_weights(out)


def with_tail2_weights(args: dict) -> dict:
    """``args`` (the K-minor tensors) with B1's stage images and padded head
    beside them."""
    return dict(args, w1t=tile_phase_weight(args["w1"]), w2t=tile_phase_weight(args["w2"]),
                wht=pad_head(args["wh"]))
