"""Grouped int8 cross-view aggregation (B3) and its 4-bit-bank twin (B4):
hand-written CUDA kernels (``csrc/aggregation.cu``), each with its plain
PyTorch version beside it.

Ports posetpu/ops/pallas/aggregation.py's ``aggregation_grouped_pallas``
(and, as the plain version, posetpu/models/quant.py's
``aggregation_int8_apply_jns_grouped``): hm [J, N, V, S] f32 -> fused
[J, N, V, S] f32, where for each target view t

    fused[t] = (sum_p xq[src(t, p)] @ wq[t, p]) * ((x_scale / 3) * w_scale[t])

over its 3 source views, int8 products with an exact int32 sum and one f32
multiply. The f32 -> int8 quantize and permute of ``hm`` (an XLA fusion in
the JAX package) is a kernel of its own on the card
(:func:`quantize_heatmaps`, plain version :func:`_quantize`), and
``sv = (x_scale / 3) * w_scale`` is folded once, when the bank goes on the
device (:func:`aggregation_device_params`).

On a CUDA tensor the wrapper launches the kernel (counted in
``aggregation_grouped.launches``) and raises on a shape it does not take:
there is no fallback. On a CPU tensor it runs the plain version.

``qagg`` holds the bank K-minor, wq [4, 3, S_out, S_in] int8 (see
:func:`aggregation_device_params`), w_scale [4, 1, S] f32, the 0-d f32
x_scale and the folded sv [4, S] f32.

B4 ports ``aggregation_grouped_pallas_s4`` (plain version:
``aggregation_int4_apply_jns_grouped``): the bank is split w = diag(d) + R
(models/quant.quantize_aggregation_grouped_s4), R stored at 4 bits, and

    fused[t] = acc * ((x_scale / 3) * w_scale[t]) + sum_p xq[src(t, p)] * dv[t, p]

with ``dia`` summed in pair order and every multiply and add rounded on its
own. Its ``qagg`` (:func:`aggregation_device_params_s4`) holds the bank
nibble-packed K-minor, wq4 [4, 3, S_out, S_in / 2] uint8 — two weights per
byte, so the card reads half the bytes of the int8 bank — plus w_scale,
dv [4, 3, S] f32, x_scale and sv folded once. :func:`pack_nibbles_k` gives
the nibble order. On the card the wrapper runs the same quantize kernel as
B3, then B4's kernel, which widens the nibbles to int8 into shared memory
on their way to the tensor cores, on a ring of :data:`S4_STAGES`.
"""

from __future__ import annotations

import numpy as np
import torch

from posetpu_torch.ops import _build
from posetpu_torch.ops.int_mm import int_mm
from posetpu_torch.ops.phase_tail import check_cuda, stream_of

_SIGNATURES = {
    "aggregation_grouped": [_build.P] * 4 + [_build.I] * 2 + [_build.P],
    "aggregation_grouped_s4": [_build.P] * 5 + [_build.I] * 3 + [_build.P],
    "quantize_heatmaps": [_build.P] * 3 + [_build.I] * 2 + [_build.P],
}

# B4's ring: 4 stages of 40 KB, measured on the H100 at J*N 512, S 4096
# (tools/torch_kernel_sweep.py agg; PERF.md)
S4_STAGES = 4

# source views of target t, in order: {0..3} \ {t}
_SRC = [[s for s in range(4) if s != t] for t in range(4)]


def _quantize(qagg, hm):
    """hm [J, N, V, S] f32 -> xq [V, J*N, S] int8: the plain version of
    :func:`quantize_heatmaps`."""
    j, n, v, s = hm.shape
    xq8 = torch.clamp(torch.round(hm * (1.0 / qagg["x_scale"])), -127, 127
                      ).to(torch.int8)
    return xq8.permute(2, 0, 1, 3).reshape(v, j * n, s)


def fold_sv(qagg):
    """The epilogue scale sv [4, S] = (x_scale / 3) * w_scale, single-rounded
    as the JAX package folds it."""
    return ((qagg["x_scale"] / 3.0) * qagg["w_scale"]).reshape(4, -1)


def quantize_heatmaps(qagg, hm):
    """hm [J, N, 4, S] f32 -> xq [4, J*N, S] int8, ``clip(round(hm *
    (1 / x_scale)), -127, 127)`` permuted view-major, in one pass on the
    card (S % 16 == 0); the plain version :func:`_quantize` on the CPU."""
    j, n, v, s = hm.shape
    if not hm.is_cuda:
        return _quantize(qagg, hm)
    if v != 4 or s % 16 or hm.dtype != torch.float32:
        raise ValueError(f"quantize_heatmaps: unsupported hm {tuple(hm.shape)} {hm.dtype} "
                         f"(4 views, S % 16 == 0, f32)")
    hm = hm.contiguous()
    x_scale = qagg["x_scale"]
    check_cuda("quantize_heatmaps", hm=hm, x_scale=x_scale)
    xq = torch.empty((4, j * n, s), dtype=torch.int8, device=hm.device)
    _build.check(_build.load("aggregation", _SIGNATURES).quantize_heatmaps(
        hm.data_ptr(), x_scale.data_ptr(), xq.data_ptr(), j * n, s, stream_of(hm)),
        "quantize_heatmaps")
    quantize_heatmaps.launches += 1
    return xq


quantize_heatmaps.launches = 0


def _unpack(y, hm):
    """[4, J*N, S] -> [J, N, V, S] in hm's dtype."""
    j, n, v, s = hm.shape
    return y.reshape(v, j, n, s).permute(1, 2, 0, 3).to(hm.dtype)


def aggregation_grouped_plain(qagg, hm):
    """Plain version: the same int8 products and int32 pair sums through
    ``ops/int_mm.py``, then the same single f32 multiply."""
    xq, sv = _quantize(qagg, hm), qagg["sv"]
    ys = []
    for t in range(4):
        acc = None
        for p, src in enumerate(_SRC[t]):
            # out^T [S_out, JN] = wq[t, p] [S_out, S_in] @ xq[src]^T
            y = int_mm(qagg["wq"][t, p], xq[src].t())
            acc = y if acc is None else acc + y
        ys.append(acc.t().float() * sv[t])
    return _unpack(torch.stack(ys), hm)


def aggregation_grouped(qagg, hm):
    """hm [J, N, V=4, S] f32 -> fused [J, N, V, S] f32 (the grouped int8
    aggregation; see the module docstring). On the card: the quantize
    kernel, then the GEMM kernel; S % 32 == 0, any J*N."""
    j, n, v, s = hm.shape
    if v != 4:
        raise ValueError(f"the aggregation bank is built for 4 views, got {v}")
    if not hm.is_cuda:
        return aggregation_grouped_plain(qagg, hm)
    wq, sv = qagg["wq"], qagg.get("sv")
    if s % 32 or wq.shape != (4, 3, s, s) or wq.dtype != torch.int8 \
            or not wq.is_cuda or not wq.is_contiguous() or sv is None or sv.shape != (4, s):
        raise ValueError(f"aggregation_grouped: unsupported shapes hm "
                         f"{tuple(hm.shape)}, wq {tuple(wq.shape)} {wq.dtype} "
                         f"(S % 32 == 0, contiguous int8 CUDA bank, sv [4, S] from "
                         f"aggregation_device_params)")
    check_cuda("aggregation_grouped", sv=sv)
    xq = quantize_heatmaps(qagg, hm)
    out = torch.empty((4, j * n, s), dtype=torch.float32, device=hm.device)
    _build.check(_build.load("aggregation", _SIGNATURES).aggregation_grouped(
        xq.data_ptr(), wq.data_ptr(), sv.data_ptr(), out.data_ptr(), j * n, s,
        stream_of(hm)), "aggregation_grouped")
    aggregation_grouped.launches += 1
    return _unpack(out, hm)


aggregation_grouped.launches = 0


# ------------------------------------------------------------ the s4 bank (B4)


def pack_nibbles_k(w):
    """int8 values in [-8, 7], [..., K] with K % 32 == 0 -> uint8 [..., K/2].
    In every block of 32 along K, byte b (0..15) holds k = b in its low
    nibble and k = 16 + b in its high nibble: one 32-bit word of a block is
    then a thread's two B fragments of the int8 tensor-core instruction
    (k = 4i..4i+3 and 16+4i..16+4i+3), with no shuffle after the unpack."""
    if w.shape[-1] % 32:
        raise ValueError(f"pack_nibbles_k: K = {w.shape[-1]} is not a multiple of 32")
    blocks = w.reshape(w.shape[:-1] + (w.shape[-1] // 32, 2, 16)).to(torch.int32)
    packed = (blocks[..., 0, :] & 0xF) | ((blocks[..., 1, :] & 0xF) << 4)
    return packed.to(torch.uint8).reshape(w.shape[:-1] + (w.shape[-1] // 2,))


def unpack_nibbles_k(p):
    """Inverse of :func:`pack_nibbles_k`: uint8 [..., K/2] -> int8 [..., K],
    sign-extended by (x ^ 8) - 8."""
    blocks = p.reshape(p.shape[:-1] + (p.shape[-1] // 16, 16)).to(torch.int32)
    lo = ((blocks & 0xF) ^ 8) - 8
    hi = (((blocks >> 4) & 0xF) ^ 8) - 8
    w = torch.stack([lo, hi], dim=-2).to(torch.int8)
    return w.reshape(p.shape[:-1] + (p.shape[-1] * 2,))


def aggregation_grouped_s4_plain(qagg, hm):
    """Plain version of :func:`aggregation_grouped_s4`: the residual's int8
    products and int32 pair sums through ``ops/int_mm.py`` on the unpacked
    bank, then res = acc * sv, dia over the pairs in order, res + dia."""
    xq, sv = _quantize(qagg, hm), fold_sv(qagg)
    wq = unpack_nibbles_k(qagg["wq4"])  # [4, 3, S_out, S_in] int8
    ys = []
    for t in range(4):
        acc = None
        for p, src in enumerate(_SRC[t]):
            y = int_mm(wq[t, p], xq[src].t())
            acc = y if acc is None else acc + y
        res = acc.t().float() * sv[t]
        dia = None
        for p, src in enumerate(_SRC[t]):
            d = xq[src].float() * qagg["dv"][t, p]
            dia = d if dia is None else dia + d
        ys.append(res + dia)
    return _unpack(torch.stack(ys), hm)


def aggregation_grouped_s4(qagg, hm):
    """hm [J, N, V=4, S] f32 -> fused [J, N, V, S] f32 over the diag-split
    4-bit bank (see the module docstring). On the card: the quantize kernel,
    then B4's kernel; S % 32 == 0, a contiguous uint8 CUDA bank
    [4, 3, S, S/2] and sv from :func:`aggregation_device_params_s4`; any
    J*N."""
    j, n, v, s = hm.shape
    if v != 4:
        raise ValueError(f"the aggregation bank is built for 4 views, got {v}")
    if not hm.is_cuda:
        return aggregation_grouped_s4_plain(qagg, hm)
    wq4, dv, sv = qagg["wq4"], qagg["dv"], qagg.get("sv")
    if s % 32 or wq4.shape != (4, 3, s, s // 2) or wq4.dtype != torch.uint8 \
            or not wq4.is_cuda or not wq4.is_contiguous() \
            or dv.shape != (4, 3, s) or dv.dtype != torch.float32 \
            or sv is None or sv.shape != (4, s):
        raise ValueError(f"aggregation_grouped_s4: unsupported shapes hm "
                         f"{tuple(hm.shape)}, wq4 {tuple(wq4.shape)} {wq4.dtype}, "
                         f"dv {tuple(dv.shape)} (S % 32 == 0, contiguous "
                         f"nibble-packed uint8 CUDA bank [4, 3, S, S/2], sv [4, S] from "
                         f"aggregation_device_params_s4)")
    check_cuda("aggregation_grouped_s4", dv=dv, sv=sv)
    xq = quantize_heatmaps(qagg, hm)
    out = torch.empty((4, j * n, s), dtype=torch.float32, device=hm.device)
    _build.check(_build.load("aggregation", _SIGNATURES).aggregation_grouped_s4(
        xq.data_ptr(), wq4.data_ptr(), sv.data_ptr(), dv.data_ptr(), out.data_ptr(),
        j * n, s, S4_STAGES, stream_of(hm)), "aggregation_grouped_s4")
    aggregation_grouped_s4.launches += 1
    return _unpack(out, hm)


aggregation_grouped_s4.launches = 0


def _as_np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def aggregation_device_params_s4(qagg: dict, device) -> dict:
    """A JAX-layout s4 bank (``wq4`` [4, 3, S_in, S_out] as an int8 carrier
    with values in [-7, 7], numpy or arrays) -> the B4 kernel's tensors on
    ``device``: wq4 K-minor and nibble-packed, uint8 [4, 3, S_out, S_in/2]
    (:func:`pack_nibbles_k`); w_scale [4, 1, S], dv [4, 3, S], x_scale f32,
    and sv [4, S] folded once (:func:`fold_sv`). The counterpart of the JAX
    package's ``finalize_device_params``, which casts the carrier to a 4-bit
    type on the device."""
    wq = torch.from_numpy(np.array(_as_np(qagg["wq4"]))).to(device)
    if wq.dtype != torch.int8 or int(wq.abs().max()) > 7:
        raise ValueError("aggregation_device_params_s4: wq4 must be an int8 "
                         "carrier with values in [-7, 7]")
    f32 = lambda a: torch.from_numpy(_as_np(a).astype(np.float32)).to(device)
    out = {
        "wq4": pack_nibbles_k(wq.transpose(-1, -2).contiguous()),
        "w_scale": f32(qagg["w_scale"]),
        "dv": f32(qagg["dv"]).contiguous(),
        "x_scale": torch.tensor(float(_as_np(qagg["x_scale"])), dtype=torch.float32,
                                device=device),
    }
    out["sv"] = fold_sv(out).contiguous()
    return out


def aggregation_device_params(qagg: dict, device) -> dict:
    """A JAX-layout grouped bank (wq [4, 3, S_in, S_out], as numpy or arrays)
    -> the kernel's tensors on ``device``: wq K-minor [4, 3, S_out, S_in],
    w_scale, x_scale, and sv [4, S] folded once (:func:`fold_sv`)."""
    wq = torch.from_numpy(np.array(_as_np(qagg["wq"]))).to(device)
    out = {
        "wq": wq.transpose(-1, -2).contiguous(),
        "w_scale": torch.from_numpy(_as_np(qagg["w_scale"]).astype(np.float32)).to(device),
        "x_scale": torch.tensor(float(_as_np(qagg["x_scale"])), dtype=torch.float32,
                                device=device),
    }
    out["sv"] = fold_sv(out).contiguous()
    return out
