"""The int8 trunk's requantize (models/quant.py): a hand-written CUDA kernel
(``csrc/requant.cu``, its arithmetic in ``csrc/requant.cuh``) with its plain
PyTorch version beside it.

A convolution's exact int32 sums acc [M, C] become the next int8 boundary
[M, C] in one of two forms, chosen by the call site:

- the conv epilogue, ``clamp(round(relu?(acc * sv + b) * inv), -hi, hi)``;
- a residual block's tail, ``clamp(round(relu((acc * sv + b) + r * r_scale)
  * inv), -hi, hi)`` with ``r`` the block's int8 residual [M, C].

``sv`` [C] (the input scale times the weight scales) and ``inv`` (one over
the output scale, 0-d) are f32 tensors the caller computes; ``hi`` is 127,
or 7 at a 4-bit boundary. Every multiply and add is rounded on its own, in
the order written, as the JAX package's ``_Int8Runner`` computes them.

On a CUDA tensor the wrapper launches the kernel once (counted in
``requant.launches``): it reads the sums once, in place (a column slice of a
padded ``torch._int_mm`` output included: the rows may be strided, the
channels must be contiguous) and writes the int8 values once. The kernel
moves 8 channels a thread in 16- and 8-byte accesses, so it takes C a
multiple of 8, sums 16-byte aligned with a row stride a multiple of 4, and a
residual 8-byte aligned; anything else is refused. On a CPU tensor it runs
the plain version, PyTorch's passes, which round the same.
"""

from __future__ import annotations

import torch

from posetpu_torch.ops import _build
from posetpu_torch.ops.phase_tail import stream_of

_P, _I = _build.P, _build.I
_SIGNATURES = {"requant": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]}
_kernel = None  # the bound C function, fetched at the first launch


def requant_plain(acc, sv, bias, inv, hi=127, relu=True, residual=None, r_scale=None):
    """The plain version: acc [M, C] int32 -> [M, C] int8."""
    y = acc.float() * sv + bias
    if residual is not None:
        y = y + residual.float() * r_scale
    if relu:
        y = torch.relu(y)
    return torch.clamp(torch.round(y * inv), -hi, hi).to(torch.int8)


def requant(acc, sv, bias, inv, hi=127, relu=True, residual=None, r_scale=None):
    """acc [M, C] int32 -> [M, C] int8 (see the module docstring); with
    ``residual`` the block tail, whose ReLU is always on."""
    global _kernel
    if residual is not None and not relu:
        raise ValueError("requant: a block's tail always applies its ReLU")
    if not acc.is_cuda:
        return requant_plain(acc, sv, bias, inv, hi, relu, residual, r_scale)
    if acc.dim() != 2 or acc.dtype is not torch.int32 or acc.stride(1) != 1:
        raise ValueError(f"requant: acc must be [M, C] int32 with contiguous channels, got "
                         f"{acc.dtype} {tuple(acc.shape)} strides {acc.stride()}")
    m, c = acc.shape
    ld = acc.stride(0) if m > 1 else c
    if c % 8 or ld % 4 or acc.data_ptr() % 16:
        raise ValueError(f"requant: the kernel takes C a multiple of 8 and sums 16-byte "
                         f"aligned with a row stride a multiple of 4; got C {c}, row stride "
                         f"{ld}, address {acc.data_ptr()} (mod 16: {acc.data_ptr() % 16})")
    f32 = torch.float32
    if not (sv.is_cuda and bias.is_cuda and inv.is_cuda and sv.dtype is bias.dtype is inv.dtype
            is f32 and sv.shape == bias.shape == (c,) and inv.numel() == 1
            and sv.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"requant: sv and bias must be contiguous [{c}] f32 and inv one f32, "
                         f"all on the card; got {[(t.dtype, tuple(t.shape), t.device.type)
                                                  for t in (sv, bias, inv)]}")
    r_ptr = rs_ptr = None
    if residual is not None:
        if not (residual.is_cuda and r_scale.is_cuda and residual.dtype is torch.int8
                and residual.numel() == m * c and r_scale.dtype is f32 and r_scale.numel() == 1):
            raise ValueError(f"requant: the residual must be {m * c} int8 values and its "
                             f"scale one f32, both on the card; got {residual.dtype} "
                             f"{tuple(residual.shape)}, {r_scale.dtype} {tuple(r_scale.shape)}")
        residual = residual.contiguous()  # held until the launch is queued
        r_ptr, rs_ptr = residual.data_ptr(), r_scale.data_ptr()
        if r_ptr % 8:
            raise ValueError(f"requant: the residual must be 8-byte aligned, got address "
                             f"{r_ptr} (mod 8: {r_ptr % 8})")
    out = torch.empty((m, c), dtype=torch.int8, device=acc.device)
    if m and c:
        if _kernel is None:
            _kernel = _build.load("requant", _SIGNATURES).requant
        rc = _kernel(acc.data_ptr(), ld, r_ptr, out.data_ptr(),
                     sv.data_ptr(), bias.data_ptr(), inv.data_ptr(), rs_ptr, m, c, int(relu),
                     int(hi), stream_of(acc))
        if rc:
            _build.check(rc, "requant")
        requant.launches += 1
    return out


requant.launches = 0
