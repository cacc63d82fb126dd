"""Exact int8 x int8 -> int32 matrix product for the plain versions and the
trunk: ``torch._int_mm``. On CUDA its cuBLASLt int8 GEMM refuses some shapes
(fewer than 17 rows, K or N not a multiple of 8, and on the H100 also e.g.
M=48, N=32, K=64), so there the operands are zero-padded to multiples of 32
in every dimension. Zero rows and columns add nothing to an integer sum, so
the result is exact."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ALIGN = 32


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32, exactly."""
    if not a.is_cuda:
        return torch._int_mm(a.contiguous(), b.contiguous())
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = -m % _ALIGN, -k % _ALIGN, -n % _ALIGN
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    y = torch._int_mm(a.contiguous(), b.contiguous())
    return y[:m, :n] if (pm or pn) else y
