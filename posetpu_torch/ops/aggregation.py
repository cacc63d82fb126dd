"""Grouped int8 cross-view aggregation (B3): a hand-written CUDA kernel
(``csrc/aggregation.cu``) with its plain PyTorch version beside it.

Ports posetpu/ops/pallas/aggregation.py's ``aggregation_grouped_pallas``
(and, as the plain version, posetpu/models/quant.py's
``aggregation_int8_apply_jns_grouped``): hm [J, N, V, S] f32 -> fused
[J, N, V, S] f32, where for each target view t

    fused[t] = (sum_p xq[src(t, p)] @ wq[t, p]) * ((x_scale / 3) * w_scale[t])

over its 3 source views, int8 products with an exact int32 sum and one f32
multiply. The f32 -> int8 quantize of ``hm`` is plain PyTorch on both
routes (it is XLA-side in the JAX package too).

On a CUDA tensor the wrapper launches the kernel (counted in
``aggregation_grouped.launches``) and raises on a shape it does not take:
there is no fallback. On a CPU tensor it runs the plain version.

``qagg`` holds the bank K-minor, wq [4, 3, S_out, S_in] int8 (see
:func:`aggregation_device_params`), w_scale [4, 1, S] f32 and the 0-d f32
x_scale.
"""

from __future__ import annotations

import numpy as np
import torch

from posetpu_torch.ops import _build
from posetpu_torch.ops.int_mm import int_mm

_SIGNATURES = {"aggregation_grouped": [_build.P] * 4 + [_build.I] * 2 + [_build.P]}

# source views of target t, in order: {0..3} \ {t}
_SRC = [[s for s in range(4) if s != t] for t in range(4)]


def _quantize(qagg, hm):
    """hm [J, N, V, S] f32 -> (xq [V, J*N, S] int8, sv [4, S] f32)."""
    j, n, v, s = hm.shape
    xq8 = torch.clamp(torch.round(hm * (1.0 / qagg["x_scale"])), -127, 127
                      ).to(torch.int8)
    xq = xq8.permute(2, 0, 1, 3).reshape(v, j * n, s)
    sv = ((qagg["x_scale"] / 3.0) * qagg["w_scale"]).reshape(4, s)
    return xq, sv


def _unpack(y, hm):
    """[4, J*N, S] -> [J, N, V, S] in hm's dtype."""
    j, n, v, s = hm.shape
    return y.reshape(v, j, n, s).permute(1, 2, 0, 3).to(hm.dtype)


def aggregation_grouped_plain(qagg, hm):
    """Plain version: the same int8 products and int32 pair sums through
    ``ops/int_mm.py``, then the same single f32 multiply."""
    j, n, v, s = hm.shape
    xq, sv = _quantize(qagg, hm)
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
    aggregation; see the module docstring)."""
    j, n, v, s = hm.shape
    if v != 4:
        raise ValueError(f"the aggregation bank is built for 4 views, got {v}")
    if not hm.is_cuda:
        return aggregation_grouped_plain(qagg, hm)
    wq = qagg["wq"]
    if s % 32 or wq.shape != (4, 3, s, s) or wq.dtype != torch.int8 \
            or not wq.is_cuda or not wq.is_contiguous():
        raise ValueError(f"aggregation_grouped: unsupported shapes hm "
                         f"{tuple(hm.shape)}, wq {tuple(wq.shape)} {wq.dtype} "
                         f"(S % 32 == 0, contiguous int8 CUDA bank)")
    xq, sv = _quantize(qagg, hm)
    xq, sv = xq.contiguous(), sv.contiguous()
    out = torch.empty((4, j * n, s), dtype=torch.float32, device=hm.device)
    lib = _build.load("aggregation", _SIGNATURES)
    _build.check(lib.aggregation_grouped(
        xq.data_ptr(), wq.data_ptr(), sv.data_ptr(), out.data_ptr(), j * n, s,
        torch.cuda.current_stream(hm.device).cuda_stream), "aggregation_grouped")
    aggregation_grouped.launches += 1
    return _unpack(out, hm)


aggregation_grouped.launches = 0


def aggregation_device_params(qagg: dict, device) -> dict:
    """A JAX-layout grouped bank (wq [4, 3, S_in, S_out], as numpy or arrays)
    -> the kernel's tensors on ``device``: wq K-minor [4, 3, S_out, S_in]."""
    as_np = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a))
    wq = torch.from_numpy(np.array(as_np(qagg["wq"]))).to(device)
    return {
        "wq": wq.transpose(-1, -2).contiguous(),
        "w_scale": torch.from_numpy(as_np(qagg["w_scale"]).astype(np.float32)).to(device),
        "x_scale": torch.tensor(float(as_np(qagg["x_scale"])), dtype=torch.float32,
                                device=device),
    }
