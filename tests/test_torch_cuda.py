"""The port's CUDA kernels against their plain PyTorch versions, on the card,
at small shapes (the serving shapes are chip_smoke.py's). Marked ``gpu``:
they skip where there is no CUDA device. Run on a GPU machine with
``pytest -m gpu tests/test_torch_cuda.py``."""

from __future__ import annotations

import pytest
import torch

from posetpu_torch.ops import aggregation as tagg
from posetpu_torch.ops import phase_tail as tpt

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _i8(gen, *shape, lo=-127, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8)


@pytest.mark.parametrize("n,h,cin,cout", [(3, 4, 64, 32), (8, 8, 256, 128)])
def test_subpixel_deconv_kernel_equals_plain(cuda, n, h, cin, cout):
    gen = torch.Generator().manual_seed(0)
    x = _i8(gen, n, h * h, cin, lo=0)
    args = {"w": _i8(gen, 4, 4, cout, cin),
            "sv": torch.rand(4, cout, generator=gen) * 2e-3 / cin ** 0.5,
            "bv": torch.rand(4, cout, generator=gen) * 40 - 20,
            "so": torch.tensor([[0.5]])}
    dev = {k: v.to(cuda) for k, v in args.items()}
    before = tpt.fused_subpixel_deconv_batched.launches
    got = tpt.fused_subpixel_deconv_batched(x.to(cuda), dev, h=h, w=h)
    assert tpt.fused_subpixel_deconv_batched.launches == before + 1
    ref = tpt.subpixel_deconv_plain(x.to(cuda), dev, h=h, w=h)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and len(torch.unique(ref)) > 50


@pytest.mark.parametrize("n,h,c,joints", [(2, 4, 32, 4), (3, 8, 64, 16)])
def test_phase_tail2_kernel_equals_plain(cuda, n, h, c, joints):
    gen = torch.Generator().manual_seed(1)
    x = _i8(gen, n, h * h, c, lo=0)
    sv = lambda: torch.rand(c, generator=gen) * 8e-3 / c ** 0.5 + 1e-4
    args = {"w1": _i8(gen, 4, 4, c, c), "w2": _i8(gen, 4, 4, c, c),
            "s1": torch.stack([sv(), torch.rand(c, generator=gen) * 4 - 2]),
            "s2": torch.stack([sv(), torch.rand(c, generator=gen) * 4 - 2]),
            "so1": torch.tensor([[0.3]]), "so2": torch.tensor([[0.3]]),
            "wh": _i8(gen, joints, c),
            "vh": torch.stack([torch.rand(joints, generator=gen) * 1e-3,
                               torch.rand(joints, generator=gen) - 0.5])}
    dev = {k: v.to(cuda) for k, v in args.items()}
    got = tpt.fused_phase_tail2(x.to(cuda), dev, h=h, w=h)
    ref = tpt.phase_tail2_plain(x.to(cuda), dev, h=h, w=h)
    torch.cuda.synchronize()
    assert got.shape == (joints, n, 16 * h * h)
    assert torch.equal(got, ref) and float(ref.std()) > 0


@pytest.mark.parametrize("j,n,s", [(4, 2, 256), (16, 3, 1024)])
def test_aggregation_kernel_equals_plain(cuda, j, n, s):
    gen = torch.Generator().manual_seed(2)
    bank = torch.rand(12, s, s, generator=gen) * 0.1
    from posetpu_torch.models.quant import quantize_aggregation_grouped

    qagg = tagg.aggregation_device_params(quantize_aggregation_grouped(bank), cuda)
    hm = torch.rand(j, n, 4, s, generator=gen).to(cuda)
    got = tagg.aggregation_grouped(qagg, hm)
    ref = tagg.aggregation_grouped_plain(qagg, hm)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_kernels_refuse_unsupported_shapes(cuda):
    x = torch.zeros(2, 16, 48, dtype=torch.int8, device=cuda)  # Cin % 32 != 0
    args = {"w": torch.zeros(4, 4, 32, 48, dtype=torch.int8, device=cuda),
            "sv": torch.ones(4, 32, device=cuda), "bv": torch.zeros(4, 32, device=cuda),
            "so": torch.ones(1, 1, device=cuda)}
    with pytest.raises(ValueError):
        tpt.fused_subpixel_deconv_batched(x, args, h=4, w=4)
    qagg = {"wq": torch.zeros(4, 3, 40, 40, dtype=torch.int8, device=cuda),
            "w_scale": torch.ones(4, 1, 40, device=cuda),
            "x_scale": torch.tensor(0.01, device=cuda)}
    with pytest.raises(ValueError):
        tagg.aggregation_grouped(qagg, torch.zeros(2, 2, 4, 40, device=cuda))
