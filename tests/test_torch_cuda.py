"""The port's CUDA kernels against their plain PyTorch versions, on the card,
at small shapes (the serving shapes are chip_smoke.py's). Marked ``gpu``:
they skip where there is no CUDA device. Run on a GPU machine with
``pytest -m gpu tests/test_torch_cuda.py``."""

from __future__ import annotations

import pytest
import torch

from posetpu_torch.ops import aggregation as tagg
from posetpu_torch.ops import deconv as tdc
from posetpu_torch.ops import decode as tdec
from posetpu_torch.ops import heatmap as thm
from posetpu_torch.ops import phase_tail as tpt
from posetpu_torch.ops import requant as trq
from posetpu_torch.ops import resblock as trb

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
    dev = tpt.with_subpixel_weights({k: v.to(cuda) for k, v in args.items()})
    before = tpt.fused_subpixel_deconv_batched.launches
    got = tpt.fused_subpixel_deconv_batched(x.to(cuda), dev, h=h, w=h)
    assert tpt.fused_subpixel_deconv_batched.launches == before + 1
    ref = tpt.subpixel_deconv_plain(x.to(cuda), dev, h=h, w=h)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and len(torch.unique(ref)) > 50


def _subpixel_args(gen, cin, cout, dev):
    """Random B2 arguments in the kernels' layout, scaled so the requant
    spans the int8 range."""
    args = {"w": _i8(gen, 4, 4, cout, cin),
            "sv": torch.rand(4, cout, generator=gen) * 1.2e-3 / cin ** 0.5 + 1e-6,
            "bv": torch.rand(4, cout, generator=gen) * 40 - 20,
            "so": torch.tensor([[0.5]])}
    return tpt.with_subpixel_weights({k: v.to(dev) for k, v in args.items()})


@pytest.mark.parametrize("n,h,w,cin,cout", [(128, 8, 8, 2048, 256), (256, 8, 8, 2048, 256),
                                            (5, 3, 7, 96, 136), (3, 9, 12, 64, 24)])
def test_subpixel_deconv_batched_serving_and_ragged_shapes(cuda, n, h, w, cin, cout):
    """B2 (tail2_kernel's phase-major instance on the streamed halo) at paths
    1 and 2's deconv0 (128 and 256 images of 8x8x2048) and at ragged shapes:
    an image past N, tiles past the grid, a partial n-half; equal to the
    plain version."""
    gen = torch.Generator().manual_seed(21)
    x = _i8(gen, n, h * w, cin, lo=0).to(cuda)
    dev = _subpixel_args(gen, cin, cout, cuda)
    before = tpt.fused_subpixel_deconv_batched.launches
    got = tpt.fused_subpixel_deconv_batched(x, dev, h=h, w=w)
    assert tpt.fused_subpixel_deconv_batched.launches == before + 1
    ref = tpt.subpixel_deconv_plain(x, dev, h=h, w=w)
    torch.cuda.synchronize()
    assert got.shape == (4, n, h, w, cout)
    assert torch.equal(got, ref) and len(torch.unique(ref)) > 50


@pytest.mark.parametrize("sets,stages", [(1, 3), (2, 5), (4, 2), (8, 4)])
def test_subpixel_deconv_batched_every_ring_and_sets(cuda, sets, stages):
    """B2's instance at other (phase, n-half) runs and ring depths than the
    wrapper's: equal to the plain version."""
    gen = torch.Generator().manual_seed(22)
    n, h, w, cin, cout = 7, 8, 8, 256, 256
    x = _i8(gen, n, h * w, cin, lo=0).to(cuda)
    dev = _subpixel_args(gen, cin, cout, cuda)
    got = tpt.launch_tail2(x.reshape(n, h, w, cin), dev["wt"], dev["svb"], dev["so"],
                           epilogue="relu_phase", design=tpt.STREAM_DESIGN, sets=sets, stages=stages)
    ref = tpt.subpixel_deconv_plain(x, dev, h=h, w=w)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _tail2_args(gen, cin, c1, c2, joints, dev):
    """Random B1 arguments in the kernels' layout (stage images included)."""
    sv = lambda c, k: torch.rand(c, generator=gen) * 8e-3 / k ** 0.5 + 1e-4
    args = {"w1": _i8(gen, 4, 4, c1, cin), "w2": _i8(gen, 4, 4, c2, c1),
            "s1": torch.stack([sv(c1, cin), torch.rand(c1, generator=gen) * 4 - 2]),
            "s2": torch.stack([sv(c2, c1), torch.rand(c2, generator=gen) * 4 - 2]),
            "so1": torch.tensor([[0.3]]), "so2": torch.tensor([[0.3]]),
            "wh": _i8(gen, joints, c2),
            "vh": torch.stack([torch.rand(joints, generator=gen) * 1e-3,
                               torch.rand(joints, generator=gen) - 0.5])}
    return tpt.with_tail2_weights({k: v.to(dev) for k, v in args.items()})


@pytest.mark.parametrize("n,h,w,cin,c1,c2,joints", [
    (2, 4, 4, 32, 32, 32, 4), (3, 8, 8, 64, 64, 64, 16),   # small widths
    (3, 16, 16, 256, 256, 256, 16),                        # serving width, 3 images
    (5, 6, 10, 32, 64, 136, 17),                           # ragged: overhanging tiles, a
    (1, 2, 26, 96, 32, 40, 9)])                            # partial n-half, 17 joints
def test_phase_tail2_kernel_equals_plain(cuda, n, h, w, cin, c1, c2, joints):
    gen = torch.Generator().manual_seed(1)
    x = _i8(gen, n, h * w, cin, lo=0).to(cuda)
    dev = _tail2_args(gen, cin, c1, c2, joints, cuda)
    before = tpt.fused_phase_tail2.launches
    got = tpt.fused_phase_tail2(x, dev, h=h, w=w)
    assert tpt.fused_phase_tail2.launches == before + 1
    ref = tpt.phase_tail2_plain(x, dev, h=h, w=w)
    torch.cuda.synchronize()
    assert got.shape == (joints, n, 16 * h * w)
    assert torch.equal(got, ref) and float(ref.std()) > 0


@pytest.mark.parametrize("stages", [2, 3, 4])
def test_phase_tail2_kernel_every_ring(cuda, stages):
    """Each ring depth, on a grid the 16 x 8 tiles overhang:
    deconv1's z1 and the head's heatmaps equal their plain versions."""
    gen = torch.Generator().manual_seed(7)
    n, h, w, cin, c1, c2, joints = 2, 6, 10, 64, 64, 160, 16
    x4 = _i8(gen, n, h, w, cin, lo=0).to(cuda)
    dev = _tail2_args(gen, cin, c1, c2, joints, cuda)
    z1 = tpt.launch_tail2(x4, dev["w1t"], dev["s1"], dev["so1"], stages=stages)
    z1_ref = tpt._phase_conv_plain(x4, dev["w1"], dev["s1"][0], dev["s1"][1], dev["so1"],
                                   interleave=True)
    out = tpt.launch_tail2(z1_ref, dev["w2t"], dev["s2"], dev["so2"], dev["wht"], dev["vh"],
                           stages=stages)
    z2 = tpt._phase_conv_plain(z1_ref, dev["w2"], dev["s2"][0], dev["s2"][1], dev["so2"],
                               interleave=False)
    ref = tpt._phase_head_plain(z2, dev["wh"], dev["vh"])
    torch.cuda.synchronize()
    assert torch.equal(z1, z1_ref) and torch.equal(out, ref)


@pytest.mark.parametrize("j,n,s", [(4, 2, 256), (16, 3, 1024)])
def test_aggregation_kernel_equals_plain(cuda, j, n, s):
    gen = torch.Generator().manual_seed(2)
    bank = torch.rand(12, s, s, generator=gen) * 0.1
    from posetpu_torch.models.quant import quantize_aggregation_grouped

    qagg = tagg.aggregation_device_params(quantize_aggregation_grouped(bank), cuda)
    hm = torch.rand(j, n, 4, s, generator=gen).to(cuda)
    before = (tagg.aggregation_grouped.launches, tagg.quantize_heatmaps.launches)
    got = tagg.aggregation_grouped(qagg, hm)
    assert (tagg.aggregation_grouped.launches, tagg.quantize_heatmaps.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = tagg.aggregation_grouped_plain(qagg, hm)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _int8_bank(gen, s, dev):
    """A random int8 bank in the kernel's layout, made on the card (an f32
    bank at S = 4096 would be 805 MB to quantise on the host)."""
    g = torch.Generator(device=dev).manual_seed(int(torch.randint(1 << 30, (1,), generator=gen)))
    q = {"wq": torch.randint(-127, 128, (4, 3, s, s), generator=g, device=dev, dtype=torch.int8),
         "w_scale": torch.rand(4, 1, s, generator=g, device=dev) * 1e-3 + 1e-4,
         "x_scale": torch.tensor(1.2 / 127, device=dev)}
    q["sv"] = tagg.fold_sv(q).contiguous()
    return q


@pytest.mark.parametrize("j,n,s", [(16, 32, 4096), (5, 7, 4096), (3, 5, 256), (2, 9, 96),
                                   (1, 3, 160)])
def test_aggregation_kernel_serving_and_ragged_shapes(cuda, j, n, s):
    """S = 4096 at the serving J*N (512) and at J*N = 35; S = 256; S not a
    multiple of the 128-byte k-step (the tensor maps read zeros past S)."""
    gen = torch.Generator().manual_seed(3)
    qagg = _int8_bank(gen, s, cuda)
    hm = (torch.randn(j, n, 4, s, generator=gen) * 0.5).to(cuda)
    got = tagg.aggregation_grouped(qagg, hm)
    ref = tagg.aggregation_grouped_plain(qagg, hm)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and float(ref.std()) > 0


@pytest.mark.parametrize("shape", [(16, 32, 4, 4096), (5, 7, 4, 96), (1, 1, 4, 16)])
def test_quantize_kernel_equals_plain(cuda, shape):
    gen = torch.Generator().manual_seed(4)
    qagg = {"x_scale": torch.tensor(1.2 / 127, device=cuda)}
    hm = torch.randn(*shape, generator=gen).to(cuda)
    hm.view(-1)[:64] = (torch.arange(64, device=cuda) - 32 + 0.5) * qagg["x_scale"]  # ties
    before = tagg.quantize_heatmaps.launches
    got = tagg.quantize_heatmaps(qagg, hm)
    assert tagg.quantize_heatmaps.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, tagg._quantize(qagg, hm))
    # a permuted view is copied first, then quantised the same
    view = hm.permute(1, 0, 2, 3).contiguous().permute(1, 0, 2, 3)
    assert torch.equal(tagg.quantize_heatmaps(qagg, view), tagg._quantize(qagg, hm))


@pytest.mark.parametrize("j,n,s", [(4, 2, 256), (16, 3, 1024), (5, 7, 96)])
def test_aggregation_s4_kernel_equals_plain(cuda, j, n, s):
    """B4 at small shapes and at an odd-but-legal one (J*N = 35 rows, S = 96:
    ragged tiles in both directions)."""
    gen = torch.Generator().manual_seed(3)
    bank = torch.rand(12, s, s, generator=gen) * 0.1
    from posetpu_torch.models.quant import quantize_aggregation_grouped_s4

    qagg = tagg.aggregation_device_params_s4(quantize_aggregation_grouped_s4(bank), cuda)
    assert qagg["wq4"].dtype == torch.uint8 and qagg["wq4"].shape == (4, 3, s, s // 2)
    hm = (torch.rand(j, n, 4, s, generator=gen) * 2 - 0.5).to(cuda)
    before = tagg.aggregation_grouped_s4.launches
    got = tagg.aggregation_grouped_s4(qagg, hm)
    assert tagg.aggregation_grouped_s4.launches == before + 1
    ref = tagg.aggregation_grouped_s4_plain(qagg, hm)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and float(ref.std()) > 0


def _s4_bank(gen, s, dev):
    """A random s4 bank in the kernel's layout, made on the card: residuals
    in [-7, 7] nibble-packed, w_scale, dv, x_scale and sv folded once."""
    g = torch.Generator(device=dev).manual_seed(int(torch.randint(1 << 30, (1,), generator=gen)))
    w = torch.randint(-7, 8, (4, 3, s, s), generator=g, device=dev, dtype=torch.int8)
    q = {"wq4": tagg.pack_nibbles_k(w),
         "w_scale": torch.rand(4, 1, s, generator=g, device=dev) * 1e-2 + 1e-3,
         "dv": torch.rand(4, 3, s, generator=g, device=dev) * 0.05,
         "x_scale": torch.tensor(1.2 / 127, device=dev)}
    q["sv"] = tagg.fold_sv(q).contiguous()
    return q


@pytest.mark.parametrize("j,n,s", [(16, 32, 4096), (5, 7, 96), (3, 3, 160)])
def test_aggregation_s4_serving_and_ragged_shapes(cuda, j, n, s):
    """B4 at the serving J*N = 512, S = 4096, and at J*N = 35 with S = 96
    and J*N = 9 with S = 160 (ragged tiles both ways; S no multiple of the
    128-deep k-step): equal to the plain version, and one launch of the
    quantize kernel with each."""
    gen = torch.Generator().manual_seed(23)
    qagg = _s4_bank(gen, s, cuda)
    hm = (torch.randn(j, n, 4, s, generator=gen) * 0.5).to(cuda)
    before = (tagg.aggregation_grouped_s4.launches, tagg.quantize_heatmaps.launches)
    got = tagg.aggregation_grouped_s4(qagg, hm)
    assert (tagg.aggregation_grouped_s4.launches, tagg.quantize_heatmaps.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = tagg.aggregation_grouped_s4_plain(qagg, hm)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and float(ref.std()) > 0


@pytest.mark.parametrize("stages", [2, 3, 4])
def test_aggregation_s4_every_ring(cuda, stages):
    """B4's kernel at each ring depth that fits a block, launched through the
    library on the quantised planes: equal to the plain version."""
    from posetpu_torch.ops import _build

    gen = torch.Generator().manual_seed(24)
    qagg = _s4_bank(gen, 512, cuda)
    hm = (torch.randn(7, 41, 4, 512, generator=gen) * 0.5).to(cuda)
    xq = tagg.quantize_heatmaps(qagg, hm)
    out = torch.empty((4, 7 * 41, 512), dtype=torch.float32, device=cuda)
    _build.check(_build.load("aggregation", tagg._SIGNATURES).aggregation_grouped_s4(
        xq.data_ptr(), qagg["wq4"].data_ptr(), qagg["sv"].data_ptr(), qagg["dv"].data_ptr(),
        out.data_ptr(), 7 * 41, 512, stages, tpt.stream_of(hm)), "aggregation_grouped_s4")
    got = tagg._unpack(out, hm)
    ref = tagg.aggregation_grouped_s4_plain(qagg, hm)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _tail_args(gen, c, joints, dev):
    """Random B5 arguments in the kernels' layout (stage images included)."""
    args = {"w": _i8(gen, 4, 4, c, c),
            "sv": torch.stack([torch.rand(c, generator=gen) * 8e-3 / c ** 0.5 + 1e-4,
                               torch.rand(c, generator=gen) * 4 - 2]),
            "so": torch.tensor([[0.3]]), "wh": _i8(gen, joints, c),
            "vh": torch.stack([torch.rand(joints, generator=gen) * 1e-3,
                               torch.rand(joints, generator=gen) - 0.5])}
    return tpt.with_tail_weights({k: v.to(dev) for k, v in args.items()})


@pytest.mark.parametrize("n,h,w,c,joints", [(2, 4, 4, 32, 4), (3, 8, 8, 64, 16),
                                            (5, 3, 5, 96, 7)])
def test_phase_tail_kernel_equals_plain(cuda, n, h, w, c, joints):
    """B5, also at an odd image size and joint count (levels=1 has no parity
    constraint)."""
    gen = torch.Generator().manual_seed(4)
    x = _i8(gen, n, h * w, c, lo=0)
    dev = _tail_args(gen, c, joints, cuda)
    before = tpt.fused_phase_tail.launches
    got = tpt.fused_phase_tail(x.to(cuda), dev, h=h, w=w)
    assert tpt.fused_phase_tail.launches == before + 1
    ref = tpt.phase_tail_plain(x.to(cuda), dev, h=h, w=w)
    torch.cuda.synchronize()
    assert got.shape == (joints, n, 4 * h * w)
    assert torch.equal(got, ref) and float(ref.std()) > 0


@pytest.mark.parametrize("n", [32, 128])
def test_phase_tail_kernel_serving_shapes(cuda, n):
    """B5 (tail2_kernel's levels=1 head instance) at path 3's 32 images of
    32x32x256 with 16 joints, and at 128: one launch, equal to the plain
    version."""
    gen = torch.Generator().manual_seed(8)
    x = _i8(gen, n, 32 * 32, 256, lo=0).to(cuda)
    dev = _tail_args(gen, 256, 16, cuda)
    before = tpt.fused_phase_tail.launches
    got = tpt.fused_phase_tail(x, dev, h=32, w=32)
    assert tpt.fused_phase_tail.launches == before + 1
    ref = tpt.phase_tail_plain(x, dev, h=32, w=32)
    torch.cuda.synchronize()
    assert got.shape == (16, n, 4 * 32 * 32)
    assert torch.equal(got, ref) and float(ref.std()) > 0


@pytest.mark.parametrize("stages", [2, 3, 4])
def test_phase_tail_kernel_every_ring(cuda, stages):
    """B5's instance at each ring depth, on a grid the 16 x 8 tiles overhang,
    with a partial second n-half and 17 joints: equal to the plain version."""
    gen = torch.Generator().manual_seed(9)
    n, h, w, c, joints = 3, 6, 10, 160, 17
    x = _i8(gen, n, h * w, c, lo=0).to(cuda)
    dev = _tail_args(gen, c, joints, cuda)
    got = tpt.launch_tail2(x.reshape(n, h, w, c), dev["wt"], dev["sv"], dev["so"], dev["wht"],
                           dev["vh"], store="head_packed1", stages=stages)
    ref = tpt.phase_tail_plain(x, dev, h=h, w=w)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("n,h,w,cin,cout", [(3, 4, 4, 64, 32), (8, 8, 8, 256, 128),
                                            (5, 3, 7, 96, 24)])
def test_subpixel_deconv_pairs_kernel_equals_plain(cuda, n, h, w, cin, cout):
    """B6: the N-minor output [4, H, W, N, Cout]."""
    gen = torch.Generator().manual_seed(5)
    x = _i8(gen, n, h * w, cin, lo=0)
    args = {"w": _i8(gen, 4, 4, cout, cin),
            "sv": torch.rand(4, cout, generator=gen) * 2e-3 / cin ** 0.5,
            "bv": torch.rand(4, cout, generator=gen) * 40 - 20,
            "so": torch.tensor([[0.5]])}
    dev = tpt.with_subpixel_weights({k: v.to(cuda) for k, v in args.items()})
    before = tpt.fused_subpixel_deconv.launches
    got = tpt.fused_subpixel_deconv(x.to(cuda), dev, h=h, w=w)
    assert tpt.fused_subpixel_deconv.launches == before + 1
    ref = tpt.subpixel_deconv_pairs_plain(x.to(cuda), dev, h=h, w=w)
    torch.cuda.synchronize()
    assert got.shape == (4, h, w, n, cout)
    assert torch.equal(got, ref) and len(torch.unique(ref)) > 50
    assert torch.equal(tpt.subpixel_interleave_packed(got),
                       tpt.subpixel_interleave_packed_nmajor(
                           tpt.subpixel_deconv_plain(x.to(cuda), dev, h=h, w=w)))


@pytest.mark.parametrize("n", [32, 128])
def test_subpixel_deconv_pairs_serving_shapes(cuda, n):
    """B6 (tail2_kernel's N-minor instance on the streamed halo) at path 3's
    deconv0, 32 images of 8x8x2048 -> 256, and at 128: one launch, equal to
    the plain version and interleaving to B2's image."""
    gen = torch.Generator().manual_seed(23)
    x = _i8(gen, n, 64, 2048, lo=0).to(cuda)
    dev = _subpixel_args(gen, 2048, 256, cuda)
    before = tpt.fused_subpixel_deconv.launches
    got = tpt.fused_subpixel_deconv(x, dev, h=8, w=8)
    assert tpt.fused_subpixel_deconv.launches == before + 1
    ref = tpt.subpixel_deconv_pairs_plain(x, dev, h=8, w=8)
    torch.cuda.synchronize()
    assert got.shape == (4, 8, 8, n, 256)
    assert torch.equal(got, ref) and len(torch.unique(ref)) > 50
    assert torch.equal(tpt.subpixel_interleave_packed(got),
                       tpt.subpixel_interleave_packed_nmajor(
                           tpt.fused_subpixel_deconv_batched(x, dev, h=8, w=8)))


@pytest.mark.parametrize("sets,stages", [(1, 2), (1, 7), (2, 3), (2, 5), (4, 2), (4, 7),
                                         (8, 4), (8, 7)])
def test_subpixel_deconv_pairs_every_ring_and_sets(cuda, sets, stages):
    """B6's instance at every (phase, n-half) run a block and ring depths
    from 2 to the wrapper's 7, on an image past N: equal to the plain
    version."""
    gen = torch.Generator().manual_seed(24)
    n, h, w, cin, cout = 7, 8, 8, 256, 256
    x = _i8(gen, n, h * w, cin, lo=0).to(cuda)
    dev = _subpixel_args(gen, cin, cout, cuda)
    got = tpt.launch_tail2(x.reshape(n, h, w, cin), dev["wt"], dev["svb"], dev["so"],
                           epilogue="relu_phase", store="n_minor", design=tpt.STREAM_DESIGN,
                           sets=sets, stages=stages)
    ref = tpt.subpixel_deconv_pairs_plain(x, dev, h=h, w=w)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape,post", [((3, 8, 16, 16), True), ((2, 4, 16, 64, 64), True),
                                        ((37, 5, 7), True), ((6, 9, 10), False),
                                        ((64, 64), True)])
def test_decode_kernel_equals_plain(cuda, shape, post):
    """B7 with ties, non-positive maps and border peaks; a map size that is
    no multiple of 4 takes the scalar loads."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(shape, generator=gen)
    flat = x.reshape(-1, shape[-2], shape[-1])
    flat[0] = 0.0
    flat[0, 2, 3] = flat[0, 2, 1] = flat[0, 1, 4] = 2.0   # ties: first row-major wins
    if flat.shape[0] > 3:
        flat[1] = -flat[1].abs() - 0.1                    # all negative
        flat[2] = 0.0                                     # max == 0
        flat[3, -1, -1] = 50.0                            # border peak
    x = torch.round(x * 4) / 4                            # many equal values
    before = tdec.decode_heatmaps_kernel.launches
    got_c, got_m = tdec.decode_heatmaps_kernel(x.to(cuda), post_process=post)
    assert tdec.decode_heatmaps_kernel.launches == before + 1
    ref_c, ref_m = thm.decode_heatmaps(x.to(cuda), post_process=post)
    cpu_c, cpu_m = thm.decode_heatmaps(x, post_process=post)
    torch.cuda.synchronize()
    assert got_c.shape == shape[:-2] + (2,) and got_m.shape == shape[:-2]
    assert torch.equal(got_c, ref_c) and torch.equal(got_m, ref_m)
    assert torch.equal(got_c.cpu(), cpu_c) and torch.equal(got_m.cpu(), cpu_m)


@pytest.mark.parametrize("case", ["7 maps", "H*W % 4 != 0", "unaligned view", "ties",
                                  "all negative", "all NaN", "one map", "large map"])
def test_decode_kernel_edge_cases(cuda, case):
    """B7: a map count that is no multiple of the maps per block, a map size
    that is no multiple of 4 (scalar loads), a view whose base is not 16-byte
    aligned (scalar loads), exact ties (the first row-major index wins), maps
    of negatives (coords zeroed) and of NaNs, one map, and a map that takes
    more than one round of loads."""
    gen = torch.Generator().manual_seed(16)
    if case == "7 maps":
        x = torch.randn(7, 64, 64, generator=gen).to(cuda)
    elif case == "H*W % 4 != 0":
        x = torch.randn(5, 7, 9, generator=gen).to(cuda)
    elif case == "unaligned view":
        x = torch.randn(4 * 64 * 64 + 1, generator=gen).to(cuda)[1:].reshape(4, 64, 64)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    elif case == "ties":
        x = torch.zeros(6, 8, 8)
        x[:, 3, 5] = x[:, 3, 2] = x[:, 6, 1] = 1.0
        x[1] = 2.0                                   # every element ties: index 0
        x = x.to(cuda)
    elif case == "all negative":
        x = (-torch.rand(3, 16, 16, generator=gen) - 0.1).to(cuda)
    elif case == "all NaN":
        x = torch.full((2, 8, 8), float("nan"), device=cuda)
    elif case == "one map":
        x = torch.randn(64, 64, generator=gen).to(cuda)
    else:
        x = torch.randn(3, 160, 192, generator=gen).to(cuda)
    got_c, got_m = tdec.decode_heatmaps_kernel(x)
    ref_c, ref_m = thm.decode_heatmaps(x)
    torch.cuda.synchronize()
    assert got_c.shape == ref_c.shape and got_m.shape == ref_m.shape
    if case == "all NaN":  # no element compares: the kernel's own convention
        assert bool(torch.isfinite(got_c).all())
        return
    assert torch.equal(got_c, ref_c) and torch.equal(got_m, ref_m)
    if case == "ties":
        assert got_c[0].tolist() == [2.0, 3.0] and got_c[1].tolist() == [0.0, 0.0]
    if case == "all negative":
        assert float(got_c.abs().max()) == 0.0 and bool((got_m < 0).all())


def test_decode_kernel_results_are_views_of_one_allocation(cuda):
    """coords and maxvals share the kernel's one output and outlive each other."""
    x = torch.randn(2, 4, 16, 16, generator=torch.Generator().manual_seed(17)).to(cuda)
    coords, maxvals = tdec.decode_heatmaps_kernel(x)
    ref_c, ref_m = thm.decode_heatmaps(x)
    assert coords.untyped_storage().data_ptr() == maxvals.untyped_storage().data_ptr()
    del maxvals
    assert torch.equal(coords, ref_c)
    coords, maxvals = tdec.decode_heatmaps_kernel(x)
    del coords
    assert torch.equal(maxvals, ref_m)


def test_decode_kernel_takes_views(cuda):
    """A non-contiguous or offset view is made contiguous first."""
    x = torch.randn(4, 6, 9, 9, generator=torch.Generator().manual_seed(7)).to(cuda)
    view = x.permute(1, 0, 2, 3)[1:]
    got_c, got_m = tdec.decode_heatmaps_kernel(view)
    ref_c, ref_m = thm.decode_heatmaps(view)
    assert torch.equal(got_c, ref_c) and torch.equal(got_m, ref_m)


def test_s4_tail_pairs_decode_refuse_unsupported_shapes(cuda):
    z = lambda *s, dt=torch.int8: torch.zeros(*s, dtype=dt, device=cuda)
    # B4: S % 32 != 0; an int8 (unpacked) bank; a 3-view input
    q = {"wq4": z(4, 3, 40, 20, dt=torch.uint8), "w_scale": torch.ones(4, 1, 40, device=cuda),
         "dv": torch.ones(4, 3, 40, device=cuda), "x_scale": torch.tensor(0.01, device=cuda)}
    with pytest.raises(ValueError):
        tagg.aggregation_grouped_s4(q, torch.zeros(2, 2, 4, 40, device=cuda))
    q = {"wq4": z(4, 3, 64, 64), "w_scale": torch.ones(4, 1, 64, device=cuda),
         "dv": torch.ones(4, 3, 64, device=cuda), "x_scale": torch.tensor(0.01, device=cuda)}
    with pytest.raises(ValueError):
        tagg.aggregation_grouped_s4(q, torch.zeros(2, 2, 4, 64, device=cuda))
    with pytest.raises(ValueError):
        tagg.aggregation_grouped_s4(q, torch.zeros(2, 2, 3, 64, device=cuda))
    # B5: Cin % 32 != 0; pixel count that is not h*w; args without the
    # stage images
    args = {"w": z(4, 4, 48, 48), "sv": torch.ones(2, 48, device=cuda),
            "so": torch.ones(1, 1, device=cuda), "wh": z(4, 48),
            "vh": torch.ones(2, 4, device=cuda)}
    for a in (tpt.with_tail_weights(args), args):
        with pytest.raises(ValueError, match="fused_phase_tail"):
            tpt.fused_phase_tail(z(2, 16, 48), a, h=4, w=4)
    with pytest.raises(ValueError):
        tpt.fused_phase_tail(z(2, 15, 48), args, h=4, w=4)
    # B6: Cout % 8 != 0; args without the stage images
    args = {"w": z(4, 4, 12, 32), "sv": torch.ones(4, 12, device=cuda),
            "bv": torch.zeros(4, 12, device=cuda), "so": torch.ones(1, 1, device=cuda)}
    for a in (tpt.with_subpixel_weights(args), args):
        with pytest.raises(ValueError, match="fused_subpixel_deconv"):
            tpt.fused_subpixel_deconv(z(2, 16, 32), a, h=4, w=4)
    # B7: no map axes; an empty map
    with pytest.raises(ValueError):
        tdec.decode_heatmaps_kernel(torch.zeros(5, device=cuda))
    with pytest.raises(ValueError):
        tdec.decode_heatmaps_kernel(torch.zeros(5, 0, 4, device=cuda))


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


# the requantize sites of a serving request (ResNet-50 at 256x256, 128
# images), one case each distinct (rows, channels, form, hi): "relu" a conv
# epilogue with ReLU, "linear" a downsample's, "tail" a block's tail with
# its residual (7: a 4-bit boundary at layer1 and layer2)
REQUANT_SERVING = [(2097152, 64, "relu", 127), (524288, 64, "relu", 127),
                   (524288, 256, "linear", 127), (524288, 256, "tail", 7),
                   (524288, 128, "relu", 127), (131072, 128, "relu", 127),
                   (131072, 512, "linear", 127), (131072, 512, "tail", 7),
                   (131072, 256, "relu", 127), (32768, 256, "relu", 127),
                   (32768, 1024, "linear", 127), (32768, 1024, "tail", 127),
                   (32768, 512, "relu", 127), (8192, 512, "relu", 127),
                   (8192, 2048, "linear", 127), (8192, 2048, "tail", 127)]


def _requant_args(m, c, form, hi, dev, seed, ld=None, r_bits=8):
    """Sums [m, c] (a column slice of [m, ld] where ld is given), the
    site's vectors and, at a tail, a residual at ``r_bits``; scaled so the
    outputs reach past the clamp limits."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    full = torch.randint(-2 ** 21, 2 ** 21, (m, ld or c), generator=gen, dtype=torch.int32,
                         device=dev)
    acc = full[:, :c]
    sv = (torch.rand(c, generator=gen, device=dev) * 1.5 + 0.5) * 2.0 ** -14
    bias = torch.rand(c, generator=gen, device=dev) * 40 - 20
    inv = 1.0 / (torch.tensor(0.9, device=dev) * (127.0 / 7.0 if hi == 7 else 1.0))
    kw = {}
    if form == "tail":
        r_hi = 7 if r_bits == 4 else 127
        kw = {"residual": torch.randint(-r_hi, r_hi + 1, (m, c), generator=gen,
                                        dtype=torch.int8, device=dev),
              "r_scale": torch.tensor(0.41 * (127.0 / 7.0 if r_bits == 4 else 1.0),
                                      device=dev)}
    return (acc, sv, bias, inv, hi, form != "linear"), kw


def _requant_equals_plain(args, kw):
    before = trq.requant.launches
    got = trq.requant(*args, **kw)
    assert trq.requant.launches == before + 1
    ref = trq.requant_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert torch.equal(got, ref)
    return ref


@pytest.mark.parametrize("m,c,form,hi", REQUANT_SERVING)
def test_requant_kernel_serving_sites_equal_plain(cuda, m, c, form, hi):
    args, kw = _requant_args(m, c, form, hi, cuda, seed=m + c)
    ref = _requant_equals_plain(args, kw)
    lo = 0 if form != "linear" else -hi
    assert int(ref.min()) == lo and int(ref.max()) == hi


@pytest.mark.parametrize("form,hi,r_bits", [("relu", 127, 8), ("linear", 127, 8),
                                            ("relu", 7, 8), ("linear", 7, 8),
                                            ("tail", 127, 8), ("tail", 127, 4),
                                            ("tail", 7, 8), ("tail", 7, 4)])
@pytest.mark.parametrize("m,c,ld", [(1, 8, None), (17, 40, None), (17, 40, 64), (33, 24, 32),
                                    (5, 8, 32), (19, 1032, None), (64, 4 * 48, None)])
def test_requant_kernel_ragged_shapes_equal_plain(cuda, form, hi, r_bits, m, c, ld):
    """Every form at ragged shapes: one row, 17 rows, C a multiple of 8 but
    not of 16 or 128 (a thread's 8 channels, a block's 128 threads), a
    column slice of a padded torch._int_mm output read in place, and a
    subpixel site's 4x bias."""
    args, kw = _requant_args(m, c, form, hi, cuda, seed=7 * m + c, ld=ld, r_bits=r_bits)
    if c == 4 * 48:  # the subpixel site: the bias repeated over the four phases
        args = args[:2] + (args[2][:48].repeat(4),) + args[3:]
    _requant_equals_plain(args, kw)


@pytest.mark.parametrize("hi", [127, 7])
def test_requant_kernel_edge_values(cuda, hi):
    """Halves that round to even and the clamp limits (sums -132..131 plus
    0.5 at scale 1); sums near +-2^31 and past 2^24, where int32 -> f32
    rounds; both with and without a residual."""
    ties = torch.arange(-132, 132, dtype=torch.int32, device=cuda).reshape(-1, 8)
    one = torch.tensor(1.0, device=cuda)
    args = (ties, torch.ones(8, device=cuda), torch.full((8,), 0.5, device=cuda), one, hi,
            False)
    got = _requant_equals_plain(args, {})
    want = torch.clamp(torch.round(ties.double() + 0.5), -hi, hi).to(torch.int8)
    assert torch.equal(got, want)
    lim = torch.iinfo(torch.int32)
    big = torch.cat([torch.arange(lim.max - 63, lim.max + 1, dtype=torch.int64),
                     torch.arange(lim.min, lim.min + 64, dtype=torch.int64),
                     2 ** 24 + torch.arange(1, 129, 2), -(2 ** 24) - torch.arange(1, 129, 2)])
    big = big.to(torch.int32).reshape(-1, 16).to(cuda)
    sv = torch.full((16,), 2.0 ** -24, device=cuda)
    bias = torch.linspace(-0.5, 0.5, 16, device=cuda)
    _requant_equals_plain((big, sv, bias, one, hi, True), {})
    _requant_equals_plain((big, sv, bias, one, hi, True),
                          {"residual": torch.full(big.shape, -hi, dtype=torch.int8,
                                                  device=cuda), "r_scale": one * 0.5})


def test_requant_kernel_refuses_what_it_does_not_take(cuda):
    acc = torch.zeros(4, 8, dtype=torch.int32, device=cuda)
    sv, bias, one = torch.ones(8, device=cuda), torch.zeros(8, device=cuda), \
        torch.tensor(1.0, device=cuda)
    for bad in (acc.float(), acc.t(), acc.reshape(2, 2, 8)):
        with pytest.raises(ValueError):
            trq.requant(bad, sv, bias, one)
    with pytest.raises(ValueError):
        trq.requant(acc, sv[:4], bias, one)
    with pytest.raises(ValueError):
        trq.requant(acc, sv, bias, one, residual=torch.zeros(4, 7, dtype=torch.int8,
                                                             device=cuda), r_scale=one)
    # what the kernel's 16- and 8-byte accesses cannot take: C not a
    # multiple of 8, a row stride not a multiple of 4, sums or a residual
    # off their alignment
    wide = torch.zeros(4, 32, dtype=torch.int32, device=cuda)
    flat = wide.reshape(-1)
    for bad in (wide[:, :20], flat.as_strided((3, 8), (10, 1)), flat[2:26].reshape(3, 8),
                flat[1:57].reshape(7, 8)):
        c = bad.shape[1]
        with pytest.raises(ValueError, match="requant"):
            trq.requant(bad, torch.ones(c, device=cuda), torch.zeros(c, device=cuda), one)
    r8 = torch.zeros(33, dtype=torch.int8, device=cuda)[1:].reshape(4, 8)
    with pytest.raises(ValueError, match="aligned"):
        trq.requant(acc, sv, bias, one, residual=r8, r_scale=one)


def test_served_request_requant_kernel_equals_plain(cuda, monkeypatch):
    """One request of the serving model (ResNet-50 at 256x256, 2 groups of
    4 views, act4 at layer1 and layer2, B2 and B1): the kernel launches 53
    times (37 conv epilogues, 16 block tails) and the heatmaps equal those
    of the plain passes on the card bit for bit."""
    import chip_smoke
    from posetpu_torch.models import quant as tq
    from posetpu_torch.models.pose_resnet import PoseResNet

    gen = torch.Generator().manual_seed(20)
    model = PoseResNet(num_layers=50).eval()
    chip_smoke.trained_like_(model, gen)
    act4 = tuple(f"layer1_{i}.out" for i in range(3)) + tuple(
        f"layer2_{i}.out" for i in range(4))
    q, fwd = tq.quantize_pose_resnet(model, [torch.randn(8, 256, 256, 3, generator=gen)],
                                     jns_head="phase", phase_kernel=2, stem_s2d="pre",
                                     subpixel_deconvs={"deconv0"}, act4=act4,
                                     act4_mode="s4", device=cuda)
    x = torch.randint(-127, 128, (8, 128, 128, 12), generator=gen, dtype=torch.int8).to(cuda)
    before = trq.requant.launches
    got = fwd(q, x)
    assert trq.requant.launches == before + 53
    monkeypatch.setattr(trq, "requant", trq.requant_plain)
    ref = fwd(q, x)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and float(ref.std()) > 0


def _block_args(gen, cin, cm, cout, with_ds, dev):
    """Random bottleneck arguments in the kernels' layout, scaled so every
    stage's int8 range is exercised."""
    vec = lambda c, k: torch.stack([(torch.rand(c, generator=gen) + 0.5) * 0.6 / k ** 0.5 / 127,
                                    torch.rand(c, generator=gen) * 8 - 4])
    args = {"w1": _i8(gen, cm, cin), "w2": _i8(gen, cm, 9 * cm), "w3": _i8(gen, cout, cm),
            "v1": vec(cm, cin), "v2": vec(cm, 9 * cm), "v3": vec(cout, cm),
            "vr": torch.stack([torch.full((cout,), 0.7), torch.zeros(cout)])}
    if with_ds:
        args["wd"], args["vd"] = _i8(gen, cout, cin), vec(cout, cin)
    return trb.with_tiled_weights({k: v.to(dev) for k, v in args.items()})


@pytest.mark.parametrize("n,h,w,cin,cm,cout,with_ds", [
    (2, 8, 8, 64, 32, 64, False), (2, 8, 8, 64, 32, 64, True),
    (3, 5, 7, 96, 32, 96, False), (3, 7, 5, 32, 64, 72, True),
    (2, 10, 32, 64, 32, 64, False), (2, 7, 48, 64, 32, 160, True),
    (2, 64, 64, 64, 64, 256, True), (2, 64, 64, 256, 64, 256, False),
    (2, 32, 32, 512, 128, 512, False), (3, 16, 16, 1024, 256, 1024, False),
    (3, 8, 8, 2048, 512, 2048, False)])
def test_bottleneck_kernel_equals_plain(cuda, n, h, w, cin, cm, cout, with_ds):
    """B8a: both residual forms, odd H and W, images whose last row tile is
    ragged (10 rows in tiles of 8, 7 in tiles of 5), and the full-width
    shapes of layer1_0, layer1_1, layer2-4 (several row tiles per image, a
    half-filled tile at layer4)."""
    gen = torch.Generator().manual_seed(8)
    x = _i8(gen, n, h * w, cin, lo=0).to(cuda)
    args = _block_args(gen, cin, cm, cout, with_ds, cuda)
    before = trb.fused_bottleneck.launches
    got = trb.fused_bottleneck(x, args, h=h, w=w)
    assert trb.fused_bottleneck.launches == before + 1
    ref = trb.bottleneck_plain(x, args, h=h, w=w)
    torch.cuda.synchronize()
    assert got.shape == (n, h * w, cout)
    assert torch.equal(got, ref) and len(torch.unique(ref)) > 50


@pytest.mark.parametrize("n,h,w,cin,cm,cout,with_ds", [
    (1, 6, 6, 64, 64, 256, True), (5, 9, 7, 256, 64, 256, False),      # layer1's widths
    (1, 7, 10, 512, 128, 512, False), (7, 3, 8, 1024, 256, 1024, False),  # layer2, layer3
    (5, 5, 6, 2048, 512, 2048, False),                                 # layer4
    (3, 6, 9, 1024, 256, 1024, True), (2, 33, 5, 64, 32, 72, True),    # projections, odd N
    (1, 1, 1, 32, 32, 32, False), (13, 2, 130, 64, 64, 64, False)])    # one pixel; a wide row
def test_bottleneck_kernel_layer_widths_ragged_shapes(cuda, n, h, w, cin, cm, cout, with_ds):
    """B8a at each layer's (Cin, Cm, Cout) with few images, at ragged h and w,
    with the projection at deep widths too, with image counts that are
    multiples of nothing, and a row wider than a 128-row tile."""
    gen = torch.Generator().manual_seed(13)
    x = _i8(gen, n, h * w, cin, lo=0).to(cuda)
    args = _block_args(gen, cin, cm, cout, with_ds, cuda)
    got = trb.fused_bottleneck(x, args, h=h, w=w)
    ref = trb.bottleneck_plain(x, args, h=h, w=w)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and (n * h * w < 4 or len(torch.unique(ref)) > 20)


@pytest.mark.parametrize("h,w,cin,cm,cout,with_ds", [(10, 7, 64, 32, 64, False),
                                                     (9, 6, 96, 64, 40, True),
                                                     (16, 16, 256, 128, 256, False)])
def test_bottleneck_kernel_every_tile_height(cuda, h, w, cin, cm, cout, with_ds):
    """B8a with the row-tile height forced to every value that fits: the
    output does not depend on the block shape."""
    gen = torch.Generator().manual_seed(14)
    x = _i8(gen, 3, h * w, cin, lo=0).to(cuda)
    args = _block_args(gen, cin, cm, cout, with_ds, cuda)
    ref = trb.bottleneck_plain(x, args, h=h, w=w)
    for th in range(1, h + 1):
        assert torch.equal(trb._launch_rows(x, args, h, w, th), ref), th


def test_bottleneck_kernel_needs_tiled_weights(cuda):
    gen = torch.Generator().manual_seed(15)
    args = _block_args(gen, 64, 32, 64, False, cuda)
    del args["w2t"]
    with pytest.raises(ValueError, match="tiled"):
        trb.fused_bottleneck(torch.zeros(2, 16, 64, dtype=torch.int8, device=cuda), args, h=4, w=4)


@pytest.mark.parametrize("n,h,w,cin,cm,imgs", [
    (4, 8, 8, 64, 32, 2), (6, 5, 7, 96, 32, 3), (4, 10, 16, 64, 32, 2),
    (4, 64, 64, 256, 64, 2),
    (2, 32, 32, 512, 128, 2), (4, 16, 16, 1024, 256, 2), (4, 8, 8, 2048, 512, 2),
    (2, 10, 10, 2048, 512, 2), (2, 12, 12, 2048, 512, 2)])
def test_bottleneck_v2_kernel_equals_plain_and_v1(cuda, n, h, w, cin, cm, imgs):
    """B8b at small, odd (5x7 at Cm 32, whose k-steps span two taps), ragged
    (10 rows in 16 x 8 tiles) and full-width shapes, layer4's at 256^2, 320^2
    and 384^2 input (8x8, 10x10, 12x12): equal to its plain version and to
    B8a."""
    gen = torch.Generator().manual_seed(9)
    x = _i8(gen, n, h * w, cin, lo=0).to(cuda)
    args = _block_args(gen, cin, cm, cin, False, cuda)
    before = trb.fused_bottleneck_v2.launches
    got = trb.fused_bottleneck_v2(x, args, h=h, w=w, imgs=imgs)
    assert trb.fused_bottleneck_v2.launches == before + 1
    ref = trb.bottleneck_v2_plain(x, args, h=h, w=w, imgs=imgs)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and len(torch.unique(ref)) > 50
    assert torch.equal(got, trb.fused_bottleneck(x, args, h=h, w=w))


@pytest.mark.parametrize("n,h,w,cin,cm", [(4, 8, 8, 2048, 512), (4, 8, 8, 64, 32),
                                          (2, 6, 5, 96, 96), (2, 16, 16, 1024, 256),
                                          (2, 12, 12, 256, 64)])
def test_bottleneck_v2_every_form_and_ring(cuda, n, h, w, cin, cm):
    """B8b in every tile form its planner could pick for the shape (at 8x8
    the warpgroups splitting N; the 16 x 8 tile) at every ring (stages of one
    or two weight images) that fits: equal to its plain version and to B8a."""
    gen = torch.Generator().manual_seed(16)
    x = _i8(gen, n, h * w, cin, lo=0).to(cuda)
    args = _block_args(gen, cin, cm, cin, False, cuda)
    ref = trb.bottleneck_plain(x, args, h=h, w=w)
    assert torch.equal(trb.bottleneck_v2_plain(x, args, h=h, w=w, imgs=2), ref)
    runs = 0
    for form in trb.V2_FORMS:
        for ips in (1, 2):
            for stages in range(2, 9):
                try:
                    trb.plan_v2(h, w, cin, cm, cin, form=form, stages=stages, ips=ips)
                except ValueError:
                    continue
                got = trb._launch_v2(x, args, h, w, form, stages, ips)
                torch.cuda.synchronize()
                assert torch.equal(got, ref), (form, stages, ips)
                runs += 1
    assert runs >= 6 and len(torch.unique(ref)) > 50


def test_bottleneck_v2_timed_instance_equals_plain(cuda):
    """The timed instance the sweep measures with computes the same block
    and counts a step for every k-step of every job."""
    gen = torch.Generator().manual_seed(18)
    x = _i8(gen, 2, 100, 256, lo=0).to(cuda)
    args = _block_args(gen, 256, 64, 256, False, cuda)
    clocks = torch.zeros(len(trb.V2_CLOCK_SLOTS), dtype=torch.int64, device=cuda)
    got = trb._launch_v2(x, args, 10, 10, clocks=clocks)
    torch.cuda.synchronize()
    assert torch.equal(got, trb.bottleneck_plain(x, args, h=10, w=10))
    counts = dict(zip(trb.V2_CLOCK_SLOTS, clocks.tolist()))
    assert counts["jobs"] == 2 * 2 and counts["total"] > counts["steps"] > 0


def test_bottleneck_v2_needs_tiled_weights(cuda):
    gen = torch.Generator().manual_seed(17)
    x = torch.zeros(2, 16, 64, dtype=torch.int8, device=cuda)
    for key in ("w1t", "w2t", "w3t"):
        args = _block_args(gen, 64, 32, 64, False, cuda)
        del args[key]
        with pytest.raises(ValueError, match="tiled"):
            trb.fused_bottleneck_v2(x, args, h=4, w=4)


def _deconv_args(gen, cin, cout, joints, dev):
    args = {"w": _i8(gen, 4, 4, cout, cin),
            "v": torch.stack([(torch.rand(4 * cout, generator=gen) + 0.5) * 0.3 / cin ** 0.5 / 127,
                              torch.rand(4 * cout, generator=gen) * 8 - 4]),
            "wh": _i8(gen, joints, cout),
            "vh": torch.stack([torch.rand(joints, generator=gen) * 1e-3,
                               torch.rand(joints, generator=gen) - 0.5])}
    return tdc.with_deconv_weights({k: v.to(dev) for k, v in args.items()})


@pytest.mark.parametrize("n,h,w,cin,cout", [(3, 6, 8, 32, 16), (5, 3, 7, 96, 24),
                                            (4, 8, 8, 2048, 256), (4, 16, 16, 256, 256)])
def test_deconv_kernel_equals_plain(cuda, n, h, w, cin, cout):
    """B9a at small and odd shapes and at deconv0's and deconv1's widths."""
    gen = torch.Generator().manual_seed(10)
    x = _i8(gen, n, h * w, cin, lo=0).to(cuda)
    args = _deconv_args(gen, cin, cout, 4, cuda)
    before = tdc.fused_subpixel_deconv.launches
    got = tdc.fused_subpixel_deconv(x, args, h=h, w=w)
    assert tdc.fused_subpixel_deconv.launches == before + 1
    ref = tdc.subpixel_deconv_plain(x, args, h=h, w=w)
    torch.cuda.synchronize()
    assert got.shape == (n, 4 * h * w, cout)
    assert torch.equal(got, ref) and len(torch.unique(ref)) > 50


@pytest.mark.parametrize("n,h,w,cin,cout,joints", [(3, 6, 8, 32, 16, 16), (5, 3, 7, 96, 24, 7),
                                                   (4, 32, 32, 256, 256, 16)])
def test_deconv_head_kernel_equals_plain(cuda, n, h, w, cin, cout, joints):
    """B9b at small and odd shapes and at deconv2 + head's width."""
    gen = torch.Generator().manual_seed(11)
    x = _i8(gen, n, h * w, cin, lo=0).to(cuda)
    args = _deconv_args(gen, cin, cout, joints, cuda)
    before = tdc.fused_subpixel_deconv_head.launches
    got = tdc.fused_subpixel_deconv_head(x, args, h=h, w=w)
    assert tdc.fused_subpixel_deconv_head.launches == before + 1
    ref = tdc.subpixel_deconv_head_plain(x, args, h=h, w=w)
    torch.cuda.synchronize()
    assert got.shape == (n, 4 * h * w, joints) and got.dtype == torch.float32
    assert torch.equal(got, ref) and float(ref.std()) > 0


def _rings(h, w, cin, cout, jt, design, sets):
    """Every ring depth the planner allows for this launch."""
    depths = []
    for stages in range(2, 16):
        try:
            tpt.plan_tail2(h, w, cin, cout, jt, stages, design=design, folded=True, sets=sets)
        except ValueError:
            break
        depths.append(stages)
    return depths


@pytest.mark.parametrize("design,n,h,w,cin,cout,sets", [
    ("halo", 3, 6, 10, 64, 136, 8), ("halo", 2, 16, 16, 256, 256, 4),
    ("stream", 5, 8, 8, 2048, 256, 1), ("stream", 3, 9, 12, 64, 136, 2),
    ("stream", 5, 8, 8, 2048, 256, 4), ("stream", 3, 9, 12, 128, 24, 4)])
def test_deconv_kernel_every_design_and_ring(cuda, design, n, h, w, cin, cout, sets):
    """B9a's kernel in both its designs, at each ring depth the
    planner allows and a run of (phase, n-half) pairs a block, on grids the
    tiles overhang and batches the image pairs do not divide: equal to the
    plain version."""
    gen = torch.Generator().manual_seed(13)
    x = _i8(gen, n, h * w, cin, lo=0).to(cuda)
    args = _deconv_args(gen, cin, cout, 4, cuda)
    wt = tpt.tile_phase_weight(args["w"], chunked=design == "stream")
    ref = tdc.subpixel_deconv_plain(x, args, h=h, w=w).reshape(n, 2 * h, 2 * w, cout)
    depths = _rings(h, w, cin, cout, 0, design, sets)
    assert len(depths) >= 2
    for stages in depths:
        got = tpt.launch_tail2(x.reshape(n, h, w, cin), wt, args["v"], None, epilogue="folded",
                               design=design, sets=sets, stages=stages)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (design, stages)
    assert len(torch.unique(ref)) > 50


def test_deconv_head_kernel_every_ring(cuda):
    """B9b at every ring depth the planner allows, a partial n-half and 17
    joints (the 32-joint instance): equal to the plain version."""
    gen = torch.Generator().manual_seed(14)
    n, h, w, cin, cout, joints = 2, 6, 10, 64, 136, 17
    x = _i8(gen, n, h * w, cin, lo=0).to(cuda)
    args = _deconv_args(gen, cin, cout, joints, cuda)
    ref = tdc.subpixel_deconv_head_plain(x, args, h=h, w=w)
    for stages in _rings(h, w, cin, cout, 4, "halo", None):
        got = tpt.launch_tail2(x.reshape(n, h, w, cin), args["wt"], args["v"], None,
                               args["wht"], args["vh"], epilogue="folded", stages=stages)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), stages


def test_deconv_serving_plans_blocks_an_sm(cuda):
    """The three launches of path 5's B9 at their serving shapes put the
    planned blocks on an SM: deconv0's 128 streamed blocks one each (one
    wave), deconv1's and deconv2 + head's two."""
    plans = [(tpt.plan_tail2(8, 8, 2048, 256, 0, tdc.STREAM_STAGES, design=tdc.STREAM_DESIGN,
                             folded=True, sets=tdc.stream_sets(128, 8, 8, 256, 132)), 0, 1),
             (tpt.plan_tail2(16, 16, 256, 256, 0, folded=True), 0, 2),
             (tpt.plan_tail2(32, 32, 256, 256, 2, folded=True), 2, 2)]
    for plan, jt, blocks in plans:
        assert tpt.tail2_blocks_per_sm(plan, jt, epilogue="folded") == blocks, plan


def test_block_and_deconv_kernels_refuse_unsupported_shapes(cuda):
    gen = torch.Generator().manual_seed(12)
    z = lambda *s: torch.zeros(*s, dtype=torch.int8, device=cuda)
    # B8a: Cm % 32 != 0; identity residual with Cin != Cout; pixels != h*w
    with pytest.raises(ValueError):
        trb.fused_bottleneck(z(2, 16, 64), _block_args(gen, 64, 48, 64, False, cuda), h=4, w=4)
    with pytest.raises(ValueError):
        trb.fused_bottleneck(z(2, 16, 64), _block_args(gen, 64, 32, 96, False, cuda), h=4, w=4)
    with pytest.raises(ValueError):
        trb.fused_bottleneck(z(2, 15, 64), _block_args(gen, 64, 32, 64, False, cuda), h=4, w=4)
    # B8b: a projection residual; a batch that is no multiple of imgs
    with pytest.raises(ValueError):
        trb.fused_bottleneck_v2(z(2, 16, 64), _block_args(gen, 64, 32, 64, True, cuda), h=4, w=4)
    with pytest.raises(ValueError):
        trb.fused_bottleneck_v2(z(3, 16, 64), _block_args(gen, 64, 32, 64, False, cuda), h=4, w=4)
    # B9a: Cin % 32 != 0; B9b: a head of the wrong depth
    with pytest.raises(ValueError):
        tdc.fused_subpixel_deconv(z(2, 16, 48), _deconv_args(gen, 48, 16, 4, cuda), h=4, w=4)
    args = _deconv_args(gen, 32, 16, 4, cuda)
    args["wh"] = z(4, 24)
    with pytest.raises(ValueError):
        tdc.fused_subpixel_deconv_head(z(2, 16, 32), args, h=4, w=4)
    # B9b: more than 32 joints; a head after a deconv whose halo does not fit
    with pytest.raises(ValueError, match="J <= 32"):
        tdc.fused_subpixel_deconv_head(z(2, 16, 32), _deconv_args(gen, 32, 16, 33, cuda),
                                       h=4, w=4)
    with pytest.raises(ValueError, match="resident halo"):
        tdc.fused_subpixel_deconv_head(z(2, 16, 2048), _deconv_args(gen, 2048, 16, 4, cuda),
                                       h=4, w=4)


def test_final_preds_jns_decodes_through_b7(cuda):
    """The S-minor final predictions on the card: one B7 launch on the maps
    as they lie, equal to the plain decode on the CPU (the inverse affine's
    2 x 2 product may round apart by an ulp)."""
    from posetpu_torch.core.inference import final_preds_jns

    gen = torch.Generator().manual_seed(31)
    hm = torch.randn(16, 3, 4, 64 * 64, generator=gen)
    hm[2, 1, 0] = -hm[2, 1, 0].abs()  # a map whose maximum is <= 0
    center = torch.rand(3, 4, 2, generator=gen) * 400 + 300
    scale = torch.rand(3, 4, 2, generator=gen) + 2
    before = tdec.decode_heatmaps_kernel.launches
    p, m = final_preds_jns(hm.to(cuda), center.to(cuda), scale.to(cuda), (64, 64))
    assert tdec.decode_heatmaps_kernel.launches == before + 1
    p_cpu, m_cpu = final_preds_jns(hm, center, scale, (64, 64))
    assert torch.equal(m.cpu(), m_cpu)
    torch.testing.assert_close(p.cpu(), p_cpu, rtol=0, atol=1e-4)


def test_bf16_train_step_on_the_card_matches_the_cpu(cuda):
    """One bf16 train step (ResNet-18, 64x64, two groups, MSE + consistency +
    fundamental) from the same weights on the card and on the CPU. bf16
    convolutions round at other points in cuDNN than on the CPU, and
    train-mode BN amplifies that toward the stem (the stem's gradient moves
    by ~40 % between the two), so the yardstick is bf16's own error: the
    card's loss and each parameter's gradient lie no further from the CPU's
    bf16 ones than three times the distance of those from the CPU's f32
    step on the same weights (or than 1e-3 of the loss and 1e-2 of the
    gradient's norm)."""
    import copy

    import numpy as np

    from posetpu_torch.config import default_config
    from posetpu_torch.data.synthetic import make_camera_ring
    from posetpu_torch.geometry.fundamental import bank_to_batch, build_fundamental_bank
    from posetpu_torch.models.multiview import get_multiview_pose_net
    from posetpu_torch.train.optim import make_optimizer
    from posetpu_torch.train.step import init_train_state, make_train_step

    cfg = default_config()
    cfg.NETWORK.IMAGE_SIZE = np.array([64, 64])
    cfg.NETWORK.HEATMAP_SIZE = np.array([16, 16])
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.NETWORK.AGGRE = True
    cfg.LOSS.USE_CONSISTENT_LOSS = True
    cfg.LOSS.USE_FUNDAMENTAL_LOSS = True
    rs = np.random.RandomState(0)
    batch = {"images": rs.randn(2, 4, 64, 64, 3).astype(np.float32),
             "target": rs.rand(2, 4, 16, 16, 16).astype(np.float32) * 0.1,
             "weight": np.ones((2, 4, 16), np.float32),
             "is_h36m": np.ones(2, np.float32),
             "center": np.full((2, 4, 2), 500.0, np.float32),
             "scale": np.full((2, 4, 2), 2.5, np.float32),
             "fmats": bank_to_batch(build_fundamental_bank({0: make_camera_ring()}),
                                    [0, 0]).numpy()}
    out = {}
    for label, dev, dtype in (("cpu", "cpu", torch.bfloat16), ("card", cuda, torch.bfloat16),
                              ("f32", "cpu", torch.float32)):
        net = get_multiview_pose_net(cfg, torch.Generator().manual_seed(0), dtype=dtype)
        tx = make_optimizer(cfg, 10)
        state = init_train_state(net, tx, device=dev)
        _, metrics = make_train_step(net, cfg, tx, device=dev)(state, copy.deepcopy(batch))
        out[label] = ({k: float(v) for k, v in metrics.items()},
                      {k: p.grad.double().cpu() for k, p in net.named_parameters()})
    (m_cpu, g_cpu), (m_card, g_card), (m_f32, g_f32) = out["cpu"], out["card"], out["f32"]
    assert all(np.isfinite(v) for v in m_card.values())
    assert abs(m_card["loss"] - m_cpu["loss"]) <= max(3 * abs(m_cpu["loss"] - m_f32["loss"]),
                                                      1e-3 * abs(m_f32["loss"]))
    for k, g in g_cpu.items():
        card, bf16 = float((g_card[k] - g).norm()), float((g - g_f32[k]).norm())
        assert card <= max(3 * bf16, 1e-2 * float(g_f32[k].norm())), (k, card, bf16)


@pytest.mark.parametrize("parity", [0, 1])
def test_adversarial_step_on_the_card_matches_the_cpu(cuda, parity):
    """One f32 adversarial step (ResNet-18, 64x64, four groups, the five
    critics + the fundamental loss: chip_smoke.py's path 8 configuration)
    from the same weights and draws on the card (TF32 off) and on the CPU,
    held by ``chip_smoke.gan_card_vs_cpu``: the loss within 1e-4 relative,
    each model's gradients within path 7's bounds or three times the CPU's
    own distance under a 1e-7 nudge of the images."""
    import chip_smoke

    cfg = chip_smoke.gan_config(18, 64, 16)
    batch = chip_smoke.gan_batch(4, 64, 16, 16, "cpu", seed=3)
    line, failures = chip_smoke.gan_card_vs_cpu(cfg, batch, parity, cuda, seed=5)
    assert not failures, (failures, line)


def test_3d_stages_on_the_card_match_the_cpu(cuda):
    """chip_smoke.py's path 9 card-vs-CPU checks at test size: 16 groups of
    skeleton views rendered, scaled by a confidence, one view of some
    joints moved 60 crop px, decoded through B7; RANSAC's res_vis equal and
    the reprojection within 1e-3 px; one group's RPSM (test_rpsm.yaml's 16
    bins, depth 10) within 1 mm a joint (chip_smoke.path9_card_vs_cpu)."""
    import numpy as np

    import chip_smoke
    from posetpu_torch.config import default_config
    from posetpu_torch.core.inference import final_preds
    from posetpu_torch.data.synthetic import make_camera_ring, make_skeleton_poses, tile_cameras
    from posetpu_torch.geometry.cameras import project_points, project_pose
    from posetpu_torch.geometry.pictorial import limb_lengths_from_pose

    g = 16
    cams = tile_cameras(make_camera_ring(device=cuda), g)
    poses = torch.from_numpy(make_skeleton_poses(g, seed=2)).to(cuda)
    pix = project_points(poses[:, None], cams)
    center, scale = chip_smoke.crop_boxes(pix)
    gen = torch.Generator(device=cuda).manual_seed(2)
    conf = torch.rand(g, 4, 16, generator=gen, device=cuda) * 0.6 + 0.4
    shift = torch.zeros(g, 4, 16, 2, device=cuda)
    shift[torch.arange(g), torch.arange(g) % 4, torch.arange(g) % 16] = 60.0
    before = tdec.decode_heatmaps_kernel.launches
    preds, maxvals = final_preds(chip_smoke.render_views(pix, center, scale, shift, conf),
                                 center, scale)
    assert tdec.decode_heatmaps_kernel.launches == before + 1
    cfg = default_config()
    cfg.NETWORK.IMAGE_SIZE, cfg.NETWORK.HEATMAP_SIZE = np.array([256, 256]), np.array([64, 64])
    pix_r = project_pose(poses[:1, None], cams.map(lambda x: x[:1]))
    center_r, scale_r = chip_smoke.crop_boxes(pix_r)
    one = (chip_smoke.render_views(pix_r, center_r, scale_r), cams.map(lambda x: x[:1]),
           center_r, scale_r, poses[:1, 6].contiguous(), limb_lengths_from_pose(poses).mean(0),
           cfg)
    line = chip_smoke.path9_card_vs_cpu({"preds": preds, "cams": cams,
                                         "vis": (maxvals > 0.6).float(), "rpsm_one": one})
    assert "equal" in line


def test_image_loader_prepare_bf16_step_and_validate_on_the_card(cuda, tmp_path):
    """Path 10 at test size: the train CLI's setup on the MPII preset (cut
    to ResNet-18, 64x64 crops, 16x16 maps, 2 groups a batch) over a small
    image fixture; the loader's batch prepared on the card equals the CPU's
    (images within 2 ulp, targets within 1e-6); one bf16 step with finite
    metrics; validate launches B7 once a batch."""
    import os

    import numpy as np

    from posetpu_torch.cli import train as train_cli
    from posetpu_torch.cli.common import load_cfg
    from posetpu_torch.data.prepare import make_prepare_fn
    from posetpu_torch.data.synthetic import write_image_fixture
    from posetpu_torch.train.loop import validate

    write_image_fixture(str(tmp_path / "data"), n_images=8, mpii_size=(160, 120),
                        h36m_size=(200, 200), mpii_train=16, mpii_valid=12,
                        h36m_train_groups=2, h36m_valid_groups=2)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = train_cli.parse_args(["--cfg", os.path.join(root, "experiments/mpii/resnet50/"
                                                       "140e_32batch.yaml"),
                                 "--modelDir", str(tmp_path / "output"), "--logDir",
                                 str(tmp_path / "log"), "--dataDir", str(tmp_path)])
    cfg = load_cfg(args)
    cfg.NETWORK.IMAGE_SIZE, cfg.NETWORK.HEATMAP_SIZE = np.array([64, 64]), np.array([16, 16])
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 2
    tr = train_cli.setup(cfg, args, device=cuda)
    host = next(iter(tr.train_loader))
    batch = tr.prepare(host)
    ref = make_prepare_fn(cfg, "cpu")(host)
    assert batch["images"].is_cuda and batch["target"].shape == (2, 4, 16, 16, 16)
    assert float((batch["images"].cpu() - ref["images"]).abs().max()) <= 2 * float(
        np.spacing(np.float32(2.7)))
    assert float((batch["target"].cpu() - ref["target"]).abs().max()) <= 1e-6
    state, metrics = tr.train_step(tr.state, batch)
    assert state.step == 1 and all(bool(torch.isfinite(v).all()) for v in metrics.values())
    before = tdec.decode_heatmaps_kernel.launches
    perf, _, preds, _ = validate(cfg, tr.test_loader, tr.test_ds, tr.eval_step, state.params,
                                 device=cuda)
    assert tdec.decode_heatmaps_kernel.launches == before + len(tr.test_loader) == before + 2
    assert preds.shape == (12, 16, 3) and np.isfinite(preds).all() and 0 <= perf <= 1
    tr.writer.close()


def test_qat_and_the_int8_eval_step_on_the_card_match_the_cpu(cuda):
    """chip_smoke.py's path 11 card-vs-CPU checks at test size: one QAT step
    of a ResNet-18 at 64x64 on 2 groups (chip_smoke.qat_card_vs_cpu: in
    float64 the loss within 1e-4 relative and at most 0.1 % of the int8
    weights off by one), then make_quant_eval_step with the flip test on 2
    groups through the same PTQ qparams, without the bank (heatmaps and
    maxvals equal, preds within 1e-4 px) and with a U(0, 0.1) bank at
    S = 256 (within one bf16 step; chip_smoke.eval_step_card_vs_cpu); B7
    decodes on the card once a step."""
    import numpy as np

    import chip_smoke
    from posetpu_torch.config import default_config
    from posetpu_torch.models.multiview import get_multiview_pose_net
    from posetpu_torch.train.serve import build_quant_from_variables

    line, failures = chip_smoke.qat_card_vs_cpu(cuda)
    assert not failures, (failures, line)
    cfg = default_config()
    cfg.NETWORK.IMAGE_SIZE, cfg.NETWORK.HEATMAP_SIZE = np.array([64, 64]), np.array([16, 16])
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.NETWORK.AGGRE = cfg.TEST.FUSE_OUTPUT = cfg.TEST.FLIP_TEST = True
    gen = torch.Generator().manual_seed(4)
    model = get_multiview_pose_net(cfg, gen)
    chip_smoke.trained_like_(model, gen)
    sd = model.state_dict()
    stats = {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
    variables = {"params": {k: v for k, v in sd.items() if k not in stats},
                 "batch_stats": stats}
    rs = np.random.RandomState(4)
    batch = {"images": torch.from_numpy(rs.randn(2, 4, 64, 64, 3).astype(np.float32)),
             "is_h36m": torch.ones(2), "center": torch.full((2, 4, 2), 100.0),
             "scale": torch.full((2, 4, 2), 1.0)}
    quant = build_quant_from_variables(cfg, variables, [batch["images"].reshape(-1, 64, 64, 3)],
                                       device="cpu")
    for bank in (None, quant[2]):
        before = tdec.decode_heatmaps_kernel.launches
        line, failures = chip_smoke.eval_step_card_vs_cpu(
            cfg, [(0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13)],
            (quant[0], quant[1], bank), batch, cuda)
        assert not failures, (failures, line)
        assert tdec.decode_heatmaps_kernel.launches == before + 1
