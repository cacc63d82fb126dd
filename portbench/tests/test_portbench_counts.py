"""The yardstick's counters against known numbers: the ResNets' published
multiply-accumulates at 224x224, PyTorch's own FLOP counter over the plain
reference at the cells' sizes, and the serving kernels' bounds in PERF.md's
kernel table."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, harness
from portbench.reference import model as M


def _cfg(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("layers, gmacs", [(18, 1.81), (50, 4.09), (152, 11.51)])
def test_trunk_at_224_matches_the_published_counts(layers, gmacs):
    """torchvision's table: ResNet-18 1.81, -50 4.09, -152 11.51 GMAC at
    224x224 (its classifier's 0.5-2 M left out here)."""
    cfg = {**_cfg("r50_256_fusion"), "num_layers": layers, "image_size": [224, 224]}
    assert counts.trunk_macs(cfg) / 1e9 == pytest.approx(gmacs, rel=3e-3)


@pytest.mark.parametrize("name, macs", [("r50_256_fusion", 7_234_125_824),
                                        ("r152_320_nofusion", 26_455_244_800)])
def test_image_macs_worked_by_hand_and_by_torch(name, macs):
    """One image, trunk to head. R50 at 256: the trunk 5,338,300,416 MAC
    (4.087 G at 224 x (256/224)^2, to the pixel), the deconvs
    8^2*16*2048*256 + 16^2*16*256^2 + 32^2*16*256^2 = 1,879,048,192 and the
    head 64^2*256*16 = 16,777,216. R152 at 320: the trunk 23,493,017,600,
    the deconvs 10^2*16*2048*256 + 20^2*16*256^2 + 40^2*16*256^2 and the
    head 80^2*256*16. PyTorch's FLOP counter over the plain reference
    agrees."""
    cfg = _cfg(name)
    assert counts.image_macs(cfg) == macs
    w = {n: torch.zeros(s, device="meta") for n, s, _ in M.param_spec(cfg)}
    x = torch.zeros(1, cfg["image_size"][1], cfg["image_size"][0], 3, device="meta")
    with FlopCounterMode(display=False) as fc:
        M.pose_resnet(w, x, cfg, train=False)
    assert fc.get_total_flops() == 2 * macs


def test_r50_hand_sums():
    cfg = _cfg("r50_256_fusion")
    deconvs = 8**2 * 16 * 2048 * 256 + 16**2 * 16 * 256**2 + 32**2 * 16 * 256**2
    assert counts.image_macs(cfg) == 5_338_300_416 + deconvs + 64**2 * 256 * 16
    assert counts.trunk_macs(cfg) == 5_338_300_416


def test_request_and_step_operations():
    """A serve request of 32 groups: 128 images and the fusion's 12 x 512 x
    4096 x 4096 MAC, 1.029 T MAC; a training step three times that in FLOPs."""
    r50, r152 = _cfg("r50_256_fusion"), _cfg("r152_320_nofusion")
    assert counts.bank_macs(r50, 32) == 12 * 32 * 16 * 4096 * 4096
    assert counts.request_ops(r50, 32, 4) / 2 == pytest.approx(1.029047e12, rel=1e-6)
    assert counts.train_step_flops(r50, 32, 4) == pytest.approx(6.174284e12, rel=1e-6)
    assert counts.train_step_flops(r152, 32, 4) == pytest.approx(20.317628e12, rel=1e-6)


def test_serving_kernel_bounds_match_the_kernel_table():
    """PERF.md's kernel table: B2 0.0694, B1 0.1758, B3 0.1042 (operations)
    and the quantize pass 0.0125 (bytes) ms at 128 images."""
    b = counts.serve_hand_kernel_bounds(_cfg("r50_256_fusion"), 32, 4)
    assert b["deconv0"] == pytest.approx(0.0694, abs=1e-4)
    assert b["deconv1"] + b["deconv2+head"] == pytest.approx(0.1758, abs=1e-4)
    assert b["fusion"] == pytest.approx(0.1042, abs=1e-4)
    assert b["quantize"] == pytest.approx(0.0125, abs=1e-4)


def test_bound_takes_the_slower_roof():
    assert counts.bound_ms(1.979e12, 0) == pytest.approx(1.0)
    assert counts.bound_ms(0, 3.35e9) == pytest.approx(1.0)
    assert counts.bound_ms(1.979e12, 6.7e9) == pytest.approx(2.0)
