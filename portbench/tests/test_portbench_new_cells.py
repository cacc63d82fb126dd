"""The ViTPose cell's driver, below its look for a chip, at the CPU's tiny
size: the unbroken path is correct, each fault planted underneath
(portbench/faults_vit.py) and the ViTPose control are not.

Tiny ViTPose: width 64, depth 2, 4 heads, 64x64 images, 16x16 maps, 2
groups a step. Its limits here are its own, from its readings on seed 13
(first loss 4e-5, median leaf 9e-4, worst kernel 7e-3, median change
1.6e-3, worst change 0.015, median running average 1e-3, after the first
step 1.5e-3), with room above each; the cell's limits are set on the chip
(PERF.md). At this width the attention's logits are near zero, so the
unscaled attention moves nothing and is read on the chip alone."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness

CPU = torch.device("cpu")
VIT = "train.vitpose_h_256_fusion"
VIT_LIMITS = {"loss1_gap": 0.002, "grad_gap_median": 0.01, "grad_gap_kernels": 0.03,
              "step_gap_median": 0.02, "step_gap": 0.1, "stats_gap_median": 0.01,
              "stats1_gap_median": 0.01}


def _vit(seed=13, fault=None, variant="program"):
    _, cell, cfg = harness.cell_files(VIT)
    over = {"TRAIN.BATCH_SIZE": 2, "POSE_VIT.EMBED_DIM": 64, "POSE_VIT.DEPTH": 2,
            "POSE_VIT.NUM_HEADS": 4, "NETWORK.IMAGE_SIZE": [64, 64],
            "NETWORK.HEATMAP_SIZE": [16, 16]}
    cfg = dict(cfg, overrides={**cfg["overrides"], **over}, embed_dim=64, depth=2, num_heads=4,
               image_size=[64, 64], heatmap_size=[16, 16], batch_groups=2)
    cell = dict(cell, groups=2, pool=4, reference_checkpoint=False, limits=VIT_LIMITS)
    ctx = harness.Context(cell=cell, cfg=cfg, seed=seed, seconds=0.5, trace=False, device=CPU,
                          t_start=time.perf_counter(), variant=variant, fault=fault)
    drv = harness.driver(cell["kind"])
    return drv.control(ctx) if variant == "control" else drv.run(ctx)


def test_the_vit_path_is_correct():
    rec = _vit()
    assert rec.correct and rec.iterations > 0, rec.compared


@pytest.mark.parametrize("fault", ["layer_decay_skipped", "unchanged", "half_batch",
                                   "stats_unchanged", "bank_unchanged"])
def test_a_fault_under_the_vit_is_not_correct(fault):
    rec = _vit(fault=fault)
    assert rec.attempted > 0 and not rec.correct, rec.compared


def test_the_vit_control_is_not_correct():
    rec = _vit(variant="control")
    assert rec.attempted > 0 and not rec.correct, rec.compared

