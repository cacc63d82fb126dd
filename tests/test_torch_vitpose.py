"""ViTPose as the multi-view model's backbone (models/vitpose.py), AdamW
with layer-wise decay, clipping and warm-up (train/optim.py), on the CPU at
a small size, against the benchmark's plain reference
(portbench/reference/vitpose.py) on seeded random weights: a ViT of width 64,
depth 2, 4 heads, 64x64 images (a 4x4 patch grid), two deconvolutions to
16x16 maps and the bank at 16x16.

Tolerances. The program and the reference run in float64 where they are
compared, so that what is left is the program's own f32 roundings: the
heatmaps leave the backbone and the bank in f32 (PoseResNet's contract),
about 6e-8 of a value, which the loss and every gradient carry. Hence
1e-6 relative on maps, loss and gradients. On the parameters after three
AdamW steps, the median element within 1e-6 of a step (lr times the
layer's scale) and every element within 1e-4: from step 2 Adam's
direction is a ratio of moments, and where an element's gradient changes
sign between steps that ratio moves the 1e-7 of a rounding up to 2e-5 of
a step (measured: 1.8e-5 at most, on 2 of a million elements of the last
deconvolution).
Drop-path masks agree exactly.
"""

from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

from portbench.reference import vitpose as P
from posetpu_torch.config import get_model_name, load_config
from posetpu_torch.models import vitpose as V
from posetpu_torch.models.multiview import get_multiview_pose_net
from posetpu_torch.models.pose_resnet import PoseResNet
from posetpu_torch.train.optim import Optimizer, make_optimizer
from posetpu_torch.train.step import init_train_state, make_train_step
from posetpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "posetpu_torch/experiments/mixed/vitpose/h_256_fusion.yaml")
TINY = {"POSE_VIT.EMBED_DIM": 64, "POSE_VIT.DEPTH": 2, "POSE_VIT.NUM_HEADS": 4,
        "NETWORK.IMAGE_SIZE": [64, 64], "NETWORK.HEATMAP_SIZE": [16, 16],
        "TRAIN.BATCH_SIZE": 2}
SEED = 2**33 + 11  # the drop-path generator's


def _cfg(**over):
    return load_config(YAML, **{**TINY, **over})


def _ref_cfg(cfg) -> dict:
    """The reference's configuration dict of a program configuration."""
    v, t = cfg.POSE_VIT, cfg.TRAIN
    return {"image_size": [int(s) for s in cfg.NETWORK.IMAGE_SIZE],
            "heatmap_size": [int(s) for s in cfg.NETWORK.HEATMAP_SIZE],
            "num_joints": int(cfg.NETWORK.NUM_JOINTS), "patch_size": int(v.PATCH_SIZE),
            "patch_padding": int(v.PATCH_PADDING), "embed_dim": int(v.EMBED_DIM),
            "depth": int(v.DEPTH), "num_heads": int(v.NUM_HEADS),
            "mlp_ratio": float(v.MLP_RATIO), "drop_path_rate": float(v.DROP_PATH_RATE),
            "deconv_filters": list(v.NUM_DECONV_FILTERS),
            "deconv_kernels": list(v.NUM_DECONV_KERNELS),
            "final_conv_kernel": int(v.FINAL_CONV_KERNEL), "aggre": bool(cfg.NETWORK.AGGRE),
            "consistent_loss": bool(cfg.LOSS.USE_CONSISTENT_LOSS),
            "consistent_loss_weight": float(cfg.LOSS.CONSISTENT_LOSS_WEIGHT),
            "lr": float(t.LR), "weight_decay": float(t.WD), "layer_decay": float(t.LAYER_DECAY),
            "clip_grad_norm": float(t.CLIP_GRAD_NORM), "warmup_iters": int(t.WARMUP_ITERS),
            "warmup_ratio": float(t.WARMUP_RATIO)}


def _model(cfg, dtype=torch.float64, seed=3):
    """The program's model at ``dtype`` (its parameters too), the head
    rescaled from its N(0, 0.001) init so that the maps are of order one,
    BatchNorm trained-like; and its weights by name for the reference."""
    gen = torch.Generator().manual_seed(seed)
    model = get_multiview_pose_net(cfg, gen, dtype=dtype)
    with torch.no_grad():
        vit = model.backbone
        for i in range(len(vit.deconv_filters)):
            w = getattr(vit, f"deconv{i}_conv").weight
            w.normal_(0, math.sqrt(2.0 / (w.shape[0] * 4)), generator=gen)
            bn = getattr(vit, f"deconv{i}_bn")
            bn.weight.copy_(1 + 0.1 * torch.randn(bn.weight.shape, generator=gen))
            bn.bias.normal_(0, 0.1, generator=gen)
            bn.running_mean.normal_(0, 0.1, generator=gen)
            bn.running_var.copy_(1 + 0.05 * torch.randn(bn.weight.shape, generator=gen).abs())
        vit.final_layer.weight.normal_(0, 0.1, generator=gen)
    model = model.to(dtype)
    vit.seed_drop_path(SEED)
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()
                   if not k.endswith("num_batches_tracked")}


def _batch(cfg, dtype=torch.float64, seed=5):
    rs = np.random.RandomState(seed)
    n, v, j = 2, 4, int(cfg.NETWORK.NUM_JOINTS)
    s, h = int(cfg.NETWORK.IMAGE_SIZE[0]), int(cfg.NETWORK.HEATMAP_SIZE[0])
    t = lambda a: torch.tensor(a, dtype=dtype)
    return {"images": t(rs.randn(n, v, s, s, 3)), "target": t(rs.rand(n, v, h, h, j) * 0.5),
            "weight": t((rs.rand(n, v, j) > 0.2).astype(float)),
            "is_h36m": t([1.0, 0.0]), "center": t(np.full((n, v, 2), 32.0)),
            "scale": t(np.full((n, v, 2), 0.3))}


def _gen():
    return torch.Generator().manual_seed(SEED)


def test_the_configuration_builds_vitpose_h():
    cfg = load_config(YAML)
    assert get_model_name(cfg) == ("multiview_vitpose_32x1280",
                                   "256x256_multiview_vitpose_32x1280_d256d256")
    with torch.device("meta"):
        model = get_multiview_pose_net(cfg, dtype=torch.bfloat16)
    vit = model.backbone
    assert isinstance(vit, V.ViTPose) and model.backbone_name == "vit"
    assert vit.grid == (16, 16) and vit.pos_embed.shape == (1, 257, 1280)
    assert len(vit.blocks) == 32 and vit.blocks[0].attn.qkv.weight.shape == (3840, 1280)
    assert vit.blocks[0].mlp.fc1.weight.shape == (5120, 1280)
    assert vit.drop_path_rates[0] == 0 and vit.drop_path_rates[-1] == pytest.approx(0.55)
    n = sum(p.numel() for k, p in model.named_parameters() if k.startswith("vit."))
    assert n == 637_290_512
    assert model.aggre_layer.weight.shape == (12, 4096, 4096)


@pytest.mark.parametrize("name, layer", [("vit.pos_embed", 0), ("vit.patch_embed.bias", 0),
                                         ("vit.blocks.0.norm1.weight", 1),
                                         ("vit.blocks.31.mlp.fc2.weight", 32),
                                         ("vit.last_norm.weight", 33),
                                         ("vit.final_layer.bias", 33),
                                         ("aggre_layer.weight", 33)])
def test_layer_ids_follow_vitpose(name, layer):
    assert V.layer_id(name, 32) == layer == P.layer_of(name, 32)


@pytest.mark.parametrize("train", [False, True])
def test_heatmaps_match_the_plain_reference(train):
    cfg = _cfg()
    model, w = _model(cfg)
    b = _batch(cfg)
    model.train(train)
    with torch.no_grad():
        raw, fused, low, high = model(b["images"])
        keep = P.drop_keep(_ref_cfg(cfg), 8, _gen()) if train else None
        r_raw, r_fused, _ = P.forward(w, b["images"], _ref_cfg(cfg), train=train, keep=keep)
    assert low.shape == (2, 4, 4, 4, 64) and high.shape == (2, 4, 16, 16, 256)
    for got, ref in ((raw, r_raw), (fused, r_fused)):
        assert got.shape == ref.shape == (2, 4, 16, 16, 16)
        torch.testing.assert_close(got.double(), ref, rtol=1e-6, atol=1e-6 * ref.abs().max())


def test_drop_path_masks_are_the_references():
    cfg = _cfg(**{"POSE_VIT.DEPTH": 6})
    model, _ = _model(cfg)
    vit = model.backbone
    gen = _gen()
    for _ in range(3):  # three training forwards in a row
        got = vit._keep(8, torch.device("cpu"))
        ref = P.drop_keep(_ref_cfg(cfg), 8, gen)
        assert len(got) == 6
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert any((k == 0).any() for k in got)  # some branches dropped


def test_evaluation_draws_nothing():
    cfg = _cfg()
    model, _ = _model(cfg)
    model.eval()
    with torch.no_grad():
        a = model(_batch(cfg)["images"])[0]
        b = model(_batch(cfg)["images"])[0]
    assert model.backbone._gen is None and torch.equal(a, b)


def test_loss_and_every_gradient_match_the_plain_reference():
    cfg = _cfg(**{"TRAIN.CLIP_GRAD_NORM": 0.0})
    model, w = _model(cfg)
    b = _batch(cfg)
    tx = make_optimizer(cfg, 10)
    state = init_train_state(model, tx, device="cpu")
    state, metrics = make_train_step(model, cfg, tx, device="cpu")(state, b)
    rc = _ref_cfg(cfg)
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()
              if not k.endswith(("running_mean", "running_var"))}
    stats = {k: v for k, v in w.items() if k.endswith(("running_mean", "running_var"))}
    value, new_stats, _ = P.loss({**params, **stats}, b, rc, keep=P.drop_keep(rc, 8, _gen()))
    grads = dict(zip(params, torch.autograd.grad(value, list(params.values()))))
    assert float(metrics["loss"]) == pytest.approx(float(value.detach()), rel=1e-6)
    got = dict(model.named_parameters())
    assert set(got) == set(grads)
    for k, g in grads.items():
        torch.testing.assert_close(got[k].grad, g, rtol=1e-6, atol=1e-6 * g.abs().max(),
                                   msg=k)
    for k, v in new_stats.items():  # BatchNorm's running averages in the head
        torch.testing.assert_close(model.state_dict()[k], v, rtol=1e-6, atol=1e-9, msg=k)


def test_three_adamw_steps_match_the_plain_reference():
    """Layer decay 0.85, weight decay 0.1, the gradient clipped at a norm
    it exceeds, two warm-up steps from 0.001 of the rate."""
    cfg = _cfg(**{"TRAIN.LR": 1e-3, "TRAIN.CLIP_GRAD_NORM": 0.05, "TRAIN.WARMUP_ITERS": 2})
    model, w = _model(cfg)
    batches = [_batch(cfg, seed=s) for s in (5, 6, 7)]
    tx = make_optimizer(cfg, 10)
    assert tx.kind == "adamw" and tx.clip_norm == 0.05
    state = init_train_state(model, tx, device="cpu")
    step = make_train_step(model, cfg, tx, device="cpu")
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    rc = _ref_cfg(cfg)
    ref = P.follow(w, batches, rc, SEED)
    assert ref["grad_norm1"] > 0.05  # the clip acts
    assert losses == pytest.approx(ref["losses"], rel=1e-6)
    got = dict(model.named_parameters())
    for k, p in ref["params"].items():
        lr_k = rc["lr"] * rc["layer_decay"] ** (rc["depth"] + 1 - P.layer_of(k, rc["depth"]))
        moved = (p - w[k]).abs().max()
        assert moved > 0.5 * lr_k, k  # every leaf stepped
        gap = (got[k].detach() - p).abs()
        assert float(gap.max()) <= 1e-4 * lr_k, k
        assert float(gap.median()) <= 1e-6 * lr_k, k
    sd = model.state_dict()
    for k, v in ref["stats"].items():
        torch.testing.assert_close(sd[k], v, rtol=1e-6, atol=1e-9, msg=k)


def test_adamw_is_torch_adamw_with_groups_clipping_and_warmup():
    """The optimizer alone against torch.optim.AdamW over one parameter
    group a (rate scale, decay) pair, clip_grad_norm_ and mmcv's warm-up
    as a LambdaLR: three steps on fixed gradients, f64."""
    gen = torch.Generator().manual_seed(1)
    net = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.LayerNorm(5), torch.nn.Linear(5, 3))
    net = net.double()
    scales = {"0.weight": 0.5, "0.bias": 0.5, "1.weight": 0.8, "1.bias": 0.8, "2.weight": 1.0,
              "2.bias": 1.0}
    grads = [{n: torch.randn(p.shape, generator=gen, dtype=torch.float64)
              for n, p in net.named_parameters()} for _ in range(3)]
    lr, wd, warm, ratio, clip = 1e-2, 0.1, 2, 0.001, 0.5
    ref = [p.detach().clone().requires_grad_(True) for p in net.parameters()]
    names = [n for n, _ in net.named_parameters()]
    groups = [{"params": [r], "lr": lr * scales[n], "weight_decay": wd if r.dim() > 1 else 0.0}
              for n, r in zip(names, ref)]
    opt = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda i: 1 - (1 - i / warm) * (1 - ratio) if i < warm else 1.0)
    from posetpu_torch.train.optim import linear_warmup

    tx = Optimizer("adamw", linear_warmup(lambda c: np.float32(lr), warm, ratio),
                   weight_decay=wd, lr_scale=scales.get, clip_norm=clip)
    state = tx.init(net)
    for g in grads:
        for (n, p), r in zip(net.named_parameters(), ref):
            p.grad, r.grad = g[n].clone(), g[n].clone()
        torch.nn.utils.clip_grad_norm_(ref, clip)
        opt.step()
        sched.step()
        tx.update(net, state)
    for (n, p), r in zip(net.named_parameters(), ref):
        torch.testing.assert_close(p.detach(), r.detach(), rtol=1e-6, atol=1e-9, msg=n)


def test_the_reference_names_and_shapes_every_leaf_as_the_program():
    """The reference's weights are the program's state by name: every
    parameter and BatchNorm statistic, with its shape."""
    cfg = _cfg()
    _, w = _model(cfg)
    spec = P.param_spec(_ref_cfg(cfg))
    assert len({n for n, _, _ in spec}) == len(spec)
    assert {n: tuple(s) for n, s, _ in spec} == {k: tuple(v.shape) for k, v in w.items()}


def test_span_counts_equal_the_shape_formulas():
    cfg = _cfg()
    model, _ = _model(cfg, dtype=torch.float32)
    model.train()
    x = _batch(cfg, dtype=torch.float32)["images"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        model(x)
    spans = [s for s in profiling.recorded() if s.name.startswith(("vit.", "head."))][-9:]
    names = [s.name for s in spans]
    assert sorted(names) == sorted(["vit.patch_embed", "vit.block", "vit.attention", "vit.mlp",
                                    "vit.block", "vit.attention", "vit.mlp", "vit.norm",
                                    "head.deconv"])
    n, t, c, hidden = 8, 16, 64, 256
    for s in spans:
        if s.name == "vit.attention":
            assert s.counts == {"flops": 2 * n * (3 * t * c * c + t * c * c) + 4 * n * t * t * c}
        elif s.name == "vit.mlp":
            assert s.counts == {"flops": 2 * 2 * n * t * c * hidden}
        else:
            assert s.counts == {}
    by_id = {s.id: s.name for s in spans}
    assert [by_id[s.parent] for s in spans if s.name in ("vit.attention", "vit.mlp")] == [
        "vit.block"] * 4


def test_the_clip_span_lies_inside_the_optimizer():
    cfg = _cfg(**{"TRAIN.CLIP_GRAD_NORM": 1.0})
    model, _ = _model(cfg, dtype=torch.float32)
    tx = make_optimizer(cfg, 10)
    state = init_train_state(model, tx, device="cpu")
    step = make_train_step(model, cfg, tx, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, _batch(cfg, dtype=torch.float32))
    spans = profiling.recorded()
    by_id = {s.id: s.name for s in spans}
    clip = [s for s in spans if s.name == "train.clip"]
    assert clip and by_id[clip[-1].parent] == "train.optimizer"


def test_resnet_and_vit_share_the_head():
    """One head, PoseResNet's names as they were."""
    r = PoseResNet(num_layers=18, num_joints=16)
    names = [n for n, _ in r.named_parameters() if n.startswith(("deconv", "final"))]
    assert names == [f"deconv{i}_{k}" for i in range(3) for k in ("conv.weight", "bn.weight",
                                                                  "bn.bias")] + [
        "final_layer.weight", "final_layer.bias"]
    vit, _ = _model(_cfg(), dtype=torch.float32)
    vnames = [n for n, _ in vit.backbone.named_parameters() if n.startswith(("deconv", "final"))]
    assert vnames == names[:6] + names[-2:]


def test_the_resnet_paths_refuse_a_vit():
    from posetpu_torch.models.discriminators import build_discriminators
    from posetpu_torch.models.quant import quantize_pose_resnet
    from posetpu_torch.serving import build_serving_pipeline
    from posetpu_torch.train.gan import make_adversarial_train_step

    cfg = _cfg()
    model, _ = _model(cfg, dtype=torch.float32)
    calib = [np.zeros((2, 64, 64, 3), np.float32)]
    with pytest.raises(ValueError, match="PoseResNet"):
        build_serving_pipeline(cfg, model, calib, device="cpu")
    with pytest.raises(ValueError, match="PoseResNet"):
        quantize_pose_resnet(model.backbone, calib, device="cpu")
    tx = make_optimizer(cfg, 10)
    with pytest.raises(ValueError, match="PoseResNet"):
        make_adversarial_train_step(model, {}, cfg, tx, {}, device="cpu")
    assert build_discriminators(cfg) == {}
    cfg.LOSS.USE_LOCAL_MI_LOSS = True
    with pytest.raises(ValueError, match="PoseResNet"):
        build_discriminators(cfg)


def test_the_train_cli_trains_a_tiny_vit(tmp_path):
    """cli/train.py on the ViTPose YAML cut to the small size: the model,
    AdamW and the step come from the configuration alone; one step, one
    validation, the final state under the ViT's model name."""
    import logging

    from posetpu_torch.cli import train as tcli
    from posetpu_torch.cli.common import load_cfg
    from posetpu_torch.data.synthetic import write_image_fixture
    from posetpu_torch.train.checkpoint import CheckpointManager

    data = tmp_path / "data"
    write_image_fixture(str(data), n_images=4, mpii_size=(96, 72), h36m_size=(120, 120),
                        mpii_train=4, mpii_valid=2, h36m_train_groups=2, h36m_valid_groups=1,
                        seed=5)
    args = tcli.parse_args(["--cfg", YAML, "--modelDir", str(tmp_path / "output"),
                            "--logDir", str(tmp_path / "log")])
    cfg = load_cfg(args, **TINY)
    cfg.DATASET.ROOT = str(data)
    cfg.TEST.BATCH_SIZE = 2
    cfg.TRAIN.END_EPOCH = 1
    cfg.DEBUG.DEBUG = False
    cfg.WORKERS = 1
    log = logging.getLogger("test_torch_vitpose")
    log.propagate = False
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        tr = tcli.setup(cfg, args, device="cpu", log=log)
        assert isinstance(tr.base.params.backbone, V.ViTPose) and tr.tx.kind == "adamw"
        assert not tr.adversarial
        before = tr.base.params.vit.blocks[0].attn.qkv.weight.detach().clone()
        tr.train_loader.dataset.grouping = tr.train_loader.dataset.grouping[-2:]
        tcli.train_epochs(tr, None)
        tr.writer.close()
    finally:
        torch.set_num_threads(threads)
    assert tr.base.step == 1
    assert not torch.equal(tr.base.params.vit.blocks[0].attn.qkv.weight, before)
    assert tr.output_dir.endswith(os.path.join("multiview_vitpose_2x64", "h_256_fusion"))
    saved = CheckpointManager(tr.output_dir).restore_model("final_state")["base_model"]
    assert "vit.pos_embed" in saved["params"]
