"""The training driver of a ViTPose configuration: the program's supervised
step (``posetpu_torch.train.step.make_train_step``) over the multi-view
model with its ViTPose backbone, in the configuration's precision (bf16
compute, f32 parameters and AdamW state), chained through one
``TrainState`` for every step of set-up and of the window; the window, the
trace and the gap measures are :mod:`portbench.drivers.train`'s.

What differs from that driver: the configuration is checked against the
ViT's sizes and ViTPose's recipe; the weights are
:mod:`portbench.weights_vit`'s; the drop-path draws are seeded from the
run's seed on both sides; the plain reference followed is
:mod:`portbench.reference.vitpose` (AdamW with layer-wise decay, clipping
and warm-up), and the first gradient compared is the clipped one, as
AdamW's first moment holds it after step 1. The numbers compared are
those of :func:`portbench.drivers.train._compare`; the cell's ``limits``
name which.
"""

from __future__ import annotations

import time

from portbench import faults_vit, harness, traffic, weights_vit
from portbench.drivers.train import (
    SETUP_STEPS,
    _leaf_gaps,
    _map_gaps,
    _probe,
    _running_averages,
    _stats_gaps,
)
from portbench.trace import span, traced

# the program's configuration against the cell's, by the keys the yardstick reads
CHECKED = {
    "backbone": lambda c: str(c.BACKBONE_MODEL),
    "image_size": lambda c: [int(v) for v in c.NETWORK.IMAGE_SIZE],
    "heatmap_size": lambda c: [int(v) for v in c.NETWORK.HEATMAP_SIZE],
    "num_joints": lambda c: int(c.NETWORK.NUM_JOINTS),
    "patch_size": lambda c: int(c.POSE_VIT.PATCH_SIZE),
    "patch_padding": lambda c: int(c.POSE_VIT.PATCH_PADDING),
    "embed_dim": lambda c: int(c.POSE_VIT.EMBED_DIM),
    "depth": lambda c: int(c.POSE_VIT.DEPTH),
    "num_heads": lambda c: int(c.POSE_VIT.NUM_HEADS),
    "mlp_ratio": lambda c: float(c.POSE_VIT.MLP_RATIO),
    "drop_path_rate": lambda c: float(c.POSE_VIT.DROP_PATH_RATE),
    "deconv_filters": lambda c: [int(v) for v in c.POSE_VIT.NUM_DECONV_FILTERS],
    "deconv_kernels": lambda c: [int(v) for v in c.POSE_VIT.NUM_DECONV_KERNELS],
    "final_conv_kernel": lambda c: int(c.POSE_VIT.FINAL_CONV_KERNEL),
    "aggre": lambda c: bool(c.NETWORK.AGGRE),
    "consistent_loss": lambda c: bool(c.LOSS.USE_CONSISTENT_LOSS),
    "consistent_loss_weight": lambda c: float(c.LOSS.CONSISTENT_LOSS_WEIGHT),
    "fundamental_loss": lambda c: bool(c.LOSS.USE_FUNDAMENTAL_LOSS),
    "target_weight": lambda c: bool(c.LOSS.USE_TARGET_WEIGHT),
    "fuse_output": lambda c: bool(c.TEST.FUSE_OUTPUT),
    "optimizer": lambda c: str(c.TRAIN.OPTIMIZER),
    "lr": lambda c: float(c.TRAIN.LR),
    "weight_decay": lambda c: float(c.TRAIN.WD),
    "layer_decay": lambda c: float(c.TRAIN.LAYER_DECAY),
    "clip_grad_norm": lambda c: float(c.TRAIN.CLIP_GRAD_NORM),
    "warmup_iters": lambda c: int(c.TRAIN.WARMUP_ITERS),
    "warmup_ratio": lambda c: float(c.TRAIN.WARMUP_RATIO),
    "batch_groups": lambda c: int(c.TRAIN.BATCH_SIZE),
}


def program_config(cfg: dict, root=harness.ROOT):
    """The program's configuration object: the cell configuration's YAML
    with its overrides, checked against :data:`CHECKED`."""
    from posetpu_torch.config import load_config

    pcfg = load_config(str(root / cfg["yaml"]), **cfg["overrides"])
    got = {k: read(pcfg) for k, read in CHECKED.items()}
    wrong = {k: (v, cfg[k]) for k, v in got.items() if v != cfg[k]}
    if wrong:
        raise SystemExit(f"portbench: the program's configuration differs from "
                         f"{cfg['name']}.json: {wrong}")
    return pcfg


def drop_seed(seed: int) -> int:
    """The drop-path generator's seed of a run."""
    return (int(seed) * 1000003 + 7) % 2**63


def run(ctx: harness.Context) -> harness.Record:
    import torch

    from posetpu_torch.models.multiview import get_multiview_pose_net
    from posetpu_torch.train.optim import Optimizer, make_optimizer
    from posetpu_torch.train.step import init_train_state, make_train_step

    cell, cfg, dev = ctx.cell, ctx.cfg, ctx.device
    rec = harness.Record(kind="train", cfg=cfg, cell=cell)
    parts = rec.setup_parts
    t = time.perf_counter()
    pcfg = program_config(cfg)
    batches = traffic.train_pool(cell, cfg, ctx.seed, dev)
    harness.sync(dev)
    parts["traffic_s"] = time.perf_counter() - t

    t = time.perf_counter()
    wts, head_scale = weights_vit.make(cfg, ctx.seed, dev, _probe(batches))
    with torch.device(dev):
        model = get_multiview_pose_net(pcfg, dtype=getattr(torch, cell["dtype"]))
    model.backbone.seed_drop_path(drop_seed(ctx.seed))
    harness.load_weights(model, wts)
    del wts
    tx = make_optimizer(pcfg, steps_per_epoch=cell["steps_per_epoch"])
    state = init_train_state(model, tx, device=dev)
    step = make_train_step(model, pcfg, tx, device=dev)
    if ctx.fault:
        step = faults_vit.train_step(ctx.fault, step, tx, model)
    harness.sync(dev)
    parts["model_optimizer_s"] = time.perf_counter() - t

    # the first steps, which the reference follows; they warm up every shape
    t = time.perf_counter()
    names = [n for n, _ in model.named_parameters()]
    p0 = [p.detach().clone() for _, p in model.named_parameters()]
    losses, maps1 = [], []
    hook = model.register_forward_hook(
        lambda mod, args, out: maps1.extend(t.detach().float() for t in out[:2] if t is not None))
    for i in range(SETUP_STEPS):
        state, m = step(state, batches[i])
        losses.append(m["loss"])
        if i == 0:
            hook.remove()
            stats1 = _running_averages(model)
            mu = state.opt_state["mu"]
            grad1 = torch.stack(torch._foreach_norm([mu[n].float() for n in names]))
            grad1 = grad1 / (1.0 - Optimizer.B1)
    params = [p.detach() for _, p in model.named_parameters()]
    change = torch.stack(torch._foreach_norm(torch._foreach_sub(params, p0)))
    del p0, params
    program = {"losses": [float(x) for x in losses], "names": names, "maps1": maps1,
               "grad1": grad1.cpu(), "change": change.cpu(), "stats1": stats1,
               "stats": _running_averages(model)}
    harness.sync(dev)
    parts["first_steps_s"] = time.perf_counter() - t

    # ------------------------------------------------------------ the window
    harness.reset_peak(dev)
    rec.setup_s = time.perf_counter() - ctx.t_start
    losses = []
    k = SETUP_STEPS
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while time.perf_counter() < deadline:
        state, m = step(state, batches[k % len(batches)])
        losses.append(m["loss"])
        k += 1
    harness.sync(dev)
    rec.window_s = time.perf_counter() - t0
    rec.attempted = rec.iterations = len(losses)
    finite = torch.isfinite(torch.stack(losses)) if losses else torch.ones(0, dtype=torch.bool)
    rec.failed = int((~finite).sum())
    rec.groups = cell["groups"] * (rec.attempted - rec.failed)

    if ctx.trace:
        with traced(cell["trace_steps"], dev) as t:
            for j in range(cell["trace_steps"] + 1):
                with span("step"):
                    state, m = step(state, batches[(k + j) % len(batches)])
                t.tick()
        rec.trace = t.trace
    rec.memory_peak_bytes = harness.peak(dev)
    del state, step, model, tx, m
    harness.free(dev)

    _compare(ctx, rec, batches[:SETUP_STEPS], head_scale, program)
    return rec


def control(ctx: harness.Context) -> harness.Record:
    """The cell's control: the plain reference put in the program's place
    and computed in float8 e4m3 (:func:`portbench.reference.model.fp8_cast`
    wherever the reference's ``cast`` reaches), over the same first steps
    with the same drop-path draws; held against the reference as a run of
    the program is. No window."""
    import torch

    from portbench.reference import model as M
    from portbench.reference import vitpose as V

    cell, cfg, dev = ctx.cell, ctx.cfg, ctx.device
    if cell["control"]["precision"] != "fp8_e4m3":
        raise ValueError(f"unknown control precision {cell['control']['precision']!r}")
    rec = harness.Record(kind="train", cfg=cfg, cell=cell, attempted=SETUP_STEPS)
    batches = traffic.train_pool(cell, cfg, ctx.seed, dev)[:SETUP_STEPS]
    wts, head_scale = weights_vit.make(cfg, ctx.seed, dev, _probe(batches))
    with M.full_f32():
        low = V.follow(wts, batches, cfg, drop_seed(ctx.seed), cast=M.fp8_cast,
                       checkpoint=cell["reference_checkpoint"])
    names = list(low["grad1"])
    program = {"losses": low["losses"], "names": names, "maps1": low["maps1"],
               "stats1": low["stats1"],
               "grad1": torch.stack([low["grad1"][n].norm() for n in names]).cpu(),
               "change": torch.stack([(low["params"][n] - wts[n]).norm() for n in names]).cpu(),
               "stats": low["stats"]}
    del low, wts
    harness.free(dev)
    _compare(ctx, rec, batches, head_scale, program)
    return rec


def _compare(ctx, rec, batches, head_scale, program) -> None:
    """:func:`portbench.drivers.train._compare` over the ViTPose reference."""
    import torch

    from portbench.reference import model as M
    from portbench.reference import vitpose as V

    cell, cfg, dev = ctx.cell, ctx.cfg, ctx.device
    wts, _ = weights_vit.make(cfg, ctx.seed, dev, head_scale=head_scale)
    with M.full_f32():
        ref = V.follow(wts, batches, cfg, drop_seed(ctx.seed),
                       checkpoint=cell["reference_checkpoint"])
    names = program["names"]
    r_grad = torch.stack([ref["grad1"][n].norm() for n in names]).cpu()
    r_change = torch.stack([(ref["params"][n] - wts[n]).norm() for n in names]).cpu()
    keep = r_grad >= 1e-3 * r_grad.median()
    kept = [n for n, k in zip(names, keep.tolist()) if k]
    loss = [abs(p - r) / abs(r) for p, r in zip(program["losses"], ref["losses"])]
    grad = _leaf_gaps(program["grad1"][keep], r_grad[keep], float(r_grad[keep].median()))
    step = _leaf_gaps(program["change"][keep], r_change[keep], float(r_change[keep].median()))
    s_names = sorted(ref["stats"])
    stats = _stats_gaps(program["stats"], ref["stats"], wts, s_names)
    stats1 = _stats_gaps(program["stats1"], ref["stats1"], wts, s_names)
    kernel = torch.tensor([ref["grad1"][n].dim() >= 2 for n in kept])
    maps = _map_gaps(program["maps1"], ref["maps1"])
    got = {"loss_gap": max(loss), "loss1_gap": loss[0], "grad_gap": float(grad.max()),
           "grad_gap_median": float(grad.median()), "step_gap": float(step.max()),
           "step_gap_median": float(step.median()), "stats_gap": float(stats.max()),
           "stats_gap_median": float(stats.median()),
           "grad_gap_kernels": float(grad[kernel].max()),
           "stats1_gap_median": float(stats1.median()), "heatmap_gap": float(maps.max())}
    limits = cell["limits"]
    rec.compared = {k: (v, limits[k]) for k, v in got.items() if k in limits}
    rec.counters = {"leaves": len(names), "leaves_left_out": int((~keep).sum()),
                    "losses": program["losses"], "reference_losses": ref["losses"],
                    "reference_grad_norm1": ref["grad_norm1"],
                    "worst_grad_leaf": kept[int(grad.argmax())],
                    "worst_step_leaf": kept[int(step.argmax())],
                    "worst_stats_leaf": s_names[int(stats.argmax())],
                    **{k: v for k, v in got.items() if k not in limits}}
    rec.correct = rec.failed == 0 and rec.attempted > 0 and all(
        v <= lim for v, lim in rec.compared.values())
